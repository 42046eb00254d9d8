"""Per-subject feature extraction: multitaper PSD, task-wise CMC,
enriched serial frame (port of
``mba_tpu/workflows/subject_feature_extraction_workflow.py``).

The stage's entry points: :func:`extract_psd_features` computes the
log10 multitaper PSD of the EEG and both EMG grids (0.25-s windows) and
saves each spectrogram; :func:`extract_cmc_features` computes the
task-wise jackknifed CMC of the 11-channel motor subset (mirrored for
left-handers) against each EMG grid, through kernel B1 on a CUDA device;
:func:`build_enriched_serial_frame` (host pandas) adds HR/HRV, the
task-wise scaled force, the %MVC force and GSR to the serial trace and
saves the "Enriched Serial Frame" CSV; :func:`run_subject` runs the three
on one subject's preprocessed arrays, the PSD and CMC on ``device``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from mba_tpu_torch._device import entry_device
from mba_tpu_torch.acquisition.sampling import dynamometer_volt_to_force
from mba_tpu_torch.channel_layout import mirror_eeg_channel_list
from mba_tpu_torch.pipeline import data_analysis, data_integration
from mba_tpu_torch.pipeline import signal_features as features
from mba_tpu_torch.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET
from mba_tpu_torch.pipeline.preprocessing import import_npy_with_config
from mba_tpu_torch.utils import file_management as filemgmt


def extract_psd_features(subject_feature_dir: Path,
                         eeg: np.ndarray, emg_flexor: np.ndarray,
                         emg_extensor: np.ndarray, sampling_freq: float,
                         window_length_sec: float = 0.25,
                         apply_log_scale: bool = True,
                         device=None) -> None:
    """Multitaper PSD for all three arrays (reference :156-228)."""
    for modality, data in (("eeg", eeg), ("emg_1_flexor", emg_flexor),
                           ("emg_2_extensor", emg_extensor)):
        features.multitaper_psd(
            data, sampling_freq, nw=3,
            window_length_sec=window_length_sec, overlap_frac=0.5,
            axis=0, apply_log_scale=apply_log_scale,
            psd_save_dir=subject_feature_dir,
            psd_file_suffix=modality, device=device)


def extract_cmc_features(subject_feature_dir: Path,
                         eeg: np.ndarray, emg_flexor: np.ndarray,
                         emg_extensor: np.ndarray, sampling_freq: float,
                         log_frame,
                         handedness: str = "Right",
                         window_size_sec: float = 2.0,
                         buffer_sec: float = 3.0,
                         task_latency_assumption_sec: float = 3.25,
                         task_end_cutoff_sec: float = 2.0,
                         device=None) -> None:
    """Task-wise jackknifed CMC over the motor subset (reference :239);
    ``log_frame`` is the enriched experiment log (pandas)."""
    subset = (mirror_eeg_channel_list(CMC_EEG_CHANNEL_SUBSET,
                                      input_is_left=True)
              if handedness == "Left" else CMC_EEG_CHANNEL_SUBSET)
    for muscle, emg in (("flexor", emg_flexor),
                        ("extensor", emg_extensor)):
        features.compute_task_wise_aggregated_cmc(
            eeg, emg, int(sampling_freq), muscle_group=muscle,
            log_frame=log_frame, eeg_channel_subset=subset,
            window_size_sec=window_size_sec,
            window_overlap_ratio=0.5, use_jackknife=True,
            save_dir=subject_feature_dir,
            pre_trial_computation_buffer_sec=buffer_sec,
            post_trial_computation_buffer_sec=buffer_sec,
            task_latency_assumption_sec=task_latency_assumption_sec,
            task_end_cutoff_sec=task_end_cutoff_sec, device=device)


def build_enriched_serial_frame(subject_experiment_dir: Path,
                                mvc_kg: float | None = None,
                                verbose: bool = False):
    """HR/HRV + task-wise scaled force + %MVC force + GSR
    (reference :440-468); returns the frame (pandas)."""
    serial_df = data_integration.fetch_serial_measurements(
        subject_experiment_dir)
    log_df = data_integration.fetch_enriched_log_frame(
        subject_experiment_dir, verbose=False)
    log_df.index = data_analysis.make_timezone_aware(log_df.index)

    bpm, hrv = features.compute_heart_rate_and_variability(
        serial_df["ecg"], verbose=verbose)
    serial_df["bpm"] = bpm
    serial_df["hrv"] = hrv
    serial_df["Task-wise Scaled Force"] = \
        features.compute_task_wise_scaled_force(
            serial_df["fsr"], log_df, verbose=verbose)
    force_kg = serial_df["fsr"].apply(dynamometer_volt_to_force)
    mvc = mvc_kg if mvc_kg is not None else float(force_kg.max())
    serial_df["Unscaled Force [% MVC]"] = 100.0 * force_kg / max(mvc,
                                                                 1e-9)

    out_dir = Path(subject_experiment_dir) / "serial_measurements"
    serial_df.to_csv(out_dir / filemgmt.file_title(
        "Enriched Serial Frame", ".csv"))
    return serial_df


def run_subject(subject: int, paths, sampling_freq: float = 2048.0,
                do_compute_psd: bool = True,
                do_compute_cmc: bool = True,
                do_compute_serial: bool = True,
                device=None) -> None:
    """One subject end-to-end (fetch → PSD → CMC → serial frame); the
    PSD and the CMC run on ``device`` (the card unless ``"cpu"``; without
    a card the call raises before it reads anything)."""
    if do_compute_psd or do_compute_cmc:
        device = entry_device(device)
    exp_dir = paths.subject_experiment_dir(subject)
    feat_dir = paths.subject_feature_dir(subject)
    filemgmt.assert_dir(feat_dir)

    eeg, _ = import_npy_with_config("eeg", feat_dir,
                                    sampling_rate_Hz=int(sampling_freq))
    emg1, _ = import_npy_with_config("emg_1_flexor", feat_dir,
                                     sampling_rate_Hz=int(sampling_freq))
    emg2, _ = import_npy_with_config("emg_2_extensor", feat_dir,
                                     sampling_rate_Hz=int(sampling_freq))
    log_df = data_integration.fetch_enriched_log_frame(exp_dir,
                                                       verbose=False)
    handedness = data_integration.fetch_personal_data(
        exp_dir)["Dominant hand"]

    if do_compute_psd:
        extract_psd_features(feat_dir, eeg, emg1, emg2, sampling_freq,
                             device=device)
    if do_compute_cmc:
        extract_cmc_features(feat_dir, eeg, emg1, emg2, sampling_freq,
                             log_frame=log_df, handedness=handedness,
                             device=device)
    if do_compute_serial:
        build_enriched_serial_frame(exp_dir)


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    # module-level flags (reference style)
    subjects = list(range(12))
    do_compute_psd = True
    fetch_precomputed_psd = False
    fetch_precomputed_cmc = False

    paths = StudyPaths().ensure()
    for subject in subjects:
        run_subject(subject, paths,
                    do_compute_psd=do_compute_psd
                    and not fetch_precomputed_psd,
                    do_compute_cmc=not fetch_precomputed_cmc)
