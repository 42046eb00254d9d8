"""Per-subject feature extraction: multitaper PSD and task-wise CMC
(port of ``mba_tpu/workflows/subject_feature_extraction_workflow.py:27-67``).

The stage's entry points: :func:`extract_psd_features` computes the
log10 multitaper PSD of the EEG and both EMG grids (0.25-s windows) and
saves each spectrogram; :func:`extract_cmc_features` computes the
task-wise jackknifed CMC of the 11-channel motor subset (mirrored for
left-handers) against each EMG grid, through kernel B1 on a CUDA device.

Not in this slice: ``run_subject`` and ``build_enriched_serial_frame``,
which need the preprocessing import and the serial-frame fetchers
(ROADMAP A7, A10).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from mba_tpu_torch.channel_layout import mirror_eeg_channel_list
from mba_tpu_torch.pipeline import signal_features as features
from mba_tpu_torch.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET


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
