"""The port's entry points run on the card unless asked for the CPU.

``resolve_device`` names the card (``cuda``) for numpy input and keeps a
tensor's device; an entry point given numpy input and no ``device``
raises where there is no card, naming ``device="cpu"``, and never carries
on on the CPU.  ``torch.cuda.is_available`` is patched to False, so the
refusals are checked on a machine with a card too.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse
import torch

from mba_tpu_torch._device import entry_device, resolve_device
from mba_tpu_torch.models import lme as TL
from mba_tpu_torch.models import mediation as TM
from mba_tpu_torch.ops import permutation as TPerm
from mba_tpu_torch.pipeline import statistical_modelling as TStat
from mba_tpu_torch.workflows import \
    statistics_RQ_A_mediation_analysis_workflow as TMW
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.ops import coherence as TC
from mba_tpu_torch.ops import filters as TFi
from mba_tpu_torch.ops import ica as TI
from mba_tpu_torch.ops import spectral as TS
from mba_tpu_torch.ops import surrogate as TSu
from mba_tpu_torch.ops.dpss import filtered_tapers
from mba_tpu_torch.ops import wavelet as TW
from mba_tpu_torch.pipeline import cbpa as TCB
from mba_tpu_torch.pipeline import music_control as TMC
from mba_tpu_torch.pipeline import preprocessing as TP
from mba_tpu_torch.pipeline import signal_features as TF
from mba_tpu_torch.workflows import \
    statistics_RQ_A_post_hoc_testing_workflow as TPH
from mba_tpu_torch.workflows import subject_feature_extraction_workflow \
    as TSF
from mba_tpu_torch.workflows import time_alignment_validation_workflow \
    as TTA
from mba_tpu_torch.workflows.paths import StudyPaths

from _torch_parity import cohort_subject, coupled_signals

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_importing_the_package_turns_tf32_off():
    """Fault C1: float32 matmuls and convolutions stay float32 on the
    card (cuDNN's default allows TF32), pinned in a fresh interpreter."""
    code = ("import torch, mba_tpu_torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "assert torch.get_float32_matmul_precision() == 'highest'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_numpy_input_resolves_to_the_card():
    assert resolve_device(None, np.zeros(3)) == torch.device("cuda")
    assert resolve_device(None, np.zeros(3), [1.0]) == torch.device("cuda")
    assert resolve_device("cpu", np.zeros(3)) == torch.device("cpu")


def test_a_tensor_keeps_its_device():
    assert resolve_device(None, np.zeros(3), torch.zeros(3)) == \
        torch.device("cpu")
    meta = torch.zeros(3, device="meta")
    assert resolve_device(None, meta, torch.zeros(3)) == torch.device("meta")
    assert entry_device(None, torch.zeros(3)) == torch.device("cpu")


def _cohort():
    subj = [cohort_subject(30 + j, n_sec=8.0, couple=2.0) for j in range(2)]
    return (np.stack([s[0] for s in subj]), np.stack([s[1] for s in subj]))


def _calls():
    """Each entry point on small numpy input: name → call(**device)."""
    eeg, emg = coupled_signals(seconds=4)
    ce, cm = _cohort()
    tapers = filtered_tapers(256, 3, 0.9)
    null_kw = dict(window_length_sec=2.0, band=(8.0, 60.0),
                   n_surrogates=40, surrogate_chunk=20)
    rng = np.random.default_rng(0)
    groups = np.repeat(np.arange(4), 5)
    X = np.column_stack([np.ones(20), rng.standard_normal(20)])
    Y = rng.standard_normal((8, 20))
    contrast = rng.standard_normal((6, 5, 3))
    chain = scipy.sparse.csr_matrix(np.eye(3, k=1, dtype=bool)
                                    + np.eye(3, k=-1, dtype=bool))
    return {
        "multitaper_msc": lambda **d: TC.multitaper_msc(
            eeg, emg, 256, window_length_sec=1.0, **d),
        "cohort_msc_rotation_null": lambda **d: TN.cohort_msc_rotation_null(
            ce, cm, 256.0, **null_kw, **d),
        "msc_phase_randomized_null": lambda **d:
            TSu.msc_phase_randomized_null(
                eeg[:, :1], emg[:, :1], 256, window_length_sec=1.0,
                n_surrogates=16, surrogate_chunk=8, band=(8.0, 40.0), **d),
        "cohort_msc_fft_null": lambda **d: TN.cohort_msc_fft_null(
            ce, cm, 256.0, **null_kw, **d),
        "cohort_msc_null": lambda **d: TN.cohort_msc_null(
            ce, cm, 256.0, **null_kw, **d),
        "multitaper_psd": lambda **d: TS.multitaper_psd(
            eeg, 256.0, window_length_sec=0.5, axis=0, **d),
        "welch_psd": lambda **d: TS.welch_psd(eeg, 256.0, 128, **d),
        "amplitude_spectrum": lambda **d: TS.amplitude_spectrum(
            eeg, 256.0, **d),
        "resample_data": lambda **d: TF.resample_data(
            eeg[:, 0], 256.0, 128.0, **d),
        "jackknife_coherence_and_ci": lambda **d:
            TF.jackknife_coherence_and_ci(tapers, eeg[:256], emg[:256],
                                          256.0, 256, **d),
        "compute_task_wise_aggregated_cmc": lambda **d:
            TF.compute_task_wise_aggregated_cmc(
                eeg, emg, 256, "flexor", window_size_sec=1.0, **d),
        "bandpass_filter": lambda **d: TFi.bandpass_filter(
            eeg, 256.0, 8.0, 30.0, **d),
        "notch_filter": lambda **d: TFi.notch_filter(eeg, 256.0, [50.0],
                                                     **d),
        "wavelet_denoise": lambda **d: TW.wavelet_denoise(eeg, 'db4', **d),
        "InfomaxICA.fit": lambda **d: TI.InfomaxICA(
            2, max_iter=5, **d).fit(eeg),
        "BiosignalPreprocessor": lambda **d: TP.BiosignalPreprocessor(
            eeg, 256, 'eeg', n_ica_components=None, **d).np_output_data,
        "batched_lme_pvalues": lambda **d: TL.batched_lme_pvalues(
            X, Y, groups, **d),
        "run_power_analysis": lambda **d: TStat.run_power_analysis(
            [], None, ".", ".", None, **d),
        "bootstrap_indirect_effect": lambda **d:
            TM.bootstrap_indirect_effect({"status": "not_fitted"}, **d),
        "run_mediation_analysis": lambda **d: TMW.run_mediation_analysis(
            ".", None, ".", **d),
        "cluster_permutation_1samp_test": lambda **d:
            TPerm.cluster_permutation_1samp_test(
                contrast, TPerm.combine_adjacency(5, chain),
                n_permutations=40, **d),
        # the study pipeline: each raises before it reads or writes
        "run_subject": lambda **d: TSF.run_subject(
            0, StudyPaths("missing_study"), **d),
        "run_cbpa": lambda **d: TCB.run_cbpa(TCB.CBPAConfig(
            data_root="missing_study", output_dir="missing_study", **d)),
        "run_batch": lambda **d: TCB.run_batch([TCB.CBPAConfig(
            data_root="missing_study", output_dir="missing_study", **d)]),
        "run_post_hoc": lambda **d: TPH.run_post_hoc(
            "missing_study", "missing_study", "missing_study",
            "missing_study", **d),
        # the music features and the time-alignment validation
        "compute_stft": lambda **d: TMC.compute_stft(
            eeg[:, 0], n_fft=256, hop_length=64, **d),
        "compute_all_musical_features": lambda **d:
            TMC.compute_all_musical_features("missing_song.wav", **d),
        "validate_muscle_identity": lambda **d:
            TTA.validate_muscle_identity(np.abs(emg[:, 0]), eeg[:, 0],
                                         256.0, 256.0, **d),
        "emg_power_ratio": lambda **d: TTA.emg_power_ratio(
            emg[:, :2], emg[:, 2:], 256.0, (20.0, 100.0), **d),
    }


ENTRY_POINTS = ["multitaper_msc", "cohort_msc_rotation_null",
                "msc_phase_randomized_null", "cohort_msc_fft_null",
                "cohort_msc_null", "multitaper_psd", "welch_psd",
                "amplitude_spectrum", "resample_data",
                "jackknife_coherence_and_ci",
                "compute_task_wise_aggregated_cmc", "bandpass_filter",
                "notch_filter", "wavelet_denoise", "InfomaxICA.fit",
                "BiosignalPreprocessor", "batched_lme_pvalues",
                "run_power_analysis", "bootstrap_indirect_effect",
                "run_mediation_analysis", "cluster_permutation_1samp_test",
                "run_subject", "run_cbpa", "run_batch", "run_post_hoc",
                "compute_stft", "compute_all_musical_features",
                "validate_muscle_identity", "emg_power_ratio"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_numpy_input_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _calls()[name]()


@pytest.mark.parametrize("name", ["multitaper_msc", "cohort_msc_rotation_null",
                                  "msc_phase_randomized_null"])
def test_the_cpu_runs_when_asked_for(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = _calls()[name](device="cpu")
    values = (res["coherence_raw"] if name == "multitaper_msc"
              else res["max_stat"])
    assert values.size and np.isfinite(values).all()


def test_the_statistics_entry_points_run_on_the_cpu_when_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = _calls()
    assert np.isfinite(calls["batched_lme_pvalues"](device="cpu")[
        "pvalues"]).all()
    assert calls["bootstrap_indirect_effect"](device="cpu")[
        "bootstrap_status"] == "not_fitted"
    H0 = calls["cluster_permutation_1samp_test"](device="cpu")[3]
    assert len(H0) == 41 and np.isfinite(H0).all()


def test_the_pipeline_entry_points_run_on_the_cpu_when_asked_for(
        tmp_path, monkeypatch):
    """``run_subject(device="cpu")`` on a one-subject study writes the
    PSD and CMC artifacts; ``run_cbpa`` with ``CBPAConfig(device="cpu")``
    runs its null on the CPU; without ``device`` the four refuse before
    they create anything in the study directory they name."""
    from _torch_study import write_small_study
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    write_small_study(tmp_path, 1)
    TSF.run_subject(0, StudyPaths(tmp_path), sampling_freq=128.0,
                    do_compute_serial=False, device="cpu")
    feat = tmp_path / "data" / "precomputed_features" / "subject_00"
    assert TF.fetch_stored_spectrograms(feat, "CMC", "Flexor")[0].size
    assert TF.fetch_stored_spectrograms(feat, "PSD", "eeg")[0].size
    rng = np.random.default_rng(1)
    X = rng.standard_normal((6, 5, 3)).astype(np.float32)
    X[:, 1:3] += 2.0
    res = TCB.run_cbpa(TCB.CBPAConfig(
        n_permutations=40, output_dir=tmp_path / "cbpa", save_plots=False,
        device="cpu"), X=X, ch_names=["C3", "C1", "Cz"],
        time_grid=np.arange(5.0))
    assert len(res["H0"]) == 41 and np.isfinite(res["H0"]).all()
    for name in ("run_subject", "run_cbpa", "run_batch", "run_post_hoc"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            _calls()[name]()
    assert not (tmp_path / "missing_study").exists()


def test_the_music_and_alignment_entry_points_run_on_the_cpu_when_asked_for(
        tmp_path, monkeypatch):
    """The STFT, the musical features of a WAV file and the two
    time-alignment checks that reach the device, with ``device="cpu"``;
    ``compute_all_musical_features`` refuses before it opens the file.
    ``run_post_hoc`` at its defaults runs on the CPU in
    tests/test_torch_study_pipeline.py."""
    import wave
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = _calls()
    S = calls["compute_stft"](device="cpu")
    assert S.shape[0] == 129 and np.isfinite(S).all()
    assert calls["emg_power_ratio"](device="cpu") > 0
    ident = calls["validate_muscle_identity"](device="cpu")
    assert np.isfinite(ident["best_corr"])
    rng = np.random.default_rng(0)
    path = tmp_path / "song.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes((rng.standard_normal(8000 * 4) * 3000)
                      .astype(np.int16).tobytes())
    bpm, flux, centroid, *_ = TMC.compute_all_musical_features(
        path, duration=4.0, device="cpu")
    assert flux.size and np.isfinite(centroid).all()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TMC.compute_all_musical_features(path)
