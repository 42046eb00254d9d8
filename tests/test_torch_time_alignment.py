"""The port's time-alignment validation (``mba_tpu_torch.workflows.
time_alignment_validation_workflow``) against ``mba_tpu``'s, on a
two-subject study tree of ``tests/_torch_study.py`` whose subject 0 went
through the port's s3 (``run_subject`` on the CPU).

The resampling of ``validate_muscle_identity`` and the Welch PSD of
``emg_power_ratio`` run on the device the caller names (``"cpu"`` here):
their results agree with the JAX package's at rtol 1e-5.  The rest is
host code on the same artifacts and equal to the value.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from mba_tpu.workflows import time_alignment_validation_workflow as JT
from mba_tpu_torch.pipeline import data_integration as di
from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.workflows import subject_feature_extraction_workflow \
    as TSF
from mba_tpu_torch.workflows import time_alignment_validation_workflow \
    as TT
from mba_tpu_torch.workflows.paths import StudyPaths

from _torch_study import assert_same, write_small_study

torch.set_num_threads(1)

RTOL = 1e-5
TASK_SEC = 60.0


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp("alignment")
    info = write_small_study(root, 2)
    TSF.run_subject(0, StudyPaths(root), sampling_freq=info["fs"],
                    device="cpu")
    loads = {name: module.load_emg_psd_both_muscles(
        0, info["feat_root"], info["exp_root"], emg_frequency_band=(20, 60))
        for name, module in (("port", TT), ("jax", JT))}
    return dict(info, loads=loads)


def _emg(study, name):
    feat = study["feat_root"] / "subject_00"
    return np.load(filemgmt.most_recent_file(feat, ".npy",
                                             ["Preprocessed", name]))


def _close(got, want, what):
    assert set(got) == set(want), what
    for key, value in want.items():
        if isinstance(value, float):
            np.testing.assert_allclose(got[key], value, rtol=RTOL,
                                       atol=RTOL * 1e-3, err_msg=key)
        else:
            assert got[key] == value, (what, key)


def test_load_emg_psd_both_muscles_matches_jax(study):
    got, want = study["loads"]["port"], study["loads"]["jax"]
    assert_same(got, want)
    power, times = got["flexor"]
    assert isinstance(times, pd.DatetimeIndex) and len(times) == len(power)
    assert np.isfinite(power).all() and got["extensor"] is not None
    assert got["force_series"].name == "fsr"


def test_load_without_psd_artifacts_matches_jax(study, tmp_path):
    """A subject whose feature directory holds no PSD artifacts: the
    force trace and no muscle, in both packages."""
    feat = tmp_path / "features"
    (feat / "subject_00").mkdir(parents=True)
    got = TT.load_emg_psd_both_muscles(0, feat, study["exp_root"])
    want = JT.load_emg_psd_both_muscles(0, feat, study["exp_root"])
    assert got["flexor"] is got["extensor"] is want["flexor"] is None
    pd.testing.assert_series_equal(got["force_series"],
                                   want["force_series"])


@pytest.mark.parametrize("band", [(20.0, 60.0), (2.0, 30.0)])
def test_emg_power_ratio_matches_jax(study, band):
    flexor, extensor = _emg(study, "emg_1_flexor"), _emg(study,
                                                         "emg_2_extensor")
    got = TT.emg_power_ratio(flexor, extensor, study["fs"], band,
                             device="cpu")
    want = JT.emg_power_ratio(flexor, extensor, study["fs"], band)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)
    assert got > 1.0     # the flexor grid carries the stronger drive


@pytest.mark.parametrize("max_lag_sec", [1.0, 4.0])
def test_validate_muscle_identity_matches_jax(study, max_lag_sec):
    load = study["loads"]["port"]
    power, times = load["flexor"]
    force = load["force_series"]
    fs_emg = 1.0 / np.median(np.diff(times.asi8) / 1e9)
    fs_force = 1.0 / np.median(np.diff(force.index.asi8) / 1e9)
    n = int(len(power) * fs_force / fs_emg)
    args = (power, force.to_numpy(float)[:n], fs_emg, fs_force, max_lag_sec)
    got = TT.validate_muscle_identity(*args, device="cpu")
    _close(got, JT.validate_muscle_identity(*args), "identity")
    assert -1.0 <= got["best_corr"] <= 1.0


def _tasks(load):
    """One-minute spans over the recording and one span too short to
    judge, as (name, start, end)."""
    times = load["flexor"][1]
    edges = pd.date_range(times[0], times[-1],
                          freq=pd.Timedelta(seconds=TASK_SEC))
    spans = [(f"task_{i}", a, b) for i, (a, b)
             in enumerate(zip(edges[:-1], edges[1:]))]
    return spans + [("blip", times[5], times[7])]


def test_analyze_task_alignment_matches_jax(study, tmp_path):
    load = study["loads"]["port"]
    power, times = load["flexor"]
    results = {}
    for name, module in (("port", TT), ("jax", JT)):
        results[name] = [module.analyze_task_alignment(
            power, times, load["force_series"], start, end, task)
            for task, start, end in _tasks(load)]
    assert len(results["port"]) >= 3
    for got, want in zip(results["port"], results["jax"]):
        _close(got, want, got["task_name"])
    assert results["port"][-1]["error"] == "Insufficient data"
    assert all(r["error"] is None for r in results["port"][:-1])
    for name, module in (("port", TT), ("jax", JT)):
        module.create_multi_task_comparison_plot(results[name],
                                                 save_dir=tmp_path / name)
        module.create_power_comparison_plot(
            power, load["extensor"][0], times, load["force_series"],
            save_dir=tmp_path / name)
    names = [sorted(p.name[20:] for p in (tmp_path / k).glob("*.png"))
             for k in ("port", "jax")]
    assert names[0] == names[1] == ["Power Comparison.png",
                                    "Task Alignment Comparison.png"]


def test_sampling_rate_sweep_matches_jax(study):
    args = ([0, 1, 5], study["exp_root"], study["feat_root"], 128.0)
    got = TT.cohort_sampling_rate_sweep(*args)
    pd.testing.assert_frame_equal(got, JT.cohort_sampling_rate_sweep(*args))
    assert got["Subject ID"].tolist() == [0, 1]
    assert got.set_index("Subject ID")["n_samples"][1] == \
        study["plan"].n_samples
    log = di.fetch_enriched_log_frame(study["exp_root"] / "subject_00",
                                      verbose=False)
    assert TT.calculate_actual_sampling_rate(1000, log, 128.0) == \
        JT.calculate_actual_sampling_rate(1000, log, 128.0)


def test_sampling_rate_sweep_counts_the_newest_eeg_file(study, tmp_path):
    """ROADMAP C13, in both packages: the sweep counts the samples of the
    newest ".npy" whose title holds "eeg", so once s3 has saved its PSD
    artifacts it counts one of those (here the frequencies), not the
    recording."""
    feat = tmp_path / "subject_00"
    feat.mkdir()
    np.save(feat / "2026-01-05 09_00_00 Preprocessed eeg 64ch.npy",
            np.zeros((study["plan"].n_samples, 2), np.float32))
    np.save(feat / "2026-01-05 09_00_05 PSD Frequencies eeg.npy",
            np.arange(17.0))
    args = ([0], study["exp_root"], tmp_path, 128.0)
    got = TT.cohort_sampling_rate_sweep(*args)
    pd.testing.assert_frame_equal(got, JT.cohort_sampling_rate_sweep(*args))
    assert got["n_samples"].tolist() == [17]
    assert got["drift_ppm"].iloc[0] < -0.99e6
