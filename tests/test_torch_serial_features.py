"""The port's serial-sensor and statistical features (host copies in
``pipeline.signal_features``) and ``build_enriched_serial_frame`` against
``mba_tpu`` on the CPU: HR/HRV, the task-wise scaled force and the
mutual-information importances are equal (``tests/_torch_study.
assert_same``), and the enriched serial frame is the same CSV, byte for
byte.  The ECG and force traces are those of the port's ``tools/
synth_study`` (50 Hz), cut short; the log is its enriched log.
"""
import numpy as np
import pandas as pd
import pytest

from mba_tpu.pipeline import data_integration as JDI
from mba_tpu.pipeline import signal_features as JF
from mba_tpu.workflows import subject_feature_extraction_workflow as JSF
from mba_tpu_torch.acquisition import sampling as TS
from mba_tpu_torch.pipeline import data_integration as TDI
from mba_tpu_torch.pipeline import signal_features as TF
from mba_tpu_torch.tools import synth_study as S
from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.workflows import subject_feature_extraction_workflow as TSF

from _torch_study import assert_same, small_plan, write_small_study


@pytest.fixture(scope="module")
def traces():
    plan = small_plan()
    serial = S.synth_raw_serial(plan, subject=3)
    serial.index = TDI.make_timezone_aware(serial.index)
    log = S.build_enriched_log(plan, subject=3)
    log["Time"] = pd.to_datetime(log["Time"])
    log = log.set_index("Time")
    log.index = TDI.make_timezone_aware(log.index)
    return serial, log


HR = {
    "defaults": {},
    "narrow_window": dict(rolling_window="5s", output_smoothing_window_sec=1.0),
    "strict_quantile": dict(heart_beat_threshold_quantile=0.95,
                            refractory_period="500ms"),
    "physiological_clip": dict(min_bpm=70.0, max_bpm=90.0,
                               max_hrv_seconds=0.05),
}


@pytest.mark.parametrize("case", sorted(HR))
def test_heart_rate_and_variability_match_jax(traces, case, capsys):
    ecg = traces[0]["ecg"]
    got = TF.compute_heart_rate_and_variability(ecg, **HR[case])
    out_port = capsys.readouterr().out
    want = JF.compute_heart_rate_and_variability(ecg, **HR[case])
    assert capsys.readouterr().out == out_port
    assert_same(got, want, case)
    if case == "defaults":
        assert 55 < float(np.nanmedian(got[0])) < 80


def test_heart_rate_gives_up_as_jax(traces):
    flat = pd.Series(np.zeros(50), index=traces[0].index[:50])
    assert TF.compute_heart_rate_and_variability(flat, verbose=False) \
        == JF.compute_heart_rate_and_variability(flat, verbose=False) \
        == (None, None)


FORCE = {
    "from_log": lambda F, s, log: F.compute_task_wise_scaled_force(
        s["fsr"], log, verbose=True),
    "percentiles": lambda F, s, log: F.compute_task_wise_scaled_force(
        s["fsr"], log, min_percentile=0.1, max_percentile=0.9,
        verbose=False),
    "given_spans": lambda F, s, log: F.compute_task_wise_scaled_force(
        s["fsr"], log, trial_start_ends=[
            (s.index[100], s.index[600]), (s.index[900], s.index[905]),
            (s.index[2000], s.index[2600])], min_samples=20),
    "constant_trial": lambda F, s, log: F.compute_task_wise_scaled_force(
        pd.Series(1.0, index=s.index), log, verbose=False),
}


@pytest.mark.parametrize("case", sorted(FORCE))
def test_task_wise_scaled_force_matches_jax(traces, case):
    serial, log = traces
    got = FORCE[case](TF, serial, log)
    want = FORCE[case](JF, serial, log)
    assert_same(got, want, case)
    assert got.notna().any()


def _mi_inputs():
    rng = np.random.default_rng(4)
    n = 120
    x = rng.standard_normal((n, 3))
    cat = rng.choice(["Happy", "Sad", "Silence"], n)
    target = x[:, 0] * 2 + (cat == "Happy") + 0.1 * rng.standard_normal(n)
    frame = pd.DataFrame({"force": x[:, 0], "hr": x[:, 1],
                          "gsr": np.round(x[:, 2], 0), "category": cat})
    return frame, target, cat


MI = {
    "continuous_target": lambda F, f, t, c: F.compute_feature_mi_importance(
        f, t, list(f.columns), target_label="CMC"),
    "categorical_target": lambda F, f, t, c: F.compute_feature_mi_importance(
        f[["force", "hr"]].to_numpy(), c, ["force", "hr"],
        sort_by_importance=False),
    "discrete_declared": lambda F, f, t, c: F.compute_feature_mi_importance(
        f[["gsr", "category"]], np.round(t), ["gsr", "category"],
        target_type="discrete", feature_type="discrete", random_state=3),
}


@pytest.mark.parametrize("case", sorted(MI))
def test_mi_importance_matches_jax(case):
    frame, target, cat = _mi_inputs()
    got = MI[case](TF, frame, target, cat)
    want = MI[case](JF, frame, target, cat)
    assert_same(got, want, case)
    if case == "continuous_target":
        assert next(iter(got)) == "force"


def test_mi_barplot_is_drawn_as_jax(tmp_path):
    frame, target, _ = _mi_inputs()
    fig, ax, got = TF.compute_feature_mi_importance(
        frame, target, list(frame.columns), include_barplot=True,
        plot_save_dir=tmp_path)
    want = JF.compute_feature_mi_importance(frame, target,
                                            list(frame.columns))
    assert_same(got, want)
    assert [t.get_text() for t in ax.get_xticklabels()] == list(want)
    assert len(list(tmp_path.glob("*Mutual_Information_Barplot.png"))) == 1


@pytest.mark.parametrize("volts", [0.0, 0.7, 1.25, 2.0])
def test_dynamometer_calibration_matches_jax(volts):
    from mba_tpu.acquisition import sampling as JS
    for kw in ({}, {"offset": 0.3}, {"mvc_kg": 15.0}):
        assert TS.dynamometer_volt_to_force(volts, **kw) \
            == JS.dynamometer_volt_to_force(volts, **kw)


@pytest.mark.parametrize("mvc_kg", [None, 15.0])
def test_enriched_serial_frame_matches_jax(tmp_path, mvc_kg):
    """One subject's raw serial trace and log → the same frame and the
    same "Enriched Serial Frame" CSV from both packages."""
    import shutil
    study = write_small_study(tmp_path / "port", 1)
    sub = "subject_00"
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    frames, texts = [], []
    for name, mod in (("port", TSF), ("jax", JSF)):
        exp = tmp_path / name / "data" / "experiment_results" / sub
        frames.append(mod.build_enriched_serial_frame(exp, mvc_kg=mvc_kg))
        texts.append(filemgmt.most_recent_file(
            exp / "serial_measurements", ".csv",
            ["Enriched Serial Frame"]).read_text())
    assert_same(frames[0], frames[1])
    assert texts[0] == texts[1]
    reread = [mod.fetch_enriched_serial_frame(
        study["exp_root"] / sub) for mod in (TDI, JDI)]
    assert_same(reread[0], reread[1])
    assert {"bpm", "hrv", "Task-wise Scaled Force",
            "Unscaled Force [% MVC]", "gsr"} <= set(reread[0].columns)
