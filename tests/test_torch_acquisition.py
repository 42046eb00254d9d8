"""Parity of the port's acquisition hardware layer (``mba_tpu_torch``'s
``acquisition``, ``native``, ``pipeline.sensor_calibration``, the
experiment and serial-testing workflows and the three ``utils`` modules)
with ``mba_tpu``.

Host code only: each case runs the JAX package's function and the
port's on the same inputs and compares what they return or write.  The
real-time runs stay as short as ``tests/test_acquisition.py`` keeps
them; where a value depends on the wall clock (sample counts, trial
RMSEs against a moving target), the inputs are chosen so that it does
not (a constant target, a common row prefix).
"""
import threading

import matplotlib
import numpy as np
import pandas as pd
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from mba_tpu.acquisition import experiment as JE  # noqa: E402
from mba_tpu.acquisition import sampling as JSa  # noqa: E402
from mba_tpu.acquisition import views as JV  # noqa: E402
from mba_tpu.pipeline import data_integration as JDI  # noqa: E402
from mba_tpu.pipeline import sensor_calibration as JCal  # noqa: E402
from mba_tpu.utils import function_decorators as JFd  # noqa: E402
from mba_tpu.utils import multiprocessing_tools as JMp  # noqa: E402
from mba_tpu.utils import str_conversion as JStr  # noqa: E402
from mba_tpu.workflows import experiment_workflow as JEW  # noqa: E402
from mba_tpu.workflows import serial_testing_workflow as JST  # noqa: E402

from mba_tpu_torch.acquisition import experiment as TE  # noqa: E402
from mba_tpu_torch.acquisition import sampling as TSa  # noqa: E402
from mba_tpu_torch.acquisition import views as TV  # noqa: E402
from mba_tpu_torch.native import NativeLineParser  # noqa: E402
from mba_tpu_torch.pipeline import data_integration as TDI  # noqa: E402
from mba_tpu_torch.pipeline import sensor_calibration as TCal  # noqa: E402
from mba_tpu_torch.utils import file_management as filemgmt  # noqa: E402
from mba_tpu_torch.utils import function_decorators as TFd  # noqa: E402
from mba_tpu_torch.utils import multiprocessing_tools as TMp  # noqa: E402
from mba_tpu_torch.utils import str_conversion as TStr  # noqa: E402
from mba_tpu_torch.workflows import experiment_workflow as TEW  # noqa: E402
from mba_tpu_torch.workflows import serial_testing_workflow as TST  # noqa: E402

PKGS = {"jax": (JSa, JE, JV, JDI), "port": (TSa, TE, TV, TDI)}


class _Event:
    def __init__(self):
        self._set = False

    def set(self):
        self._set = True

    def clear(self):
        self._set = False

    def is_set(self):
        return self._set


# ---- utils ------------------------------------------------------------------

@pytest.mark.parametrize("value,ger", [("1.234,56 kg", True), ("7,5", True),
                                       ("12.5 N", False), ("kg", True)])
def test_str_to_float_matches_jax(value, ger):
    assert TStr.str_to_float(value, ger) == JStr.str_to_float(value, ger)


@pytest.mark.parametrize("width", [10, 25, 60])
def test_line_breaks_match_jax(width):
    text = ("Bitte halten Sie die Kraft im Zielkorridor und folgen Sie "
            "der Sinuskurve so genau wie moeglich")
    assert TStr.enter_line_breaks(text, width) == \
        JStr.enter_line_breaks(text, width)


def test_retry_and_heartbeat_decorators_match_jax(capsys):
    def flaky_factory():
        state = {"n": 0}

        def flaky():
            state["n"] += 1
            if state["n"] < 3:
                raise OSError("port busy")
            return state["n"]
        return flaky

    results = []
    for mod in (JFd, TFd):
        wrapped = mod.retry_decorator(n_retries=3, delay_sec=0.0,
                                      exceptions=(OSError,))(flaky_factory())
        results.append((wrapped(), capsys.readouterr().out))
        hb = mod.timed_callback_decorator(initial_interval_sec=0.0,
                                          label="cb")(lambda x: 2 * x)
        results.append((hb(3), capsys.readouterr().out))
    assert results[:2] == results[2:]
    with pytest.raises(OSError):
        TFd.retry_decorator(n_retries=1, delay_sec=0.0, verbose=False)(
            lambda: (_ for _ in ()).throw(OSError("gone")))()


def test_ipc_primitives_match_jax():
    import multiprocessing as mp
    manager = mp.Manager()
    try:
        seen = []
        for mod in (JMp, TMp):
            ev = mod.RobustEventManager(manager)
            steps = [ev.is_set()]
            ev.set()
            ev.set()
            steps += [ev.is_set(), ev.consume(), ev.consume(), ev.consume(),
                      ev.wait(timeout=0.01)]
            s = mod.SharedString("hello")
            s.value = "ünïcode ✓"
            steps.append(s.get())
            s.set("é" * 700)             # truncated at a UTF-8 boundary
            steps.append(s.get())
            seen.append(steps)
        assert seen[0] == seen[1]
    finally:
        manager.shutdown()


def test_save_terminate_process_escalates_like_jax():
    import multiprocessing as mp
    for mod in (JMp, TMp):
        p = mp.Process(target=threading.Event().wait, args=(60,),
                       daemon=True)
        p.start()
        mod.save_terminate_process(p, timeout_sec=0.5)
        assert not p.is_alive()


# ---- the serial parser ------------------------------------------------------

FEEDS = {
    "protocol": [b"FSR:1.5\nECG:0.3\nGSR:2.0\n",
                 b"FSR:garbage\nECG:0.4\nGSR:2.1\nFSR:1.6\n"],
    "split": [b"FSR:2.", b"5\nECG:1.0\nGS", b"R:3.0\n"],
    "smoothing": [b"FSR:0.0\nECG:0\nGSR:0\nFSR:2.0\nECG:0\nGSR:0\n",
                  b"FSR:4.0\nECG:1\nGSR:1\n"],
}


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", sorted(FEEDS))
def test_line_parser_matches_jax(case, use_native):
    """Both parsers on the same byte stream, natively or in Python."""
    got = []
    for mod in (JSa, TSa):
        p = mod.read_serial_measurements(ema_alpha=0.5,
                                         use_native=use_native)
        assert (p._native is not None) == use_native
        counts = [p.feed(chunk, t_mono=float(i))
                  for i, chunk in enumerate(FEEDS[case])]
        got.append((counts, p.latest(), p.n_samples))
    assert got[0] == got[1]


def test_native_parser_builds_under_the_port_and_polls():
    from mba_tpu_torch._build import BUILD_DIR
    from mba_tpu_torch.native import build
    p = NativeLineParser(capacity=4)
    assert build.library_path().parent == BUILD_DIR
    assert build.library_path().exists()
    n = p.feed(b"FSR:1\nECG:2\nGSR:3\n" * 6, t_mono=1.5)
    out = p.poll()
    assert n == 6 and len(out) + p.dropped == 6 and p.pending == 0
    assert out[0]["t_mono"] == 1.5 and out[0]["fsr"] == 1.0
    p.close()
    p.close()


# ---- force mappings and calibration ----------------------------------------

class _Shared:
    value = 0.2


@pytest.mark.parametrize("volts,offset,mvc", [(1.0, 0.0, None),
                                              (1.7, 0.3, 30.0),
                                              (2.2, 0.0, 0.0)])
def test_force_mappings_match_jax(volts, offset, mvc):
    assert TSa.dynamometer_volt_to_force(volts, offset, mvc) == \
        JSa.dynamometer_volt_to_force(volts, offset, mvc)
    for shared in (None, offset, _Shared()):
        assert TSa.mvc_live_force_mapping(volts, shared) == \
            JSa.mvc_live_force_mapping(volts, shared)
        assert TSa.live_force_mapping_factory(volts, mvc, shared) == \
            JSa.live_force_mapping_factory(volts, mvc, shared)


def test_probe_serial_device_matches_jax(tmp_path):
    for name in ("ttyACM1", "ttyACM0"):
        (tmp_path / name).touch()
    pattern = str(tmp_path / "ttyACM*")
    assert TSa.probe_serial_device(pattern) == \
        JSa.probe_serial_device(pattern) == str(tmp_path / "ttyACM0")
    assert TSa.probe_serial_device(str(tmp_path / "none*")) is None


def test_power_law_fit_and_rmse_match_jax():
    volts = np.array([1.0, 1.3, 1.6, 1.9, 2.1])
    forces = JCal.power_law(volts, 2.8708, 4.1071) \
        + np.array([0.02, -0.01, 0.03, 0.0, -0.02])
    a, b = TCal.fit_power_law(volts, forces)
    ja, jb = JCal.fit_power_law(volts, forces)
    assert (a, b) == pytest.approx((ja, jb), rel=1e-9)
    assert TCal.calibration_rmse(volts, forces, a, b) == pytest.approx(
        JCal.calibration_rmse(volts, forces, ja, jb), rel=1e-9)
    np.testing.assert_array_equal(TCal.power_law(volts, a, b),
                                  JCal.power_law(volts, a, b))


def test_calibration_session_matches_jax(capsys):
    """Each prompt advances to the next held weight's voltage."""
    weights = [2.5, 5.0, 10.0, 20.0]
    volts = [(w / 2.8708) ** (1.0 / 4.1071) for w in weights]
    out = []
    for mod in (JCal, TCal):
        state = {"i": -1}

        class SharedDict(dict):
            def get(self, key):
                return volts[state["i"]] if key == "fsr" else None

        out.append(mod.run_calibration_session(
            SharedDict(), weights_kg=weights, hold_sec=0.03, poll_hz=200.0,
            prompt=lambda _msg, s=state: s.__setitem__("i", s["i"] + 1)))
    # each mean is over as many polls as the hold allowed: equal values,
    # summed a different number of times, may differ in the last ulp
    assert out[1]["volts"] == pytest.approx(out[0]["volts"], rel=1e-12)
    assert (out[1]["a"], out[1]["b"], out[1]["rmse_kg"]) == pytest.approx(
        (out[0]["a"], out[0]["b"], out[0]["rmse_kg"]), rel=1e-9)
    assert capsys.readouterr().out.count("Fitted F") == 2


def test_calibrate_mvc_matches_jax():
    shared = {"fsr": 1.5}
    assert TE.calibrate_mvc(shared, duration_sec=0.05) == \
        JE.calibrate_mvc(shared, duration_sec=0.05) == \
        pytest.approx(TSa.dynamometer_volt_to_force(1.5))


# ---- samplers and their CSV tiers -------------------------------------------

def _read(path):
    return pd.read_csv(path, index_col=0)


def test_dummy_sampler_rows_and_final_save_match_jax(tmp_path):
    """0.5 s at 200 Hz in each package: the same columns, one row a
    sample, and the same synthesized values on their common rows (the
    sample count follows the wall clock)."""
    frames = []
    for name, mod in (("jax", JSa), ("port", TSa)):
        shared = {}
        out = tmp_path / name
        mod.dummy_sampling_process(shared, _Event(), out,
                                   sampling_rate_hz=200.0, run_for_sec=0.5)
        assert shared["n_samples"] > 50
        assert {"fsr", "ecg", "gsr"} <= set(shared)
        final = list(out.glob("*Serial Measurements Final Save.csv"))
        assert len(final) == 1
        frame = _read(final[0])
        assert len(frame) == shared["n_samples"]
        frames.append(frame)
    jax_f, port_f = frames
    assert list(port_f.columns) == list(jax_f.columns) == ["fsr", "ecg",
                                                           "gsr"]
    n = min(len(jax_f), len(port_f))
    np.testing.assert_array_equal(port_f.values[:n], jax_f.values[:n])


@pytest.mark.parametrize("tier", ["redundant", "interim", "final"])
def test_csv_tiers_match_jax(tmp_path, tier):
    """Each tier's file name and layout (the time stamps as the unnamed
    index column); a second rolling save replaces the first."""
    rows = [{"Time": pd.Timestamp("2026-01-01 10:00:00")
             + pd.Timedelta(milliseconds=10 * i), "fsr": 1.0 + i,
             "ecg": 0.1, "gsr": 2.0} for i in range(5)]
    texts = []
    for name, mod in (("jax", JSa), ("port", TSa)):
        out = tmp_path / name
        out.mkdir()
        if tier == "interim":
            mod._interim_saver(out, rows)
        else:
            for _ in range(2 if tier == "redundant" else 1):
                mod._tiered_saver(out, rows, final=tier == "final")
        files = list(out.glob("*.csv"))
        assert len(files) == 1
        texts.append((files[0].name[20:], files[0].read_text()))
    assert texts[0] == texts[1]


def test_accuracy_sampler_matches_jax(tmp_path):
    """A constant target (min = max = 15 %MVC) against a constant 10 %MVC
    force: every squared error is 25, in both packages."""
    out = []
    for name, mod in (("jax", JSa), ("port", TSa)):
        rmse, n = mod.accuracy_sampler(
            {"fsr": 1.0}, _Event(), tmp_path / name, target_frequency_hz=1.0,
            min_pct_mvc=15.0, max_pct_mvc=15.0, mvc_kg=22.0,
            sampling_rate_hz=100.0, start_offset_sec=0.02, run_for_sec=0.25)
        assert n > 5
        csv = next((tmp_path / name).glob("*Trial Accuracy Results.csv"))
        out.append((rmse, _read(csv)))
    assert out[1][0] == pytest.approx(out[0][0]) == pytest.approx(5.0)
    assert list(out[1][1].columns) == list(out[0][1].columns) == \
        ["Squared Error"]
    assert set(out[1][1]["Squared Error"].round(9)) == \
        set(out[0][1]["Squared Error"].round(9))


# ---- the headless experiment ------------------------------------------------

def _experiment(mod, out_dir):
    cfg = mod.ExperimentConfig(
        subject_id=3, output_dir=out_dir, trial_duration_sec=40.0,
        n_trials_per_category=1, categories=["Happy", "Sad"],
        n_silence_trials=1, task_frequencies_hz=[0.5],
        mvc_calibration_sec=10.0, dummy_mode=True)
    return mod.start_experiment_processes(cfg, time_scale=0.02)


def _read_subject(di, subject_dir):
    """What the study pipeline reads of a subject's experiment: the log,
    its enriched frame, the measurement span, the task spans, the
    personal data and the serial frame."""
    log = di.fetch_experiment_log(subject_dir)
    enriched = di.prepare_log_frame(log, set_time_index=False,
                                    avg_end_delay_seconds=0.1)
    span = di.get_qtc_measurement_start_end(enriched, verbose=False)
    tasks = di.get_all_task_start_ends(
        enriched, output_type='list', assumed_latency_sec=0.0,
        cut_off_sec_to_prevent_transients=0.0)
    return {"log": log, "enriched": enriched, "span": span, "tasks": tasks,
            "personal": di.fetch_personal_data(subject_dir),
            "serial": di.fetch_serial_measurements(subject_dir)}


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    root = tmp_path_factory.mktemp("experiments")
    return {name: (_experiment(pkgs[1], root / name),
                   root / name / "subject_03")
            for name, pkgs in PKGS.items()}


def test_headless_experiment_results_match_jax(experiments):
    (jres, jdir), (tres, tdir) = experiments["jax"], experiments["port"]
    assert [t["label"] for t in tres["trials"]] == \
        [t["label"] for t in jres["trials"]]
    assert [t["category"] for t in tres["trials"]] == \
        [t["category"] for t in jres["trials"]]
    assert tres["mvc_kg"] > 0 and jres["mvc_kg"] > 0
    names = lambda d: sorted(p.relative_to(d).parent.as_posix() + "/"
                             + p.name[20:] for p in d.rglob("*.*"))
    # the same artifact tree; the rolling and interim tiers aside, whose
    # count follows the wall clock (a save within the same second as the
    # last one replaces it)
    keep = lambda ns: sorted({n for n in ns
                              if "Redundant" not in n and "Interim" not in n})
    assert keep(names(tdir)) == keep(names(jdir))
    for rel in ("Subject Data.json", "Post-Study Feedback Data.json"):
        j = next(jdir.glob(f"*{rel}")).read_text()
        assert next(tdir.glob(f"*{rel}")).read_text() == j


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_headless_experiment_reads_alike_through_both_integrations(
        experiments, reader):
    """Each package's experiment output read through ``reader``'s data
    integration: the same log rows (events, questionnaire lines, music),
    the same task count, song/silence IDs and personal data; the serial
    frames have the same columns."""
    di = PKGS[reader][3]
    got = {name: _read_subject(di, d) for name, (_, d) in
           experiments.items()}
    j, t = got["jax"], got["port"]
    cols = ["Music", "Event", "Questionnaire"]
    def events(log):
        return [tuple(r) for r in log[cols].fillna("").values
                if r[1] or r[2]]
    # the MVC and RMSE lines carry values that follow the wall clock (the
    # dummy force's phase): compare their text up to the value
    timed = ("MVC calibrated", "Achieved RMSE")
    strip = lambda rows: [tuple(c.split(": ")[0] if c.startswith(timed)
                                else c for c in r) for r in rows]
    assert strip(events(t["log"])) == strip(events(j["log"]))
    assert len(t["tasks"]) == len(j["tasks"]) == 3
    for key in ("Song ID", "Silence ID"):
        assert t["enriched"][key].max() == j["enriched"][key].max()
    assert t["span"][0] < t["span"][1]
    assert t["personal"] == j["personal"]
    assert t["personal"]["Listening habit [0-3]"] == 2
    assert list(t["serial"].columns) == list(j["serial"].columns)
    assert len(t["serial"]) > 50 and len(j["serial"]) > 50


def test_serial_testing_workflow_draws_both_packages_output(experiments,
                                                             tmp_path):
    """The serial-inspection workflow of either package on the port's
    experiment output: the same axes and the same plotted samples."""
    subject_dir = experiments["port"][1]
    figs = [mod.inspect_serial_modality(subject_dir, "fsr",
                                        compute_hr=False,
                                        save_dir=tmp_path / name)
            for name, mod in (("jax", JST), ("port", TST))]
    for name in ("jax", "port"):
        assert list((tmp_path / name).glob("*Serial Testing fsr*.png"))
    lines = [f.axes[0].lines[0].get_ydata() for f in figs]
    np.testing.assert_array_equal(lines[0], lines[1])
    assert [a.get_ylabel() for a in figs[0].axes] == \
        [a.get_ylabel() for a in figs[1].axes]
    for mod in (JST, TST):
        with pytest.raises(ValueError, match="modality"):
            mod.inspect_serial_modality(subject_dir, "nope")


def test_experiment_workflow_builds_the_config_as_jax(tmp_path,
                                                       monkeypatch):
    """``run_experiment`` reads the TxtConfig and applies the overrides as
    the JAX workflow does (the phase machine itself is stubbed here; the
    experiment tests above run it)."""
    txt = tmp_path / "experiment_config.txt"
    txt.write_text("Serial Sampling Rate --- 500\nTrial Duration --- 30\n"
                   "Categories --- Happy, Sad\n")
    seen = {}
    for name, mod in (("jax", JEW), ("port", TEW)):
        monkeypatch.setattr(mod, "start_experiment_processes",
                            lambda cfg, n=name: seen.__setitem__(n, cfg))
        mod.run_experiment(4, tmp_path / "out", config_txt=txt,
                           n_silence_trials=3)
    assert vars(seen["port"]) == vars(seen["jax"])
    assert seen["port"].serial_sampling_rate_hz == 500.0
    assert seen["port"].categories == ["Happy", "Sad"]


# ---- headless views ---------------------------------------------------------

@pytest.mark.parametrize("form,args", [
    ("onboarding_form", ()),
    ("onboarding_form", ({"Gender": "female", "Musical skill": 6,
                          "Name": "Test Subject"},)),
    ("offboarding_form", ()),
    ("familiarity_form", ("Song by Artist", False, {"Familiarity": 5})),
    ("post_trial_rating_form", ("song_000", False, {"Liking": 7})),
    ("legacy_plot_onboarding_form", ()),
])
def test_forms_match_jax(form, args):
    if form in ("onboarding_form", "offboarding_form") and args:
        args = (False,) + args
    assert getattr(TV, form)(*args) == getattr(JV, form)(*args)


def test_form_controller_matches_the_default_controller():
    prefills = {"familiarity": {"Familiarity": 5}}
    for ctrl in (TV.FormController(prefills=prefills),
                 JV.FormController(prefills=prefills)):
        assert ctrl.onboarding() == TE._DefaultController().onboarding()
        assert ctrl.offboarding() == TE._DefaultController().offboarding()
        assert ctrl.familiarity("x") == {"Familiarity": 5}
        assert ctrl.post_trial_rating("song_000") == \
            TE._DefaultController().post_trial_rating("song_000")
    assert vars(TE._DefaultController) .keys() == \
        vars(JE._DefaultController).keys()


def test_breakout_countdown_and_animation_match_jax():
    ticks = {}
    for name, mod in (("jax", JV), ("port", TV)):
        ticks[name] = []
        assert mod.breakout_countdown(2.4, tick_fn=ticks[name].append) == 3
    assert ticks["port"] == ticks["jax"] == [3, 2, 1]
    stop = _Event()
    calls = []
    mgr = TV.AnimationManager(plt.figure(), calls.append, stop_event=stop)
    mgr.step(2)
    stop.set()
    mgr.step(3)
    assert calls == [0, 1]


@pytest.mark.parametrize("shared", [{"fsr": 1.8, "accuracy": 0.25}, {}])
def test_input_view_matches_jax(shared):
    arts = []
    for mod in (JV, TV):
        mgr = mod.plot_input_view(dict(shared), mvc_kg=30.0, window_sec=2.0,
                                  refresh_hz=10.0)
        a = mgr.step(5)
        arts.append((a[0].get_ydata().copy(), a[3].get_text()))
        mgr.stop()
    np.testing.assert_array_equal(arts[1][0], arts[0][0])
    assert arts[1][1] == arts[0][1]


def test_master_view_matches_jax(tmp_path):
    seen = []
    for name, (_, exp, views, _) in PKGS.items():
        log = exp.ExperimentLog(tmp_path / name)
        start, stop = _Event(), _Event()
        view = views.QtcControlMasterView(
            log, ["Familiar Happy", "Familiar Sad", "Sad"],
            start_trigger_event=start, stop_trigger_event=stop,
            rng_seed=1)
        for button in ["Start Trigger", view.category_order[0],
                       "Interim Save", "Stop Trigger"]:
            view.press(button)
        view.set_dc_offset(0.3)
        rows = [(r["Music"], r["Event"]) for r in log.rows]
        view.press("WorkMem Save")
        seen.append((view.category_order, rows, start.is_set(),
                     stop.is_set(), view.shared_dict["dc_offset"],
                     log.rows, sorted(p.name[20:] for p in
                                      (tmp_path / name).glob("*.csv"))))
        view.close()
    assert seen[0] == seen[1]


def test_performance_view_matches_jax_and_saves(tmp_path):
    """The per-subject RMSEs equal the JAX view's.  With ``save_dir`` the
    port saves the figure; the JAX view passes it where ``smart_save_fig``
    takes the suffix and raises TypeError (ROADMAP C14)."""
    for subj, scale in ((0, 1.0), (1, 2.0)):
        for trial in range(2):
            tdir = tmp_path / f"subject_{subj:02}" / f"song_{trial:03}"
            tdir.mkdir(parents=True)
            pd.DataFrame({"Squared Error": np.full(10, scale ** 2)}).to_csv(
                tdir / filemgmt.file_title("Trial Accuracy Results",
                                           ".csv"))
    fig_j, per_j = JV.plot_performance_view(tmp_path)
    fig_t, per_t = TV.plot_performance_view(tmp_path,
                                            save_dir=tmp_path / "out")
    assert per_t == per_j == {0: [1.0, 1.0], 1: [2.0, 2.0]}
    assert len(list((tmp_path / "out").glob("*Performance View.png"))) == 1
    with pytest.raises(TypeError, match="concatenate"):
        JV.plot_performance_view(tmp_path, save_dir=tmp_path / "jax_out")
    plt.close("all")
