"""The port's log and serial integration layer against ``mba_tpu`` on the
CPU: ``pipeline.data_integration`` (the log fetch and enrichment, the
validators and repairs, the curation ops and every ``fetch_*`` loader),
``workflows.study_curation`` and ``workflows.data_integration_workflow``.

All of it is host pandas copied from the JAX package, so every result
must be equal: frames and series with ``pd.testing``, arrays exactly,
dicts and lists element by element, printed reports character for
character.  The tree is ``tests/_torch_study.py``'s small study (two
subjects), with song information and questionnaire JSONs, a planted
questionnaire mismatch, a missing questionnaire and an interim serial
save added to subject 0, and a raw log (``make_raw_log`` of
``tests/test_pipeline_data_integration.py``) as subject 5's experiment
log for the integration workflow.
"""
import contextlib
import io
import json

import numpy as np
import pandas as pd
import pytest

from mba_tpu.pipeline import data_integration as JDI
from mba_tpu.workflows import data_integration_workflow as JDW
from mba_tpu.workflows import study_curation as JSC
from mba_tpu_torch.pipeline import data_integration as TDI
from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.workflows import data_integration_workflow as TDW
from mba_tpu_torch.workflows import study_curation as TSC

from _torch_study import assert_same, write_small_study
from test_pipeline_data_integration import make_raw_log

RAW_SUBJECT = 5


def _json(path, title, payload):
    with open(path / filemgmt.file_title(title, ".json"), "w") as f:
        json.dump(payload, f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("integration")
    study = write_small_study(root, 2)
    exp = study["exp_root"]
    sub0 = exp / "subject_00"
    log = pd.read_csv(filemgmt.most_recent_file(
        sub0 / "experiment_logs", ".csv", ["Enriched Experiment Log"]))
    for song_id, group in log[log["Song ID"].notna()].groupby("Song ID"):
        tdir = sub0 / f"song_{int(song_id):03}"
        title = group["Song Title"].iloc[0]
        _json(tdir, "song information", {
            "Title": title if song_id != 2 else "Another Title",
            "Artist": group["Song Artist"].iloc[0], "Album": "Album",
            "Genre": "Pop", "Duration [ms]": 180000, "BPM": 120})
        _json(tdir, "Familiarity Check",
              {"Familiarity": int(group["Familiarity"].iloc[0])})
        if song_id != 4:
            liking = int(group["Liking"].iloc[0]) + (song_id == 1)
            _json(tdir, "Post-Trial Rating", {
                "Liking": liking,
                "Emotional State": int(group["Emotional State"].iloc[0])})
    for sil_id, group in log[log["Silence ID"].notna()].groupby(
            "Silence ID"):
        _json(sub0 / f"silence_{int(sil_id):03}", "Post-Trial Rating",
              {"Emotional State": int(group["Emotional State"].iloc[0])})
    serial = sub0 / "serial_measurements"
    final = pd.read_csv(filemgmt.most_recent_file(serial, ".csv",
                                                  ["Final Save"]))
    final.iloc[:400].to_csv(serial / filemgmt.file_title(
        "Serial Measurements Interim Save WorkMem Full", ".csv"),
        index=False)
    enriched_serial = final.rename(columns={final.columns[0]: "Time"})
    enriched_serial["bpm"] = 60.0 + np.arange(len(final)) % 7
    enriched_serial.to_csv(serial / filemgmt.file_title(
        "Enriched Serial Frame", ".csv"), index=False)

    raw_dir = exp / f"subject_{RAW_SUBJECT:02}"
    (raw_dir / "experiment_logs").mkdir(parents=True)
    make_raw_log().to_csv(raw_dir / "experiment_logs" / filemgmt.file_title(
        "Experiment Log Final Full Save", ".csv"), index=False)
    for name in ("song_000", "silence_000"):
        (raw_dir / name).mkdir()
    _json(raw_dir / "song_000", "song information",
          {"Title": "Thunder", "Artist": "Imagine Dragons"})
    _json(raw_dir / "song_000", "Familiarity Check", {"Familiarity": 4})
    _json(raw_dir / "song_000", "Post-Trial Rating",
          {"Liking": 4, "Fitting Category": 4, "Emotional State": 3})
    _json(raw_dir / "silence_000", "Post-Trial Rating",
          {"Liking": 2, "Emotional State": 4})
    # the raw log's serial trace (naive times, 50 Hz), frozen for 2 s in
    # the silence trial
    t = np.arange(0.0, 95.0, 0.02)
    fsr = 1.0 + 0.2 * np.sin(2 * np.pi * 0.25 * t)
    fsr[(t >= 60.0) & (t < 62.0)] = 1.1
    raw_serial = root / "raw_serial"
    raw_serial.mkdir()
    pd.DataFrame({"fsr": fsr, "ecg": np.cos(t), "gsr": 2.0 + 0 * t},
                 index=pd.Timestamp("2024-01-01 12:00:00")
                 + pd.to_timedelta(t, unit="s")).to_csv(
        raw_serial / filemgmt.file_title(
            "Serial Measurements Final Save", ".csv"))
    return {"exp": exp, "sub0": sub0, "sub1": exp / "subject_01",
            "raw": raw_dir, "raw_serial": raw_serial,
            "lookup": study["lookup"], "root": root}


def _both(call):
    """call(module) on each package; returns (port, jax) results and
    what each printed."""
    out = []
    for mod in (TDI, JDI):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out.append((call(mod), buf.getvalue()))
    return out


def _log(mod, tree, **kw):
    return mod.fetch_enriched_log_frame(tree["sub0"], verbose=False, **kw)


FETCHERS = {
    "enriched_log": lambda m, t: m.fetch_enriched_log_frame(t["sub0"]),
    "enriched_log_no_index": lambda m, t: m.fetch_enriched_log_frame(
        t["sub1"], set_time_index=False, verbose=False),
    "serial": lambda m, t: m.fetch_serial_measurements(t["sub0"]),
    "serial_first_20_s": lambda m, t: m.fetch_serial_measurements(
        t["sub0"], load_only_first_n_seconds=20),
    "serial_no_index": lambda m, t: m.fetch_serial_measurements(
        t["sub1"], set_time_index=False),
    "enriched_serial": lambda m, t: m.fetch_enriched_serial_frame(t["sub0"]),
    "personal": lambda m, t: m.fetch_personal_data(t["sub0"]),
    "personal_with_name": lambda m, t: m.fetch_personal_data(
        t["sub1"], include_name_and_birthdate=True),
    "onboarding": lambda m, t: m.fetch_onboarding_questionnaire(t["sub0"]),
    "offboarding": lambda m, t: m.fetch_offboarding_questionnaire(t["sub1"]),
    "accuracy_song": lambda m, t: m.fetch_trial_accuracy(t["sub0"],
                                                         song_id=3),
    "accuracy_silence": lambda m, t: m.fetch_trial_accuracy(t["sub0"],
                                                            silence_id=1),
    "accuracy_trial": lambda m, t: m.fetch_trial_accuracy(
        t["sub0"], log_df=_log(m, t), trial_id=7),
    "accuracy_missing": lambda m, t: m.fetch_trial_accuracy(
        t["sub0"], song_id=99, verbose=True),
    "all_accuracies": lambda m, t: m.fetch_all_accuracies_and_questionnaires(
        t["sub0"], max_song_ind=8, max_silence_ind=4, verbose=True),
    "questionnaire_song": lambda m, t: m.fetch_trial_questionnaire(
        t["sub0"], song_id=1),
    "questionnaire_missing_rating": lambda m, t: m.fetch_trial_questionnaire(
        t["sub0"], song_id=4, verbose=True),
    "song_information": lambda m, t: m.fetch_song_information(t["sub0"], 0),
    "song_information_missing": lambda m, t: m.fetch_song_information(
        t["sub1"], 0),
    "trial_dir": lambda m, t: m.fetch_trial_dir(
        t["sub0"], log_df=_log(m, t), trial_id=3).name,
    "music_features_trial": lambda m, t: m.fetch_music_features(
        _log(m, t), music_lookup_table_path=t["lookup"], trial_id=4),
    "music_features_silence": lambda m, t: m.fetch_music_features(
        _log(m, t), music_lookup_table_path=t["lookup"], trial_id=3),
    "music_features_song_frame": lambda m, t: m.fetch_music_features(
        _log(m, t), music_lookup_table_path=pd.read_csv(t["lookup"]),
        song_id=5, features_to_return=("BPM_manual", "Spectral Flux Std.")),
    "excluded_and_skipped": lambda m, t: (
        m.fetch_excluded_trials(_log(m, t).reset_index()),
        m.fetch_skipped_trials(_log(m, t).reset_index())),
    "qtc_span": lambda m, t: m.get_qtc_measurement_start_end(
        _log(m, t), verbose=True),
    "song_span": lambda m, t: m.get_song_start_end(_log(m, t), song_id=2),
    "song_span_by_title": lambda m, t: m.get_song_start_end(
        _log(m, t), song_title="Track03"),
    "task_spans": lambda m, t: m.get_all_task_start_ends(_log(m, t), "dict"),
}


@pytest.mark.parametrize("name", sorted(FETCHERS))
def test_fetchers_match_jax(tree, name):
    (got, got_out), (want, want_out) = _both(
        lambda m: FETCHERS[name](m, tree))
    assert_same(got, want, name)
    assert got_out == want_out


@pytest.mark.parametrize("name", ["trial_dir", "song_information",
                                  "music_features", "serial"])
def test_fetchers_raise_as_jax(tree, name):
    calls = {
        "trial_dir": lambda m: m.fetch_trial_dir(tree["sub0"]),
        "song_information": lambda m: m.fetch_song_information(
            tree["sub1"], 0, error_handling="raise"),
        "music_features": lambda m: m.fetch_music_features(
            _log(m, tree), music_lookup_table_path=tree["lookup"]),
        "serial": lambda m: m.fetch_serial_measurements(tree["raw"]),
    }
    errors = []
    for mod in (TDI, JDI):
        with pytest.raises(Exception) as info:
            calls[name](mod)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_log_fetch_and_enrichment_match_jax(tree):
    (got, _), (want, _) = _both(
        lambda m: m.fetch_experiment_log(tree["raw"]))
    assert_same(got, want)
    for kw in ({}, {"set_time_index": False},
               {"avg_end_delay_seconds": 3.0}):
        (got, _), (want, _) = _both(
            lambda m: m.prepare_log_frame(make_raw_log(), **kw))
        assert_same(got, want, str(kw))


def test_validators_and_repair_match_jax(tree):
    songs = lambda m: m.validate_song_indices(
        _log(m, tree).reset_index().query("`Song ID`.notna()"),
        tree["sub0"])
    (got, got_out), (want, want_out) = _both(songs)
    assert_same(got, want)
    assert got_out == want_out
    assert [m["Song ID"] for m in got["mismatches"]] == [2]

    reports = _both(lambda m: m.validate_trial_questionnaires(
        _log(m, tree).reset_index(), tree["sub0"]))
    (got, got_out), (want, want_out) = reports
    assert_same(got, want)
    assert got_out == want_out
    assert len(got["mismatches"]) == 1 and len(
        got["missing_questionnaires"]) == 0

    (got, got_out), (want, want_out) = _both(
        lambda m: m.repair_trial_questionnaire_mismatches(
            _log(m, tree).reset_index(), reports[1][0]))
    assert_same(got, want)
    assert got_out == want_out

    (got, got_out), (want, want_out) = _both(
        lambda m: m.validate_force_measurements(
            _log(m, tree), m.fetch_serial_measurements(tree["sub0"])))
    assert got is None and want is None
    assert got_out == want_out and "trial ID" in got_out


def test_curation_ops_match_jax(tree):
    ops = {
        "remove_song": lambda m, e, r: m.remove_song_entries(
            e, r, [("Thunder", "Imagine Dragons", 0),
                   ("Nothing", "Nobody", 3)]),
        "remove_silence": lambda m, e, r: m.remove_silence_trial(e, r,
                                                                 [0, 7]),
        "remove_row": lambda m, e, r: m.remove_single_row_by_timestamp(
            r, r["Time"].iloc[5]),
        "annotate": lambda m, e, r: m.annotate_trial(
            e, "Talking", True, silence_id=0),
    }
    for name, op in ops.items():
        (got, got_out), (want, want_out) = _both(lambda m: op(
            m, m.prepare_log_frame(make_raw_log(), set_time_index=False),
            make_raw_log()))
        assert_same(got, want, name)
        assert got_out == want_out


def test_study_curation_record_matches_jax():
    assert sorted(TSC.STUDY_CURATION) == sorted(JSC.STUDY_CURATION)
    for s in JSC.STUDY_CURATION:
        assert (TSC.STUDY_CURATION[s].__dict__
                == JSC.STUDY_CURATION[s].__dict__)


@pytest.mark.parametrize("subject", range(12))
def test_apply_subject_curation_matches_jax(subject):
    """Each of the study's 12 records replayed on the synthetic raw log
    (the records name the study's songs and rows: most ops find nothing
    to do there and print so, as the JAX package does)."""
    out = []
    for mod in (TSC, JSC):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                res = mod.apply_subject_curation(
                    make_raw_log(), mod.STUDY_CURATION[subject])
            except ValueError as exc:     # subject 2's 15-min trigger
                res = ("ValueError", str(exc))
        out.append((res, buf.getvalue()))
    assert_same(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


@pytest.mark.parametrize("kind", ["actual_start", "idle", "beyond_log"])
def test_apply_subject_curation_cases_match_jax(kind):
    raw = make_raw_log()
    records = {
        "actual_start": dict(actual_start_trigger_offset_min=0.5,
                             song_removals=(("Thunder", "Imagine Dragons",
                                             0),)),
        "idle": dict(idle_state_from=str(raw["Time"].iloc[-8]),
                     row_removals=(raw["Time"].iloc[3],),
                     annotations=(("Talking", True, "silence_id", 0),
                                  ("Fine", False, "trial_id", 0))),
        "beyond_log": dict(actual_start_trigger_offset_min=9999.0),
    }
    results = []
    for mod in (TSC, JSC):
        try:
            results.append(mod.apply_subject_curation(
                make_raw_log(), mod.SubjectCuration(**records[kind])))
        except ValueError as exc:
            results.append(("ValueError", str(exc)))
    assert_same(results[0], results[1])


@pytest.mark.parametrize("curation,validate", [
    (None, True), ("study", True), ("study", False)])
def test_integrate_subject_matches_jax(tree, tmp_path, curation, validate):
    """Raw log → curated, validated, enriched log, saved: the port's and
    the JAX package's workflow on copies of one subject directory that
    holds no serial trace (the force validation is skipped with a note;
    with a trace, see the next test)."""
    import shutil
    out = {}
    for name, mod in (("port", TDW), ("jax", JDW)):
        exp = tmp_path / name
        sub = exp / f"subject_{RAW_SUBJECT:02}"
        shutil.copytree(tree["raw"], sub)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            frame = mod.integrate_subject(RAW_SUBJECT, exp,
                                          validate=validate,
                                          curation=curation)
        saved = filemgmt.most_recent_file(
            sub / "experiment_logs", ".csv", ["Enriched Experiment Log"])
        out[name] = (frame, saved.name[20:], saved.read_text(),
                     buf.getvalue().replace(str(exp), "<exp>"))
    assert_same(out["port"], out["jax"])
    assert out["port"][0]["Trial ID"].notna().any()
    assert ("no serial measurements" in out["port"][3]) == validate


def test_integrate_subject_validates_force_on_a_naive_log(tree, tmp_path):
    """Fault C11: the raw log's times are naive and the serial trace is
    read as UTC; the JAX package's force validation slices the one with
    the other, which pandas ≥ 2 refuses (TypeError).  The port makes both
    aware first: its workflow saves the frame the JAX package saves
    without a trace, and prints what the JAX package's validation prints
    on the log made aware."""
    import shutil
    exp = {}
    for name in ("port", "jax"):
        exp[name] = tmp_path / name
        sub = exp[name] / f"subject_{RAW_SUBJECT:02}"
        shutil.copytree(tree["raw"], sub)
        if name == "port":
            shutil.copytree(tree["raw_serial"], sub / "serial_measurements")
    serial = JDI.fetch_serial_measurements(
        exp["port"] / f"subject_{RAW_SUBJECT:02}")
    with pytest.raises(TypeError):
        JDW.integrate_subject(RAW_SUBJECT, exp["port"], validate=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = TDW.integrate_subject(RAW_SUBJECT, exp["port"], validate=True)
    want = JDW.integrate_subject(RAW_SUBJECT, exp["jax"], validate=True)
    assert_same(got, want)
    aware = want.set_index("Time")
    aware.index = JDI.make_timezone_aware(aware.index)
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        JDI.validate_force_measurements(aware, serial)
    assert "Frozen force measurements" in ref.getvalue()
    assert ref.getvalue() in buf.getvalue()
