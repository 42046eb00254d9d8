"""The port's Markdown report (``mba_tpu_torch.pipeline.
statistical_reporting`` and ``workflows.statistics_report_workflow``)
against ``mba_tpu``'s, on ``tests/test_reporting_music.py``'s frames.

Every section builder, the frame validation and the sample-size helpers
give the JAX package's values exactly; the whole report gives its text
character for character but for line 2, the ``*Generated: …*``
timestamp, which both packages write from the clock.  The null-engine
section is fed the metadata of the port's ``cohort_msc_null`` on the CPU
(``tests/test_torch_cohort_engines.py``'s cohort, cut to 8 s).
"""
import numpy as np
import pandas as pd
import pytest
import torch

from mba_tpu.ops import cohort_null as JN
from mba_tpu.pipeline import statistical_reporting as JR
from mba_tpu.workflows import statistics_report_workflow as JRW
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.pipeline import statistical_reporting as TR
from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.workflows import statistics_report_workflow as TRW

from _torch_parity import cohort_subject
from test_reporting_music import _frames

torch.set_num_threads(1)

FS = 256.0
DV = "CMC_Flexor_max_beta"
HAPPY = "C(Q('Category or Silence'))[T.Happy]"
GROUPS = [{"name": "Music categories", "dvs": [DV], "comparison_level": 1,
           "predictors": {"Happy vs Silence": [HAPPY]}}]
LEVELS = [{"condition_vars": {"Category or Silence": "categorical"},
           "explanatory_vars": []},
          {"condition_vars": {"Music Listening": "bool"},
           "explanatory_vars": ["Median Force Level [0-1]"],
           "moderation_pairs": [("a", "b")]}]


def _fdr_frames():
    """The frames with a second Level-1 parameter, so FDR has a family."""
    res, *rest = _frames()
    extra = res.iloc[[0]].copy()
    extra["Parameter"] = "C(Q('Category or Silence'))[T.Sad]"
    extra["p_value_adjusted"] = 0.04
    return (pd.concat([res, extra], ignore_index=True), *rest)


def _cfg(module, **kw):
    return module._ReportConfig(resolution_segments=[1, 5], **kw)


def _section_calls(module):
    """Each section builder on the frames: name → call()."""
    res, diag, power, influence, het, cbpa, mi, clusters = _frames()
    cfg = _cfg(module)
    sub = res[res["Dependent_Variable"] == DV]
    null_md = [{"label": "CMC cohort null", "method": "taper_rotation",
                "sensitivity_note": TN.SENSITIVITY_NOTE,
                "engine_choice": {"method_requested": "auto",
                                  "method_run": "rotation",
                                  "estimated_fft_flops": 6.5e14,
                                  "fft_flop_budget": 3e12}},
               {"method": "full_fft_phase_randomization",
                "engine_choice": {"method_requested": "fft",
                                  "method_run": "fft"}}]
    return {
        "level_definitions": lambda: module._section_level_definitions(
            LEVELS),
        "overview_table": lambda: module._section_overview_table(
            res, power, cfg),
        "overview_table_no_power": lambda: module._section_overview_table(
            res, pd.DataFrame(), cfg),
        "predictor_quality": lambda: module._section_predictor_quality(
            GROUPS, res, power, influence, cfg),
        "sample_size_estimation": lambda:
            module._section_sample_size_estimation(
                GROUPS, res, power.iloc[0:0], diag, cfg, 6),
        "sample_size_well_powered": lambda:
            module._section_sample_size_estimation(
                GROUPS, res, power, diag, cfg, 6, [
                    "Category or Silence: Happy", "Nope"]),
        "findings": lambda: module._section_findings("H2", DV, sub, cfg),
        "cross_resolution": lambda: module._section_cross_resolution(
            "H2", DV, sub, cfg),
        "trust": lambda: module._section_trust("H2", DV, sub, power,
                                               influence, cfg),
        "cbpa": lambda: module._section_cbpa("H2", DV, cbpa),
        "heterogeneity": lambda: module._section_heterogeneity(
            "H2", DV, het, influence, cfg),
        "diagnostics": lambda: module._section_diagnostics(
            "H2", DV, diag, cfg),
        "subject_clusters": lambda: module._section_subject_clusters(
            clusters),
        "mi_summary": lambda: module._section_mi_summary(mi),
        "mi_summary_filtered": lambda: module._section_mi_summary(
            mi, ["DFBETA"]),
        "surrogate_null_engine": lambda:
            module._section_surrogate_null_engine(null_md),
        "surrogate_null_engine_dict": lambda:
            module._section_surrogate_null_engine(null_md[0]),
    }


@pytest.mark.parametrize("name", list(_section_calls(TR)))
def test_each_section_matches_jax(name):
    got = _section_calls(TR)[name]()
    want = _section_calls(JR)[name]()
    assert got == want
    assert name.startswith("mi_summary_filtered") or got


def test_validate_frames_matches_jax():
    res, diag, power, influence, het, cbpa, *_ = _frames()
    full = {"omnibus_results": res, "omnibus_diagnostics": diag,
            "power_analysis": power, "influence_measures": influence,
            "subject_heterogeneity": het, "cbpa_results": cbpa}
    partial = {"omnibus_results": pd.DataFrame({"Hypothesis": [1]}),
               "power_analysis": pd.DataFrame()}
    assert TR.validate_frames(full) == JR.validate_frames(full) == []
    got = TR.validate_frames(partial)
    assert got == JR.validate_frames(partial)
    assert any("missing columns" in w for w in got)
    assert any("empty" in w for w in got)


@pytest.mark.parametrize("d,icc,k", [
    (0.8, 0.0, 1), (0.5, 0.0, 10), (0.5, 0.8, 10), (0.3, 0.4, 5),
    (0.6, 0.4, 5), (0.0, 0.4, 5), (0.5, float("nan"), 5), (0.5, 0.4, 0),
    (-0.45, 0.2, 33.3)])
def test_required_n_subjects_matches_jax(d, icc, k):
    got = TR._required_n_subjects(d, icc, k)
    assert got == JR._required_n_subjects(d, icc, k)
    if d == 0.8 and k == 1:
        assert 13 <= got <= 17


@pytest.mark.parametrize("pred,power_rows", [
    ("Category or Silence: Happy", 1), ("Category or Silence: Happy", 0),
    ("Nope", 1)])
def test_estimate_n_for_cell_matches_jax(pred, power_rows):
    res, diag, power, *_ = _frames()
    power = power.iloc[:power_rows]
    got = TR._estimate_n_for_cell(pred, DV, res, power, diag, _cfg(TR), 6)
    want = JR._estimate_n_for_cell(pred, DV, res, power, diag, _cfg(JR), 6)
    assert got == want
    assert got["status"] == {(1, "C"): "well_powered",
                             (0, "C"): "estimated"}.get(
        (power_rows, pred[0]), "missing")


@pytest.mark.parametrize("param", [
    HAPPY, "C(Cat)[T.X]", "Q('Median Force Level [0-1]')", "Intercept",
    "C(Q('Music Listening'))[T.True]:Q('Median Force Level [0-1]')"])
def test_clean_param_matches_jax(param):
    assert TR._clean_param(param) == JR._clean_param(param)


def _masked(path):
    lines = path.read_text(encoding="utf-8").splitlines()
    assert lines[1].startswith("*Generated: ")
    return lines[:1] + lines[2:]


@pytest.fixture(scope="module")
def null_metadata():
    """``cohort_msc_null`` metadata of both packages on one 2-subject
    cohort: the rotation engine (forced by a 1-flop budget) and the CPU
    default budget's choice."""
    subj = [cohort_subject(40 + j, n_sec=8.0, couple=2.0) for j in range(2)]
    eeg = np.stack([s[0] for s in subj])
    emg = np.stack([s[1] for s in subj])
    kw = dict(window_length_sec=2.0, band=(8.0, 60.0), n_surrogates=40,
              surrogate_chunk=20, coeff_engine="gram",
              p_value_windows="disjoint")
    out = {}
    for budget in (1.0, None):
        got = TN.cohort_msc_null(eeg, emg, FS, fft_flop_budget=budget,
                                 device="cpu", **kw)["metadata"]
        want = JN.cohort_msc_null(eeg, emg, FS, fft_flop_budget=budget,
                                  **kw)["metadata"]
        out.setdefault("port", []).append(dict(got, label=f"b={budget}"))
        out.setdefault("jax", []).append(dict(want, label=f"b={budget}"))
    return out


def test_null_metadata_carries_the_jax_keys(null_metadata):
    """The keys and types the report's null-engine section reads."""
    for got, want in zip(null_metadata["port"], null_metadata["jax"]):
        assert got["engine_choice"] == want["engine_choice"]
        for key, value in got["engine_choice"].items():
            assert type(value) is type(want["engine_choice"][key]), key
        assert got.get("sensitivity_note") == want.get("sensitivity_note")
    runs = [m["engine_choice"]["method_run"] for m in null_metadata["port"]]
    assert runs == ["rotation", "fft"]
    assert null_metadata["port"][0]["sensitivity_note"] == \
        TN.SENSITIVITY_NOTE


@pytest.mark.parametrize("fdr,groups,null", [
    (None, False, False), ([1], True, False), ([1, 2], True, True),
    (None, True, True)])
def test_report_matches_jax(tmp_path, null_metadata, fdr, groups, null):
    """The whole report, line 2 masked: with and without the FDR pass
    and the predictor groups, and with the null metadata of each
    package's own ``cohort_msc_null``."""
    frames = _fdr_frames() if fdr else _frames()
    kw = dict(primary_n_segments=1, resolution_segments=[1, 5],
              level_definitions=LEVELS, fdr_levels_to_correct=fdr)
    if groups:
        kw.update(hypothesis_groups=GROUPS, n_subjects=6)
    text = {}
    for name, module in (("port", TR), ("jax", JR)):
        path = module.generate_statistical_report(
            *frames, output_dir=tmp_path / name,
            surrogate_null_metadata=null_metadata[name] if null else None,
            file_identifier_suffix="RQ_A", **kw)
        assert path.name[20:] == "Statistical Report_RQ_A.md"
        text[name] = _masked(path)
    assert text["port"] == text["jax"]
    body = "\n".join(text["port"])
    assert ("Surrogate-Null Engine" in body) == null
    assert ("Detection limit" in body) == null
    assert ("Sample-Size Estimation" in body) == groups


def _write_results(directory, frames):
    res, diag, power, influence, het, cbpa, mi, clusters = frames
    for name, frame in (("All Time Resolutions Results", res),
                        ("All Time Resolutions Diagnostics", diag),
                        ("Power Analysis MDE Summary", power),
                        ("Influence Analysis Combined", influence),
                        ("Subject Effect Summary Combined", het),
                        ("CBPA Combined Cluster Summary", cbpa),
                        ("Heterogeneity MI Summary", mi),
                        ("Heterogeneity Subject Clusters", clusters)):
        frame.to_csv(directory / filemgmt.file_title(name, ".csv"),
                     index=False)


def test_build_report_matches_jax(tmp_path):
    """``build_report`` reads the newest CSV of each frame from the
    omnibus and post-hoc directories; a frame that is not there is empty
    and named in the validation warnings."""
    omnibus = tmp_path / "omnibus"
    omnibus.mkdir()
    _write_results(omnibus, _fdr_frames())
    text = {}
    for name, module in (("port", TRW), ("jax", JRW)):
        path = module.build_report(omnibus, omnibus, tmp_path / name,
                                   "RQ_A", level_definitions=LEVELS,
                                   fdr_levels_to_correct=[1])
        text[name] = _masked(path)
        empty = module._load_or_empty(tmp_path, ["Nothing Here"])
        assert isinstance(empty, pd.DataFrame) and empty.empty
    assert text["port"] == text["jax"]
    assert "> ✅ All six frames validated — no missing columns." in \
        text["port"]
    bare = tmp_path / "bare"
    bare.mkdir()
    _frames()[0].to_csv(bare / filemgmt.file_title(
        "All Time Resolutions Results", ".csv"), index=False)
    got = _masked(TRW.build_report(bare, bare, tmp_path / "p2", "RQ_B"))
    assert got == _masked(JRW.build_report(bare, bare, tmp_path / "j2",
                                           "RQ_B"))
    assert "- `cbpa_results` frame is empty." in got


def test_build_report_needs_the_omnibus_results(tmp_path):
    with pytest.raises(FileNotFoundError, match="omnibus"):
        TRW.build_report(tmp_path, tmp_path, tmp_path / "out", "RQ_A")
