"""The port's cohort descriptives (``mba_tpu_torch.workflows.
descriptive_statistics_workflow``) against ``mba_tpu``'s: host code on
the questionnaires of a ``tests/_torch_study.py`` tree and a synthetic
"Combined Statistics 1seg" frame, so the three frames are equal to the
value and the box mosaic is drawn under the same name.
"""
import numpy as np
import pandas as pd
import pytest

from mba_tpu.workflows import descriptive_statistics_workflow as JD
from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.workflows import descriptive_statistics_workflow as TD

from _torch_study import write_small_study

N_SUBJECTS = 3
DVS = ["CMC_Flexor_max_beta", "CMC_Extensor_max_beta", "RMS_Accuracy",
       "Median_Heart_Rate", "GSR"]


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp("descriptives")
    info = write_small_study(root, N_SUBJECTS)
    rng = np.random.default_rng(4)
    n = N_SUBJECTS * 10
    frame = pd.DataFrame({
        "Subject ID": np.repeat(np.arange(N_SUBJECTS), 10),
        "Category or Silence": np.tile(
            ["Happy", "Sad", "Classic", "Silence", "Silence"], 6),
        "CMC_Flexor_max_beta": rng.uniform(0.2, 0.6, n),
        "CMC_Extensor_max_beta": rng.uniform(0.1, 0.5, n),
        "RMS_Accuracy": np.where(rng.random(n) < 0.2, np.nan,
                                 rng.normal(15, 3, n)),
        "Median_Heart_Rate": rng.normal(70, 5, n),
        "GSR": ["x"] + list(rng.normal(2, 0.3, n - 1))})
    frame.to_csv(info["feat_root"] / filemgmt.file_title(
        "Combined Statistics 1seg", ".csv"), index=False)
    return dict(info, frame=pd.read_csv(filemgmt.most_recent_file(
        info["feat_root"], ".csv", ["Combined Statistics 1seg"])))


def test_cohort_demographics_matches_jax(study):
    ids = [0, 1, 2, 7]
    got = TD.cohort_demographics(study["exp_root"], ids)
    pd.testing.assert_frame_equal(
        got, JD.cohort_demographics(study["exp_root"], ids))
    assert got["Subject ID"].tolist() == [0, 1, 2]
    assert "Musical skill" in got


@pytest.mark.parametrize("group_col", ["Category or Silence", "Subject ID"])
def test_grouped_dv_summary_matches_jax(study, group_col):
    dvs = DVS + ["Not A Column"]
    got = TD.grouped_dv_summary(study["frame"], dvs, group_col)
    pd.testing.assert_frame_equal(
        got, JD.grouped_dv_summary(study["frame"], dvs, group_col))
    assert set(got["DV"]) == set(DVS)


def test_dv_correlations_match_jax(study):
    dvs = DVS + ["Not A Column"]
    got = TD.dv_correlations(study["frame"], dvs)
    pd.testing.assert_frame_equal(got,
                                  JD.dv_correlations(study["frame"], dvs))
    assert len(got) == len(DVS) * (len(DVS) - 1) // 2
    tiny = study["frame"].head(2)
    assert TD.dv_correlations(tiny, DVS).empty


def test_run_descriptives_matches_jax(study, tmp_path):
    """The three frames returned and saved, and the box mosaic (the five
    DVs and the musical skill) under the same name."""
    out = {}
    for name, module in (("port", TD), ("jax", JD)):
        out[name] = module.run_descriptives(
            study["exp_root"], study["feat_root"], tmp_path / name,
            subject_ids=range(N_SUBJECTS + 1))
    for key in ("demographics", "summary", "correlations"):
        pd.testing.assert_frame_equal(out["port"][key], out["jax"][key])
    files = [sorted(p.name[20:] for p in (tmp_path / k).iterdir())
             for k in ("port", "jax")]
    assert files[0] == files[1] == [
        "Cohort Demographics.csv", "Cohort Descriptives.png",
        "Descriptive DV Correlations.csv", "Descriptive DV Summary.csv"]
    for name in ("Cohort Demographics", "Descriptive DV Correlations",
                 "Descriptive DV Summary"):
        got, want = (filemgmt.most_recent_file(tmp_path / k, ".csv", [name])
                     .read_text() for k in ("port", "jax"))
        assert got == want, name
