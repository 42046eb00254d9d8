"""The port's heterogeneity modelling (``mba_tpu_torch.pipeline.
heterogeneity_modelling``) against ``mba_tpu``'s, block by block and end
to end, on the CPU: host code (pandas, scikit-learn, scipy), so every
frame is held to the JAX package's with ``pd.testing.assert_frame_equal``
and exact values, and every figure to its file name.
"""
import json

import numpy as np
import pandas as pd
import pytest

from mba_tpu.pipeline import heterogeneity_modelling as JH
from mba_tpu_torch.pipeline import heterogeneity_modelling as TH
from mba_tpu_torch.utils import file_management as filemgmt

from test_viz_heterogeneity import _contrast_frame

DV = "CMC_Flexor"
CONDITIONS = {"lvl_1": ("Category or Silence", ["Happy", "Sad"])}
ATTRS = ["Musical skill", "Age"]


def _personal(n, seed=1):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "Subject_ID": range(n),
        "Musical skill": rng.integers(0, 7, n).astype(float),
        "Age": rng.integers(20, 60, n).astype(float)})


def _influence(n, seed=1):
    rng = np.random.default_rng(seed + 10)
    return pd.DataFrame({
        "Subject_ID": list(range(n)) * 2,
        "Dependent_Variable": [DV] * 2 * n,
        "Parameter": ["A"] * n + ["B"] * n,
        "N_Segments": [1] * n + [2] * n,
        "CooksD": rng.random(2 * n),
        "DFBETA": rng.standard_normal(2 * n)})


def _coefficients(p_b=0.2):
    return pd.DataFrame({
        "Dependent_Variable": [DV, DV], "Model_Type": ["LME", "LME"],
        "Parameter": ["A", "B"], "p_value_adjusted": [0.01, p_b]})


def _same_frames(got, want):
    assert isinstance(got, pd.DataFrame) and isinstance(want, pd.DataFrame)
    pd.testing.assert_frame_equal(got, want)


def _names(directory, pattern):
    return sorted(p.name[20:] for p in directory.glob(pattern))


@pytest.mark.parametrize("n", [8, 3])
def test_responder_summary_matches_jax(n):
    frame = _contrast_frame(n)
    conditions = {"lvl_1": ("Category or Silence", ["Happy", "Sad", "Gone"])}
    got = TH.compute_responder_summary(frame, [DV, "Missing"], conditions)
    _same_frames(got, JH.compute_responder_summary(frame, [DV, "Missing"],
                                                   conditions))
    assert got["N_Subjects"].tolist() == [n, n, 0, 0, 0, 0]


@pytest.mark.parametrize("n,analyse_dfbetas,primary", [
    (10, True, None), (10, False, 1), (12, True, 2), (3, True, None)])
def test_mi_results_match_jax(n, analyse_dfbetas, primary):
    """sklearn's MI estimators are seeded (``random_state=42``), so the
    scores are equal to the bit.  Three subjects give no MI row."""
    args = ([DV], _influence(n), _contrast_frame(n), _coefficients(),
            _personal(n), ATTRS, CONDITIONS, [])
    kw = dict(analyse_dfbetas=analyse_dfbetas, primary_n_segments=primary)
    got = TH.compute_mi_results(*args, **kw)
    _same_frames(got, JH.compute_mi_results(*args, **kw))
    if n >= 4:
        assert {"CooksD", "Responder_Flag", "Normalised_Contrast"} <= \
            set(got["Target"])
        assert ("DFBETA" in set(got["Target"])) == (analyse_dfbetas
                                                     and primary is None)
    else:
        assert got.empty


def test_mi_results_without_attributes_or_influence():
    n = 8
    args = ([DV, "CMC_Other"], _influence(n), _contrast_frame(n),
            _coefficients(), _personal(n), [], CONDITIONS, [])
    with pytest.warns(UserWarning, match="No influence data"):
        got = TH.compute_mi_results(*args)
    with pytest.warns(UserWarning, match="No influence data"):
        want = JH.compute_mi_results(*args)
    _same_frames(got, want)
    assert got.empty


@pytest.mark.parametrize("min_score", [0.0, 0.05, 10.0])
def test_mi_summary_matches_jax(min_score):
    n = 12
    mi = JH.compute_mi_results(
        [DV], _influence(n), _contrast_frame(n), _coefficients(),
        _personal(n), ATTRS, CONDITIONS, [])
    if min_score == 10.0:
        with pytest.warns(UserWarning, match="No scores"):
            got = TH.build_mi_summary(mi, min_score)
    else:
        got = TH.build_mi_summary(mi, min_score)
    _same_frames(got, JH.build_mi_summary(mi, min_score))
    if min_score == 0.0:
        assert got["Moderating_Candidates"].str.len().min() > 0
        assert list(got.columns[:2]) == ["Condition", "Target"]
    with pytest.warns(UserWarning, match="No MI scores"):
        assert TH.build_mi_summary(pd.DataFrame()).empty


@pytest.mark.parametrize("scores", [
    [0.1, 0.5, 0.9, 0.3, 0.7, 0.2], [0.4, 0.4, 0.4], [0.0, 1.0],
    [0.2, 0.2, 0.2, 0.9]])
def test_tercile_band_matches_jax(scores):
    grp = pd.DataFrame({"MI_Score": scores},
                       index=pd.Index([3 * i for i in range(len(scores))]))
    got = TH._assign_tercile_band(grp)
    pd.testing.assert_series_equal(got, JH._assign_tercile_band(grp))
    assert set(got) <= {"High", "Medium", "Low"}


def _combined_inputs(n=10):
    contrast = _contrast_frame(n)
    influence = _influence(n)
    sig = _coefficients().loc[lambda d: d["p_value_adjusted"] < 0.05,
                              ["Dependent_Variable", "Parameter"]]
    return influence, contrast, sig


@pytest.mark.parametrize("measures", [
    ["contrast", "cooks_d"], ["dfbeta"], ["contrast", "cooks_d", "dfbeta"],
    []])
def test_combined_pivot_matches_jax(measures):
    influence, contrast, sig = _combined_inputs()
    args = (influence, contrast, [DV], sig, CONDITIONS, measures)
    got = TH.build_combined_pivot(*args)
    _same_frames(got, JH.build_combined_pivot(*args))
    if measures:
        assert got.shape[0] == 10 and got.shape[1] >= 1
        np.testing.assert_allclose(got.mean().to_numpy(), 0.0, atol=1e-12)


def test_sort_pivot_columns_matches_jax():
    cols = ["Contrast│F│Sad", "DFBETA│F│A", "CooksD│F", "Contrast│F│Happy",
            "Other", "DFBETA│E│A"]
    df = pd.DataFrame(np.arange(12.0).reshape(2, 6), columns=cols)
    got = TH._sort_pivot_columns(df)
    _same_frames(got, JH._sort_pivot_columns(df))
    assert list(got.columns[:2]) == ["DFBETA│E│A", "DFBETA│F│A"]


def _two_groups(seed, n_each, spread=0.2, width=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, spread, (n_each, width)),
                           rng.normal(5, spread, (n_each, width))])


@pytest.mark.parametrize("min_size,k_range", [
    (3, range(2, 5)), (1, range(2, 6)), (7, range(2, 5))])
def test_select_best_k_matches_jax(min_size, k_range):
    """The constraint: a k is scored only if every cluster holds at least
    ``min_size`` subjects; none qualifying falls back to k = 2 with a
    warning and no scores."""
    X = _two_groups(3, 6)
    if min_size == 7:
        with pytest.warns(UserWarning, match="Falling back"):
            got = TH.select_best_k(X, k_range, min_size)
        with pytest.warns(UserWarning, match="Falling back"):
            want = JH.select_best_k(X, k_range, min_size)
    else:
        got = TH.select_best_k(X, k_range, min_size)
        want = JH.select_best_k(X, k_range, min_size)
    assert got == want
    best_k, scores = got
    assert best_k == 2
    if min_size == 3:
        assert all(k not in scores or scores[k] <= scores[2] for k in (3, 4))
    if min_size == 7:
        assert scores == {}
    if min_size == 1:
        assert sorted(scores) == list(k_range)


def test_clustering_matches_jax(tmp_path):
    X = _two_groups(2, 5, spread=0.3, width=4)
    pivot = pd.DataFrame(X, index=pd.Index(range(10), name="Subject_ID"),
                         columns=[f"Contrast│F│c{i}" for i in range(4)])
    personal = pd.DataFrame({"Subject_ID": range(10),
                             "Age": range(20, 30)})
    out = {}
    for name, module in (("port", TH), ("jax", JH)):
        d = tmp_path / name
        d.mkdir()
        out[name] = module.run_clustering(
            pivot, personal, ["contrast"], [DV], min_cluster_size=2,
            output_dir=d, rename_dict={"Contrast│F│c0": "first"})
    _same_frames(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    for pattern in ("*.csv", "*.png"):
        assert _names(tmp_path / "port", pattern) == \
            _names(tmp_path / "jax", pattern)
    for name in ("Heterogeneity Subject Clusters",
                 "Heterogeneity Silhouette Scores"):
        got, want = (filemgmt.most_recent_file(tmp_path / k, ".csv", [name])
                     .read_text() for k in ("port", "jax"))
        assert got == want
    assert _names(tmp_path / "port", "*.png") == [
        "Heterogeneity Combined Clustering.png"]
    g0 = set(out["port"][0].loc[out["port"][0]["Cluster"] == 0,
                                "Subject_ID"])
    assert g0 in ({0, 1, 2, 3, 4}, {5, 6, 7, 8, 9})


def _write_study(root, n, seed=0):
    """Questionnaires of ``n`` subjects whose musical skill drives their
    contrast, and the omnibus CSVs the entry point reads."""
    rng = np.random.default_rng(seed)
    exp = root / "experiment_results"
    omnibus = root / "omnibus"
    omnibus.mkdir(parents=True)
    skill = rng.integers(0, 8, n)
    for s in range(n):
        sub = exp / f"subject_{s:02}"
        sub.mkdir(parents=True)
        (sub / filemgmt.file_title("Subject Data", ".json")).write_text(
            json.dumps({"Name": "Anonymous", "Birthdate": "2000-01-01",
                        "Gender": ["Female", "Male"][s % 2],
                        "Dominant hand": ["Right", "Left"][s % 3 == 0],
                        "Listening habit": ["Most of the day", "Seldom"][
                            s % 2],
                        "Dancing habit": int(rng.integers(0, 8)),
                        "Musical skill": int(skill[s])}))
        (sub / filemgmt.file_title("Post-Study Feedback Data", ".json")
         ).write_text(json.dumps({"Total fatigue": int(rng.integers(1, 6))}))
    dvs = ["CMC_Flexor_max_beta", "CMC_Extensor_max_beta"]
    rows = []
    for dv in dvs:
        for s in range(n):
            for cond in ("Happy", "Sad"):
                c = 0.1 * skill[s] - 0.3 + rng.normal(0, 0.05)
                c = c if cond == "Happy" else -c
                rows.append({"Hypothesis": f"H {dv}", "Dependent_Variable": dv,
                             "Subject ID": s, "Comparison_Level": "Level 1",
                             "Condition_Variable": "Category or Silence",
                             "Condition": cond, "Responder_Flag": c > 0,
                             "Normalised_Contrast": c})
    pd.DataFrame(rows).to_csv(omnibus / filemgmt.file_title(
        "Subject Effect Summary Combined", ".csv"), index=False)
    pd.DataFrame([{"Dependent_Variable": dv, "Subject_ID": s,
                   "Parameter": p, "N_Segments": 1,
                   "CooksD": float(rng.random() + 0.05 * skill[s]),
                   "DFBETA": float(rng.normal(0.1 * skill[s], 0.1))}
                  for dv in dvs for s in range(n) for p in ("A", "B")]
                 ).to_csv(omnibus / filemgmt.file_title(
                     "Influence Analysis Combined", ".csv"), index=False)
    pd.DataFrame([{"Dependent_Variable": dv, "Model_Type": m,
                   "Parameter": p, "p_value_adjusted": pv}
                  for dv in dvs for m in ("LME", "OLS")
                  for p, pv in (("A", 0.001), ("B", 0.3))]
                 ).to_csv(omnibus / filemgmt.file_title(
                     "All Time Resolutions Results", ".csv"), index=False)
    return exp, omnibus, dvs


@pytest.mark.parametrize("n,measures,exclude", [
    (12, ["contrast", "cooks_d"], None),
    (12, ["dfbeta", "contrast"], [3, 7]),
    (4, ["contrast", "cooks_d"], None),
    (5, ["contrast", "cooks_d"], [0, 1]),
    (3, ["contrast", "cooks_d"], None)])
def test_run_heterogeneity_modelling_matches_jax(tmp_path, n, measures,
                                                 exclude):
    """The entry point on the omnibus CSVs and the subjects'
    questionnaires: every CSV byte for byte, the same figures.
    ``exclude_subjects`` drops subjects from the personal data only, as
    in the JAX package; three subjects stop before the clustering."""
    exp, omnibus, dvs = _write_study(tmp_path, n)
    kw = dict(dep_vars=dvs, conditions_to_evaluate=CONDITIONS,
              clustering_measures=measures, plot_mi_categories=[],
              top_n_moderators=2, min_cluster_size=2,
              omnibus_results_dir=omnibus, experiment_results_dir=exp,
              exclude_subjects=exclude)
    import warnings
    for name, module in (("port", TH), ("jax", JH)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            module.run_heterogeneity_modelling(output_dir=tmp_path / name,
                                               **kw)
        skipped = any("Insufficient data" in str(w.message) for w in caught)
        assert skipped == (n < 4)
    for pattern in ("*.csv", "*.png"):
        assert _names(tmp_path / "port", pattern) == \
            _names(tmp_path / "jax", pattern)
    for path in sorted((tmp_path / "port").glob("*.csv")):
        want = filemgmt.most_recent_file(tmp_path / "jax", ".csv",
                                         [path.name[20:-4]])
        assert path.read_text() == want.read_text(), path.name
    pngs = _names(tmp_path / "port", "*.png")
    assert ("Heterogeneity Combined Clustering.png" in pngs) == (n >= 4)
    if n == 12:
        summary = pd.read_csv(filemgmt.most_recent_file(
            tmp_path / "port", ".csv", ["Heterogeneity MI Summary"]))
        assert len(summary) > 0
        assert any(p.startswith("Scatter ") for p in pngs)
