"""``mba_tpu_torch.pipeline.statistical_modelling`` and the statistics
workflows against ``mba_tpu``'s on the CPU.

The host fits, FDR, the level runner and the LOSO influence are copies of
the JAX package's numpy code: their frames are equal.  The power grid's
simulations are the same numpy draws from the same seed, refit by the
float32 batched REML on either side: a power may move by at most
``POWER_DIFF_SIMS`` simulations whose p-value sits within rounding of α.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from mba_tpu.pipeline import statistical_modelling as J
from mba_tpu.workflows import statistics_RQ_A_omnibus_testing_workflow as JA
from mba_tpu.workflows import statistics_RQ_B_omnibus_testing_workflow as JB
from mba_tpu_torch.pipeline import statistical_modelling as T
from mba_tpu_torch.workflows import \
    statistics_RQ_A_omnibus_testing_workflow as TA
from mba_tpu_torch.workflows import \
    statistics_RQ_B_omnibus_testing_workflow as TB

from test_pipeline_statistics import LEVEL_DEFS, make_stats_frame

torch.set_num_threads(1)

POWER_DIFF_SIMS = 2
HAPPY = "C(Q('Category or Silence'))[T.Happy]"
CSV = "2024-01-01 10_00_00 Combined Statistics {}seg.csv"


def _levels(package, df, **kw):
    results, diags = [], []
    package.run_model_levels(df, LEVEL_DEFS, "CMC_Flexor_max_beta", "H2", 1,
                             results, diags, verbose=False, **kw)
    frame = pd.DataFrame(results)
    frame["N. Segments"] = 1
    return frame, pd.DataFrame(diags)


def _feature_dir(tmp_path, frames: dict):
    feature_dir = tmp_path / "features"
    feature_dir.mkdir()
    for n_seg, df in frames.items():
        df.to_csv(feature_dir / CSV.format(n_seg), index=False)
    return feature_dir


def test_fit_both_models_matches_jax():
    df = make_stats_frame()
    kw = dict(reference_categories={"Category or Silence": "Silence"},
              verbose=False)
    args = (df, "CMC_Flexor_max_beta", {"Category or Silence": "categorical"},
            ["Median Force Level [0-1]"], "Level 0", "H2")
    port, ref = T.fit_both_models(*args, **kw), J.fit_both_models(*args, **kw)
    for model in ("OLS", "LME"):
        pd.testing.assert_frame_equal(port[model]["results_df"],
                                      ref[model]["results_df"])
        assert port[model]["diagnostics"] == ref[model]["diagnostics"]


def test_run_model_levels_and_fdr_match_jax():
    df = make_stats_frame()
    port, port_diag = _levels(T, df)
    ref, ref_diag = _levels(J, df)
    pd.testing.assert_frame_equal(port, ref)
    pd.testing.assert_frame_equal(port_diag, ref_diag)
    pd.testing.assert_frame_equal(
        T.apply_fdr_correction(port, levels_to_correct=[1]),
        J.apply_fdr_correction(ref, levels_to_correct=[1]))


def test_loso_influence_matches_jax(tmp_path):
    df = make_stats_frame(n_subj=6, n_trials=9)
    feature_dir = _feature_dir(tmp_path, {1: df})
    full, _ = _levels(T, df)
    out = {}
    for name, package in (("port", T), ("ref", J)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        out[name] = package.run_influence_analysis(
            [("CMC_Flexor_max_beta", 0, 1)], full, feature_dir, out_dir,
            fetch_level_definitions=lambda multi: LEVEL_DEFS)
    pd.testing.assert_frame_equal(out["port"], out["ref"])
    assert len(list((tmp_path / "port").glob(
        "*Influence Analysis Combined.csv"))) == 1


def test_power_grid_matches_jax(tmp_path):
    """The same seed gives the same simulations on both sides; the
    powers agree within POWER_DIFF_SIMS simulations, and the MDE rows
    where the powers agree."""
    df = make_stats_frame(n_subj=10, n_trials=12, effect=0.8)
    feature_dir = _feature_dir(tmp_path, {1: df})
    full, _ = _levels(T, df, levels_to_include=[0])
    cfg = T.PowerConfig("CMC_Flexor_max_beta", comp_lvl=0, n_segments=1,
                        target_parameters=[], n_simulations=100,
                        effect_multipliers=[0.25, 1.0, 2.0])
    kw = dict(fetch_level_definitions=lambda multi: LEVEL_DEFS)
    diag = {}
    port_mde, port_curve = T.run_power_analysis(
        [cfg], full, feature_dir, tmp_path, device="cpu", diagnostics=diag,
        **kw)
    ref_mde, ref_curve = J.run_power_analysis(
        [J.PowerConfig(**vars(cfg))], full, feature_dir, tmp_path, **kw)
    assert diag["n_jobs"] == len(port_curve) == 9     # 3 effects × 3
    assert diag["n_refits"] == 900 and diag["n_nan_pvalues"] == 0
    assert len(diag["solve_sec"]) == 1
    same = ["Dependent_Variable", "Parameter", "Effect_Multiplier",
            "Fitted_Coefficient", "Absolute_Effect"]
    pd.testing.assert_frame_equal(port_curve[same], ref_curve[same])
    diff = np.abs(port_curve["Power"] - ref_curve["Power"]).max()
    assert diff <= POWER_DIFF_SIMS / cfg.n_simulations
    assert port_curve.loc[port_curve["Parameter"] == HAPPY,
                          "Power"].iloc[-1] > 0.9
    pd.testing.assert_frame_equal(port_mde[same[:2]], ref_mde[same[:2]])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_power_grid_warns_on_nan_pvalues(package):
    """Fault C4: NaN p-values count as non-rejections and would zero the
    power without an error, so > 1 % of them warns.  An all-zero design
    column makes every refit's X'X singular."""
    rng = np.random.default_rng(0)
    subj_idx = np.repeat(np.arange(6), 8)
    design = np.column_stack([np.ones(48), rng.standard_normal(48),
                              np.zeros(48)])
    gen = {"fixed_effects": {"Intercept": 1.0, "x": 0.5, "z": 0.0},
           "residual_std": 1.0, "re_std": 0.5}
    args = (gen, design, ["Intercept", "x", "z"], subj_idx, [("x", 1.0)],
            20, 0.05, rng)
    with pytest.warns(UserWarning, match="NaN"):
        if package == "port":
            powers = T._simulate_jobs_and_fit(*args, device="cpu")
        else:
            powers = J._simulate_jobs_and_fit(*args)
    assert powers == [0.0]


# ---- the omnibus workflows ------------------------------------------------

def make_omnibus_frame(n_segments, n_subj=6, n_trials=10, seed=0):
    """A "Combined Statistics Nseg" frame with every column the RQ-A and
    RQ-B levels read, a planted Happy effect on the CMC DVs."""
    rng = np.random.default_rng(seed + n_segments)
    cats = ["Silence", "Happy", "Groovy", "Sad", "Classic"]
    rows = []
    skill, dancing = rng.integers(0, 8, (2, n_subj)).astype(float)
    for s in range(n_subj):
        for t in range(n_trials):
            cat = cats[t % len(cats)]
            for seg in range(n_segments):
                base = 0.9 + (0.05 if cat == "Happy" else 0.0)
                rows.append({
                    "Subject ID": s, "Trial ID": t, "Segment ID": seg,
                    "Category or Silence": cat,
                    "Music Listening": cat != "Silence",
                    "Perceived Category": cats[1 + (s + t) % 4],
                    "Familiarity [0-7]": int(rng.integers(0, 8)),
                    "Liking_centered_squared": rng.uniform(0, 4),
                    "Spectral Centroid Mean": rng.uniform(1e3, 3e3),
                    "Spectral Flux Std.": rng.uniform(0, 1),
                    "IOI Variance Coeff": rng.uniform(0, 1),
                    "Musical skill [0-7]_centered": skill[s] - skill.mean(),
                    "Dancing habit [0-7]_centered":
                        dancing[s] - dancing.mean(),
                    "Median Unscaled Force [% MVC]": rng.uniform(20, 60),
                    "Median Scaled Force [0-1]": rng.uniform(0, 1),
                    "Task Frequency": rng.choice([0.5, 1.0]),
                    "CMC_Flexor_max_beta": base + rng.normal(0, 0.02),
                    "CMC_Extensor_max_beta": base + rng.normal(0, 0.02),
                    "CMC_Flexor_max_gamma": 0.8 + rng.normal(0, 0.02),
                    "CMC_Extensor_max_gamma": 0.8 + rng.normal(0, 0.02),
                    "PSD_eeg_FC_CP_T_theta": rng.normal(-11, 0.3),
                    "PSD_eeg_F_C_beta": rng.normal(-12, 0.3),
                    "PSD_eeg_P_PO_alpha": rng.normal(-11.5, 0.3),
                    "RMS_Accuracy": rng.uniform(0.05, 0.3)})
    return pd.DataFrame(rows)


RQA_HYPS = [("H1: Flexor Beta Peak CMC", "CMC_Flexor_max_beta"),
            ("H2: Fronto-Central Theta PSD", "PSD_eeg_FC_CP_T_theta")]


@pytest.mark.parametrize("mosaics", [False, True])
def test_rqa_omnibus_matches_jax(tmp_path, mosaics):
    feature_dir = _feature_dir(tmp_path, {n: make_omnibus_frame(n)
                                          for n in (1, 2)})
    out = {}
    for name, workflow in (("port", TA), ("ref", JA)):
        out[name] = workflow.run_omnibus(
            feature_dir, tmp_path / name, n_within_trial_segments_list=(1, 2),
            hypotheses=RQA_HYPS, make_forest_mosaics=mosaics)
    pd.testing.assert_frame_equal(out["port"], out["ref"])
    assert out["port"]["p_value_fdr"].notna().any()
    figures = {name: sorted(p.name[20:] for p in (tmp_path / name).glob(
        "*.png")) for name in out}
    assert figures["port"] == figures["ref"]
    assert len(figures["port"]) == (2 if mosaics else 0)


def test_rqb_omnibus_matches_jax(tmp_path):
    feature_dir = _feature_dir(tmp_path, {n: make_omnibus_frame(n)
                                          for n in (1, 2)})
    port = TB.run_rqb_omnibus(feature_dir, tmp_path / "port", (1, 2))
    ref = JB.run_rqb_omnibus(feature_dir, tmp_path / "ref", (1, 2))
    pd.testing.assert_frame_equal(port, ref)
    assert set(port["Model_Type"]) == {"OLS", "LME"}


def test_study_paths_match_jax(tmp_path):
    """The workflows' ``__main__`` layout: the same directories."""
    from mba_tpu.workflows.paths import StudyPaths as JPaths
    from mba_tpu_torch.workflows.paths import StudyPaths as TPaths
    port, ref = TPaths(tmp_path / "port").ensure(), JPaths(tmp_path / "ref")
    for name in ("data", "experiment_data", "feature_data",
                 "song_characteristics", "output", "statistics_rq_a",
                 "statistics_rq_a_post_hoc", "statistics_rq_b", "reports"):
        assert (getattr(port, name).relative_to(port.root)
                == getattr(ref, name).relative_to(ref.root))
    assert port.subject_feature_dir(3).name == ref.subject_feature_dir(3).name
    assert port.statistics_rq_b.is_dir()
