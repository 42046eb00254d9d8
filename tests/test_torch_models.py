"""``mba_tpu_torch.models`` against ``mba_tpu.models`` on the CPU.

The host copies (formula, OLS, FDR, the host REML fit) run the JAX
package's numpy code, so their results are equal.  The batched REML
solvers run in float32 on both sides with sums in other orders (torch's
matmuls and ``index_add_`` against XLA's), so where the criterion is flat
the grid can settle on a neighbouring ln λ: β is held within
``BETA_SE`` of its SE and SE and scale within ``RTOL``, the JAX package's
own batched-against-host tolerance (tests/test_models.py:161-166).  At
the designs ``chip_smoke.py`` holds the card to (an intercept of ~0.9,
effects ~1e-2 of it, p = 7 and 17) each float32 solve lies a few 1e-3
SE from the float64 host fit, so β is held within the bound of that card
check there.
"""
import numpy as np
import pandas as pd
import pytest
import torch
from scipy import stats

import jax.numpy as jnp

from mba_tpu.models import fdr as J_fdr
from mba_tpu.models import formula as J_formula
from mba_tpu.models import lme as J_lme
from mba_tpu.models import ols as J_ols
from mba_tpu_torch.models import fdr as T_fdr
from mba_tpu_torch.models import formula as T_formula
from mba_tpu_torch.models import lme as T_lme
from mba_tpu_torch.models import ols as T_ols

import chip_smoke
from test_models import _frame
from test_stats_golden import GOLDEN_TOLERANCES, PINNED, _fixture

torch.set_num_threads(1)

BETA_SE = 2e-3      # |Δβ| / SE
RTOL = 2e-3         # SE, scale
WEIGHTED_SD = 1e-2  # |Δβ| / spread of β over the resamples
# a float32 grid solve against the float64 host fit at chip_smoke.py's
# designs: 4.3-5.8e-3 SE for the JAX package, 5.2-6.0e-3 for the port
HOST_SE, HOST_ROWS = 7.5e-3, 48

LEVEL = dict(condition_vars={"Category or Silence": "categorical",
                             "Ord": "ordinal"},
             explanatory_vars=["Median Force Level [0-1]"],
             moderation_pairs=[("Category or Silence", "Skill")],
             reference_categories={"Category or Silence": "Silence"})


def _level_frame():
    df = _frame(n_subj=6, n_per=9)
    rng = np.random.default_rng(1)
    df["Ord"] = rng.integers(0, 8, len(df))
    df["Skill"] = rng.standard_normal(6)[df["Subject ID"]]
    return df


def _design(n_subj=12, n_per=10, seed=0):
    rng = np.random.default_rng(seed)
    n = n_subj * n_per
    groups = np.repeat(np.arange(n_subj), n_per)
    X = np.column_stack([np.ones(n), rng.standard_normal(n),
                         rng.uniform(20, 60, n),
                         np.tile(np.arange(n_per), n_subj)])
    return X, groups, rng


def _responses(X, groups, rng, S):
    n_subj = groups.max() + 1
    return (0.9 + 0.01 * X[:, 1] + rng.normal(0, 0.02, (S, n_subj))[:, groups]
            + rng.normal(0, 0.03, (S, len(groups))))


def _close_fits(port, ref, beta_se=BETA_SE, rtol=RTOL):
    assert np.isfinite(port["beta"]).all()
    assert np.max(np.abs(port["beta"] - ref["beta"]) / ref["bse"]) <= beta_se
    np.testing.assert_allclose(port["bse"], ref["bse"], rtol=rtol)
    np.testing.assert_allclose(port["scale"], ref["scale"], rtol=rtol)


# ---- host copies: equal --------------------------------------------------

def test_formula_matches_jax():
    df = _level_frame()
    Xp, names_p = T_formula.build_design_matrix(df, **LEVEL)
    Xj, names_j = J_formula.build_design_matrix(df, **LEVEL)
    assert names_p == names_j
    np.testing.assert_array_equal(Xp, Xj)
    args = ("DV", LEVEL["condition_vars"], LEVEL["explanatory_vars"],
            LEVEL["moderation_pairs"])
    assert T_formula.build_formula(*args) == J_formula.build_formula(*args)


def test_ols_and_fdr_match_jax():
    df = _level_frame()
    X, _ = T_formula.build_design_matrix(df, **LEVEL)
    port, ref = (m.fit_ols(X, df["DV"].to_numpy()) for m in (T_ols, J_ols))
    for key in ref:
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    p = np.random.default_rng(2).uniform(0, 0.2, 40)
    for a, b in zip(T_fdr.benjamini_hochberg(p), J_fdr.benjamini_hochberg(p)):
        np.testing.assert_array_equal(a, b)


def test_host_reml_matches_jax_and_the_golden_pins():
    X, y, groups = _fixture()
    port = T_lme.fit_random_intercept_reml(X, y, groups, ["c", "x1", "x2"])
    ref = J_lme.fit_random_intercept_reml(X, y, groups, ["c", "x1", "x2"])
    for key in ("params", "bse", "pvalues", "scale", "cov_re", "llf"):
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    tol = GOLDEN_TOLERANCES
    np.testing.assert_allclose(port["params"], PINNED["beta"],
                               atol=tol["beta"])
    np.testing.assert_allclose(port["bse"], PINNED["bse"], atol=tol["bse"])
    np.testing.assert_allclose(port["zvalues"], PINNED["z"], atol=tol["z"])
    np.testing.assert_allclose(port["pvalues"], PINNED["p"], atol=tol["p"])
    assert port["cov_re"] == pytest.approx(PINNED["sigma_b2"],
                                           abs=tol["sigma_b2"])
    assert port["scale"] == pytest.approx(PINNED["sigma_e2"],
                                          abs=tol["sigma_e2"])
    assert port["llf"] == pytest.approx(PINNED["llf"], abs=tol["llf"])


def test_host_reml_balanced_closed_form():
    """tests/test_stats_golden.py's closed forms: intercept-only balanced
    one-way REML equals the ANOVA estimators."""
    rng = np.random.default_rng(3)
    J, m = 8, 6
    groups = np.repeat(np.arange(J), m)
    y = 2.0 + rng.normal(0, 0.9, J)[groups] + rng.normal(0, 1.3, J * m)
    fit = T_lme.fit_random_intercept_reml(np.ones((J * m, 1)), y, groups)
    gm = y.reshape(J, m).mean(axis=1)
    msb = m * ((gm - y.mean()) ** 2).sum() / (J - 1)
    msw = ((y.reshape(J, m) - gm[:, None]) ** 2).sum() / (J * (m - 1))
    assert fit["scale"] == pytest.approx(msw, rel=1e-6)
    assert fit["cov_re"] == pytest.approx(max((msb - msw) / m, 0), rel=1e-5)
    assert fit["bse"][0] == pytest.approx(np.sqrt(msb / (J * m)), rel=1e-6)


# ---- the batched device path on the CPU ----------------------------------

def test_batched_reml_core_matches_jax():
    X, groups, rng = _design()
    Y = _responses(X, groups, rng, 300).astype(np.float32)
    Xs = (X / np.abs(X).max(0)).astype(np.float32)
    _, gidx = np.unique(groups, return_inverse=True)
    counts = np.bincount(gidx).astype(np.float32)
    port = T_lme._batched_reml_core(
        torch.from_numpy(Xs), torch.from_numpy(Y),
        torch.from_numpy(gidx.astype(np.int64)), torch.from_numpy(counts),
        n_groups=len(counts))
    ref = J_lme._batched_reml_core(jnp.asarray(Xs), jnp.asarray(Y),
                                   jnp.asarray(gidx.astype(np.int32)),
                                   jnp.asarray(counts), n_groups=len(counts))
    port = dict(zip(("beta", "bse", "scale", "lam"),
                    (t.numpy() for t in port)))
    ref = dict(zip(("beta", "bse", "scale", "lam"), map(np.asarray, ref)))
    _close_fits(port, ref)


def test_batched_lme_pvalues_matches_jax_and_the_host_fit():
    """Against the JAX package's batched solve, and against the host Brent
    fit at rtol 2e-3 (tests/test_models.py:151-166)."""
    X, groups, rng = _design(n_subj=8, n_per=12, seed=5)
    Y = _responses(X, groups, rng, 64)
    port = T_lme.batched_lme_pvalues(X, Y, groups, device="cpu")
    ref = J_lme.batched_lme_pvalues(X, Y, groups)
    _close_fits(port, ref)
    np.testing.assert_allclose(port["pvalues"], ref["pvalues"], atol=2e-3)
    for s in range(3):
        host = T_lme.fit_random_intercept_reml(X, Y[s], groups)
        np.testing.assert_allclose(port["beta"][s], host["params"],
                                   rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(port["bse"][s], host["bse"], rtol=5e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(port["scale"][s], host["scale"],
                                   rtol=5e-3)


def _card_check_problem(name):
    """The designs ``chip_smoke.py`` holds the card to: the p = 7 design of
    its small card-against-CPU check, and the RQ-A Level-1 design (p = 17)
    of its power grid with responses as the grid simulates them."""
    if name == "small":
        return chip_smoke.reml_small_problem(np.random.default_rng(5))
    design, _, groups = chip_smoke.level1_design(
        chip_smoke.make_statistics_frame())
    rng = np.random.default_rng(0)
    S, G = chip_smoke.REML_SMALL, groups.max() + 1
    Y = (0.9 + rng.normal(0, chip_smoke.STAT_SUBJECT_SD, (S, G))[:, groups]
         + rng.normal(0, chip_smoke.STAT_RESID_SD, (S, len(groups))))
    return design, Y, groups


@pytest.mark.parametrize("name", ["small", "level1"])
def test_batched_reml_at_the_card_checks_designs(name):
    """At the designs chip_smoke.py checks on the card, with an intercept
    of ~0.9 and effects ~1e-2 of it: the port within
    ``chip_smoke.REML_BETA_SE`` of the JAX package's β (the bound of the
    card-against-CPU check, two float32 solves of one design), and both
    within HOST_SE of the float64 host fit on the first rows."""
    X, Y, groups = _card_check_problem(name)
    port = T_lme.batched_lme_pvalues(X, Y, groups, device="cpu")
    ref = J_lme.batched_lme_pvalues(X, Y, groups)
    _close_fits(port, ref, beta_se=chip_smoke.REML_BETA_SE,
                rtol=chip_smoke.REML_RTOL)
    host = [T_lme.fit_random_intercept_reml(X, Y[s], groups)
            for s in range(HOST_ROWS)]
    beta = np.array([h["params"] for h in host])
    bse = np.array([h["bse"] for h in host])
    for fit in (port, ref):
        assert np.max(np.abs(fit["beta"][:HOST_ROWS] - beta) / bse) <= HOST_SE


def test_batched_path_matches_the_golden_fixture():
    """tests/test_stats_golden.py:213: the batched solve against the host
    fit (hence the pinned oracle) on the frozen data."""
    X, y, groups = _fixture()
    host = T_lme.fit_random_intercept_reml(X, y, groups)
    dev = T_lme.batched_lme_pvalues(X, np.tile(y, (3, 1)), groups,
                                    device="cpu")
    for s in range(3):
        np.testing.assert_allclose(
            dev["beta"][s], host["params"],
            atol=GOLDEN_TOLERANCES["batched_vs_host_beta"])
        np.testing.assert_allclose(
            dev["bse"][s], host["bse"],
            atol=GOLDEN_TOLERANCES["batched_vs_host_bse"])


def test_non_pd_design_gives_nan_pvalues_as_jax():
    """An all-zero column makes X'X singular: the JAX package's solve
    gives non-finite values, the port's Cholesky maps its failure to NaN;
    every p-value is NaN in both."""
    X, groups, rng = _design(n_subj=6, n_per=8)
    X[:, 2] = 0.0
    Y = _responses(X, groups, rng, 16)
    port = T_lme.batched_lme_pvalues(X, Y, groups, device="cpu")
    ref = J_lme.batched_lme_pvalues(X, Y, groups)
    assert np.isnan(ref["pvalues"]).all()
    assert np.isnan(port["pvalues"]).all()


def test_blocks_of_8192_responses_cross_cleanly():
    """S = 8 200 responses of a tiny design (n = 8): two blocks, the
    second of 8 rows.  Rows are independent, so a row's fit does not
    depend on its block; the whole matches the JAX package's."""
    rng = np.random.default_rng(6)
    groups = np.repeat(np.arange(2), 4)
    X = np.column_stack([np.ones(8), rng.standard_normal(8)])
    Y = 1.0 + rng.standard_normal((T_lme._REML_BLOCK + 8, 8))
    diag = {}
    port = T_lme.batched_lme_pvalues(X, Y, groups, device="cpu",
                                     diagnostics=diag)
    assert len(diag["solve_sec"]) == 2
    assert set(diag) == {"upload_sec", "solve_sec", "download_sec"}
    tail = T_lme.batched_lme_pvalues(X, Y[-8:], groups, device="cpu")
    for key in ("beta", "bse", "scale"):
        np.testing.assert_allclose(port[key][-8:], tail[key], rtol=1e-5,
                                   err_msg=key)
    ref = J_lme.batched_lme_pvalues(X, Y, groups)
    finite = np.isfinite(ref["bse"]).all(1) & (ref["bse"] > 0).all(1)
    assert finite.mean() > 0.99
    d = np.abs(port["beta"] - ref["beta"])[finite] / ref["bse"][finite]
    assert np.quantile(d, 0.99) <= BETA_SE


def test_weighted_reml_matches_jax_with_zero_weight_rows():
    """The bootstrap's solver on B = 200 padded designs with 20 % absent
    rows: β within WEIGHTED_SD of β's spread over the resamples (a
    percentile CI moves by < 1 % of its width)."""
    rng = np.random.default_rng(3)
    B, G, m = 200, 12, 12
    n = G * m
    gidx = np.repeat(np.arange(G), m)
    x = (rng.random((B, n)) < 0.5).astype(np.float32)
    med = (0.5 * x + rng.normal(0, 0.5, (B, n))
           + rng.normal(0, 0.3, (B, G))[:, gidx]).astype(np.float32)
    y = (0.9 + 0.01 * x + 0.02 * med + rng.normal(0, 0.02, (B, n))
         + rng.normal(0, 0.01, (B, G))[:, gidx]).astype(np.float32)
    w = (rng.random((B, n)) > 0.2).astype(np.float32)
    Xb = np.stack([np.ones_like(x), x, med], 2)
    ref = np.asarray(J_lme._batched_reml_weighted(
        jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w),
        jnp.asarray(gidx.astype(np.int32)), n_groups=G))
    port = T_lme._batched_reml_weighted(
        *(torch.from_numpy(a) for a in (Xb, y, w, gidx.astype(np.int64))),
        n_groups=G).numpy()
    assert np.isfinite(port).all()
    assert np.max(np.abs(port - ref) / ref.std(0)) <= WEIGHTED_SD


def test_null_pvalues_are_calibrated():
    """tests/test_models.py:206 on the port: under the null the p-values
    are uniform and the type-I error is α within binomial tolerance."""
    rng = np.random.default_rng(0)
    n_sims, n_subj, n_per = 400, 12, 10
    n = n_subj * n_per
    groups = np.repeat(np.arange(n_subj), n_per)
    X = np.column_stack([np.ones(n), rng.standard_normal(n)])
    Y = (rng.normal(0, 0.8, size=(n_sims, n_subj))[:, groups]
         + rng.normal(0, 1.0, size=(n_sims, n)))
    p = T_lme.batched_lme_pvalues(X, Y, groups, device="cpu")["pvalues"][:, 1]
    assert np.isfinite(p).all()
    rate = float((p < 0.05).mean())
    assert 0.02 <= rate <= 0.09, rate
    assert stats.kstest(p, "uniform").statistic < 0.08
