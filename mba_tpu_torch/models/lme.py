"""Random-intercept linear mixed model via profiled REML.

The port of ``mba_tpu/models/lme.py``.  It replaces
``statsmodels.mixedlm(...).fit(reml=True)`` with a solver built on the
random-intercept structure the study uses:

    y = Xβ + Z b + ε,   b_g ~ N(0, σ_b²),   ε ~ N(0, σ_e²)

With λ = σ_b²/σ_e², every GLS quantity reduces to group sums via the
Woodbury identity (W_g⁻¹ = I − λ/(1+λ n_g) · J), so the profiled REML
criterion is a cheap scalar function of λ:

    L(λ) = (n−p)·ln(rᵀW⁻¹r) + Σ_g ln(1+λ n_g) + ln|XᵀW⁻¹X|

- :func:`fit_random_intercept_reml` — a host copy (numpy/scipy Brent):
  one fit with the statsmodels-shaped result (fe_params, bse, z-based
  pvalues, scale, cov_re, BLUPs, llf/aic/bic).
- :func:`batched_lme_pvalues` — the device path: thousands of response
  vectors refit at once (sufficient statistics and a hierarchical grid
  on ln λ, :func:`_batched_reml_core`), on the card unless given
  ``device="cpu"``.
- :func:`_batched_reml_weighted` — per-batch designs with 0/1 row
  weights and a golden-section search (the mediation bootstrap).

The JAX package's ``jit``/``vmap``/``lax.scan`` become plain torch code:
static arguments are Python ints, ``vmap`` a leading batch dimension,
``scan`` over grid levels a Python loop, ``jax.ops.segment_sum`` over
groups ``index_add_`` on the group axis.  Every matmul runs in full
float32 (TF32 off, ``_device.apply_precision_policy``; fault C1).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from scipy import optimize, stats

from mba_tpu_torch import _device


# --------------------------------------------------------------------------
# shared sufficient statistics (host)
# --------------------------------------------------------------------------
def _group_stats(X: np.ndarray, groups: np.ndarray):
    """Group indices + per-group design sums used by Woodbury reductions."""
    uniq, gidx = np.unique(groups, return_inverse=True)
    n_groups = len(uniq)
    counts = np.bincount(gidx, minlength=n_groups).astype(float)
    # Xg[g] = Σ_{i∈g} x_i   (n_groups, p)
    p = X.shape[1]
    Xg = np.zeros((n_groups, p))
    np.add.at(Xg, gidx, X)
    return uniq, gidx, counts, Xg


def _profiled_quantities(lam, X, y, gidx, counts, Xg, yg):
    """GLS β̂, residual quadratic form, and log-dets for one λ (numpy)."""
    w = lam / (1.0 + lam * counts)                       # (G,)
    xtx = X.T @ X - (Xg * w[:, None]).T @ Xg             # XᵀW⁻¹X
    xty = X.T @ y - (Xg * w[:, None]).T @ yg             # XᵀW⁻¹y
    beta = np.linalg.solve(xtx, xty)
    r = y - X @ beta
    rg = np.bincount(gidx, weights=r, minlength=len(counts))
    quad = r @ r - w @ rg ** 2                            # rᵀW⁻¹r
    logdet_w = np.sum(np.log1p(lam * counts))
    sign, logdet_xtx = np.linalg.slogdet(xtx)
    return beta, r, rg, quad, logdet_w, logdet_xtx, xtx, w


def fit_random_intercept_reml(X: np.ndarray, y: np.ndarray,
                              groups: np.ndarray,
                              param_names: list[str] | None = None) -> dict:
    """Profiled-REML random-intercept LME (statsmodels-shaped output)."""
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    n, p = X.shape
    rank = np.linalg.matrix_rank(X)
    if rank < p:
        raise np.linalg.LinAlgError(
            f"Rank-deficient design matrix: rank={rank}, n_params={p}")

    uniq, gidx, counts, Xg = _group_stats(X, groups)
    yg = np.bincount(gidx, weights=y, minlength=len(uniq))

    def criterion(log_lam):
        lam = np.exp(log_lam)
        _, _, _, quad, logdet_w, logdet_xtx, _, _ = _profiled_quantities(
            lam, X, y, gidx, counts, Xg, yg)
        return ((n - p) * np.log(max(quad, 1e-300))
                + logdet_w + logdet_xtx)

    res = optimize.minimize_scalar(criterion, bounds=(-12.0, 8.0),
                                   method="bounded",
                                   options={"xatol": 1e-8})
    # boundary case: λ → 0 (no between-group variance)
    lam = float(np.exp(res.x))
    if criterion(-30.0) <= res.fun:
        lam = np.exp(-30.0)

    beta, r, rg, quad, logdet_w, logdet_xtx, xtx, w = _profiled_quantities(
        lam, X, y, gidx, counts, Xg, yg)
    scale = quad / (n - p)                                # σ_e² (REML)
    re_var = lam * scale                                  # σ_b²
    cov_beta = np.linalg.inv(xtx) * scale
    bse = np.sqrt(np.maximum(np.diag(cov_beta), 0.0))
    with np.errstate(divide='ignore', invalid='ignore'):
        zvals = np.where(bse > 0, beta / bse, np.nan)
    pvals = 2 * stats.norm.sf(np.abs(zvals))              # z-test (statsmodels)

    # BLUPs: b̂_g = λ/(1+λ n_g) · Σ_g r
    blups = (lam / (1.0 + lam * counts)) * rg

    llf = -0.5 * ((n - p) * np.log(2 * np.pi * scale)
                  + logdet_w + logdet_xtx
                  + (n - p))
    k = p + 2  # fixed effects + re variance + residual variance
    aic = -2 * llf + 2 * k
    bic = -2 * llf + k * np.log(n)

    names = (param_names if param_names is not None
             else [f"x{i}" for i in range(p)])
    return {
        "fe_params": dict(zip(names, beta)),
        "params": beta, "bse": bse, "zvalues": zvals, "pvalues": pvals,
        "scale": float(scale), "cov_re": float(re_var), "lam": lam,
        "resid": r, "random_effects": dict(zip(uniq.tolist(), blups)),
        "llf": float(llf), "aic": float(aic), "bic": float(bic),
        "converged": bool(res.success),
        "groups": uniq,
    }


# --------------------------------------------------------------------------
# batched device path (power simulations, bootstrap)
# --------------------------------------------------------------------------
_REML_BLOCK = 8192     # max responses per grid solve: bounds device memory


def _segment_sum(values: torch.Tensor, gidx: torch.Tensor, n_groups: int,
                 dim: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` along ``dim`` (group index ``gidx``, int64).
    On the card ``index_add_`` adds with atomics, so a group's sum may
    differ in its last bits from run to run."""
    shape = list(values.shape)
    shape[dim] = n_groups
    return values.new_zeros(shape).index_add_(dim, gidx, values)


def _solve_psd_small(A: torch.Tensor, B: torch.Tensor):
    """Batched SPD solve + log-det for tiny static p, fully unrolled.

    A: (..., p, p) SPD; B: (..., p, m).  Returns (X, logdet) with
    X = A⁻¹B, by the same Cholesky-Crout as the JAX package, element by
    element in the same order, so the two round alike.  Non-PD inputs
    surface as NaNs (sqrt of a negative pivot), which callers map to
    +inf criteria / NaN p-values.  Each step is one elementwise launch
    over the batch: ~p³/3 of them, so on the card a solve is bound by
    launches, not by the card.
    """
    p = A.shape[-1]
    L = {}
    for j in range(p):
        for i in range(j, p):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = torch.sqrt(s) if i == j else s / L[(j, j)]
    logdet = 2.0 * sum(torch.log(L[(i, i)]) for i in range(p))
    ys = []
    for i in range(p):                     # forward: L y = B
        s = B[..., i, :]
        for k in range(i):
            s = s - L[(i, k)][..., None] * ys[k]
        ys.append(s / L[(i, i)][..., None])
    xs = [None] * p
    for i in reversed(range(p)):           # backward: Lᵀ x = y
        s = ys[i]
        for k in range(i + 1, p):
            s = s - L[(k, i)][..., None] * xs[k]
        xs[i] = s / L[(i, i)][..., None]
    return torch.stack(xs, dim=-2), logdet


def _design_terms(X: torch.Tensor, gidx: torch.Tensor,
                  n_groups: int) -> dict:
    """What every response block of one design shares: X'X, its Cholesky
    factor (NaN where X'X is not positive definite, as the JAX package's
    solve of a singular X'X gives non-finite values), the group sums of
    X and their outer products, and X's column sums."""
    n, p = X.shape
    xtx_full = X.T @ X                                      # (p, p)
    chol, info = torch.linalg.cholesky_ex(xtx_full)
    chol = torch.where(info == 0, chol, torch.nan)
    Xg = _segment_sum(X, gidx, n_groups, 0)                 # (G, p)
    XgXg = (Xg[:, :, None] * Xg[:, None, :]).reshape(n_groups, p * p)
    return {"X": X, "gidx": gidx, "n_groups": n_groups,
            "xtx_full": xtx_full, "chol": chol, "Xg": Xg, "XgXg": XgXg,
            "x_sum": X.sum(0)}


def _reml_block(terms: dict, Y: torch.Tensor, counts: torch.Tensor,
                n_grid: int = 17, n_levels: int = 3):
    """The REML grid for one block of responses Y (S, n) of the design
    ``terms``; returns (beta (S,p), bse (S,p), scale (S,), lam (S,)).

    The JAX package's two design choices hold (``mba_tpu/models/lme.py``
    ``_batched_reml_core``):

    1. **Sufficient statistics via the OLS-residual split.**  With
       y = Xβ̂₀ + e₀ (β̂₀ the per-response OLS fit, X'e₀ = 0), every
       λ-dependent quantity reduces to {β̂₀, e₀'e₀, per-group sums of e₀},
       computed once per response; the split is cancellation-free:
       r'r = e₀'e₀ + δ'X'Xδ with δ = β̂₀ − β(λ).  β̂₀ comes from the
       Cholesky factor of X'X (a backward-stable solve, as the JAX
       package's LU), computed once per design.
    2. **Hierarchical parallel λ-grid.**  Each level evaluates the
       criterion at ``n_grid`` points for all responses at once, then
       recenters on the per-response argmin with a parabolic-vertex
       refinement: 3 levels of 17 points resolve ln λ to ≲1e-3.
    """
    X, gidx, n_groups = terms["X"], terms["gidx"], terms["n_groups"]
    xtx_full, Xg, XgXg = terms["xtx_full"], terms["Xg"], terms["XgXg"]
    n, p = X.shape
    S = Y.shape[0]

    # per-response sufficient statistics — one pass over the data.  X'Y
    # from the responses less their means (X'Y = X'(Y − c) + (X'1)c): a
    # response of ~0.9 ± 0.02 puts its whole sum through the intercept
    # column's float32 accumulation, whose rounding then dominates β's
    # error (about twice the JAX package's with torch's CPU sgemm); on
    # the centered rows it drops to the float64 product's level.
    c = Y.mean(1, keepdim=True)                             # (S, 1)
    xty = X.T @ (Y - c).T + terms["x_sum"][:, None] * c.T   # (p, S)
    chol = terms["chol"]
    beta_ols = torch.linalg.solve_triangular(
        chol.T, torch.linalg.solve_triangular(chol, xty, upper=False),
        upper=True)                                         # (p, S)
    E0 = Y - (X @ beta_ols).T                               # (S, n)
    ee = (E0 * E0).sum(1)                                   # (S,)
    e0g_s = _segment_sum(E0, gidx, n_groups, 1)             # (S, G)
    yg_s = (Xg @ beta_ols).T + e0g_s                        # (S, G)
    beta_ols_s, xty_s = beta_ols.T, xty.T                   # (S, p)

    def eval_grid(log_lams):
        """Criterion + fit quantities at (S, L) ln-λ points at once."""
        lam = torch.exp(log_lams)                           # (S, L)
        a = lam[:, :, None] * counts                        # (S, L, G)
        w = lam[:, :, None] / (1.0 + a)                     # (S, L, G)
        xtx = xtx_full - (w @ XgXg).reshape(*w.shape[:2], p, p)
        xty_l = xty_s[:, None, :] - (w * yg_s[:, None, :]) @ Xg
        beta, ldx = _solve_psd_small(xtx, xty_l[..., None])
        beta = beta[..., 0]                                 # (S, L, p)
        delta = beta_ols_s[:, None, :] - beta
        rr = ee[:, None] + ((delta @ xtx_full) * delta).sum(-1)
        rg = e0g_s[:, None, :] + delta @ Xg.T               # (S, L, G)
        quad = rr - (w * rg * rg).sum(-1)
        ldw = torch.log1p(a).sum(-1)
        crit = ((n - p) * torch.log(torch.clamp_min(quad, 1e-30))
                + ldw + ldx)
        crit = torch.where(torch.isnan(crit), torch.inf, crit)
        return crit, xtx, beta, quad

    def pick(values, idx):
        return values.gather(1, idx[:, None])[:, 0]

    lo, hi = -12.0, 8.0
    offs = torch.linspace(-1.0, 1.0, n_grid, device=Y.device)
    center = torch.full((S,), 0.5 * (lo + hi), device=Y.device)
    h = 0.5 * (hi - lo)
    for level in range(n_levels):
        lls = center[:, None] + h * offs[None, :]
        crit = eval_grid(lls)[0]
        if level == 0:
            # ln λ = −12 is column 0 of the first level's grid exactly
            crit_boundary = crit[:, 0]
        idx = crit.argmin(1)
        c = pick(lls, idx)
        best = pick(crit, idx)
        # free sub-grid refinement: parabola through the best point and
        # its two neighbours (already evaluated)
        spacing = 2.0 * h / (n_grid - 1)
        f_lo = pick(crit, (idx - 1).clamp_min(0))
        f_hi = pick(crit, (idx + 1).clamp_max(n_grid - 1))
        denom = f_lo - 2.0 * best + f_hi
        vertex = 0.5 * spacing * (f_lo - f_hi) / torch.where(
            denom > 0, denom, 1.0)
        vertex = torch.where((denom > 0) & torch.isfinite(vertex),
                             vertex.clamp(-spacing, spacing), 0.0)
        center, h = c + vertex, spacing

    # boundary: λ→0 if the criterion prefers it
    log_lam = torch.where(crit_boundary <= best, -25.0, center)
    _, xtx0, beta, quad = eval_grid(log_lam[:, None])
    scale = quad[:, 0] / (n - p)
    eye = torch.eye(p, device=Y.device).expand(S, p, p)
    inv, _ = _solve_psd_small(xtx0[:, 0], eye)
    bse = torch.sqrt(torch.clamp_min(
        torch.diagonal(inv, dim1=-2, dim2=-1) * scale[:, None], 0.0))
    return beta[:, 0], bse, scale, torch.exp(log_lam)


def _batched_reml_core(X: torch.Tensor, Y: torch.Tensor, gidx: torch.Tensor,
                       counts: torch.Tensor, n_groups: int, n_grid: int = 17,
                       n_levels: int = 3):
    """Vectorised profiled REML for many response vectors at once, on the
    device of its tensors: X (n, p) float32, Y (S, n) float32, gidx (n,)
    int64, counts (G,) float32.  Returns (beta (S,p), bse (S,p), scale
    (S,), lam (S,)), as ``mba_tpu.models.lme._batched_reml_core``."""
    return _reml_block(_design_terms(X, gidx, n_groups), Y, counts,
                       n_grid, n_levels)


def _batched_reml_weighted(Xb: torch.Tensor, Yb: torch.Tensor,
                           Wb: torch.Tensor, gidx: torch.Tensor,
                           n_groups: int, n_iters: int = 60) -> torch.Tensor:
    """Vectorised profiled REML with per-batch designs and 0/1 row weights.

    Xb: (B, n, p); Yb: (B, n); Wb: (B, n) row weights (0 = absent row —
    exact row removal under the REML algebra); gidx (n,) int64, on one
    device.  Used for the clustered bootstrap, where every resample has
    its own padded design.  A 60-step golden-section search on ln λ per
    resample, all resamples at once; each step evaluates the criterion
    at its two points once.  Solves and log-dets are batched
    ``torch.linalg`` calls (p ≤ 3 here); a singular X'W⁻¹X gives a NaN
    β, as the JAX package's solve gives non-finite values.  Returns beta
    (B, p).
    """
    p = Xb.shape[2]
    n_eff = Wb.sum(1)                                       # (B,)
    Xw = Xb * Wb[..., None]
    counts = _segment_sum(Wb, gidx, n_groups, 1)            # (B, G)
    Xg = _segment_sum(Xw, gidx, n_groups, 1)                # (B, G, p)
    yg = _segment_sum(Yb * Wb, gidx, n_groups, 1)           # (B, G)
    xtx_full = Xw.transpose(1, 2) @ Xb                      # (B, p, p)
    xty_full = (Xw.transpose(1, 2) @ Yb[..., None])[..., 0]  # (B, p)

    def quantities(lam):
        wg = lam[:, None] / (1.0 + lam[:, None] * counts)   # (B, G)
        Xgw = (Xg * wg[..., None]).transpose(1, 2)          # (B, p, G)
        xtx = xtx_full - Xgw @ Xg
        xty = xty_full - (Xgw @ yg[..., None])[..., 0]
        sol, info = torch.linalg.solve_ex(xtx, xty[..., None])
        beta = torch.where((info == 0)[:, None], sol[..., 0], torch.nan)
        r = Yb - (Xb @ beta[..., None])[..., 0]
        rg = _segment_sum(r * Wb, gidx, n_groups, 1)
        quad = ((Wb * r) * r).sum(1) - (wg * rg ** 2).sum(1)
        logdet_w = torch.log1p(lam[:, None] * counts).sum(1)
        logdet_xtx = torch.linalg.slogdet(xtx)[1]
        return beta, quad, logdet_w, logdet_xtx

    def criterion(log_lam):
        _, quad, ldw, ldx = quantities(torch.exp(log_lam))
        return ((n_eff - p) * torch.log(torch.clamp_min(quad, 1e-30))
                + ldw + ldx)

    gr = 0.6180339887498949
    lo = torch.full_like(n_eff, -12.0)
    hi = torch.full_like(n_eff, 8.0)
    for _ in range(n_iters):
        c = hi - gr * (hi - lo)
        d = lo + gr * (hi - lo)
        keep = criterion(c) < criterion(d)
        lo, hi = torch.where(keep, lo, c), torch.where(keep, d, hi)
    log_lam = 0.5 * (lo + hi)
    log_lam = torch.where(criterion(torch.full_like(lo, -12.0))
                          <= criterion(log_lam), -25.0, log_lam)
    return quantities(torch.exp(log_lam))[0]


def batched_lme_pvalues(X: np.ndarray, Y: np.ndarray, groups: np.ndarray,
                        device=None, diagnostics: dict | None = None) -> dict:
    """Fit S random-intercept REML models at once on ``device`` (the card
    unless ``device="cpu"``).

    X: (n, p) fixed design; Y: (S, n) responses (e.g. power simulations);
    returns dict with beta (S,p), bse (S,p), pvalues (S,p) (z-test),
    scale (S,), lam (S,).  ``diagnostics``, where given, gains the
    seconds of the upload and the download (``upload_sec``,
    ``download_sec``, added over calls) and of each block's solve (a list,
    ``solve_sec``); only then does the call wait for the device after
    each step.

    Y goes to the device in one copy and is solved in blocks of at most
    ``_REML_BLOCK`` responses, a bound on device memory.  The JAX
    package also padded each block to a power of two for XLA's compile
    cache; torch compiles nothing and rows are independent, so blocks
    run at their own size here.
    """
    device = _device.entry_device(device)
    uniq, gidx = np.unique(groups, return_inverse=True)
    counts = np.bincount(gidx, minlength=len(uniq)).astype(np.float32)
    # column equilibration: real designs mix scales (intercept 1,
    # dummies 0/1, force 20-60, trial id 0-30) — max-abs scaling drops
    # cond(X'X) by ~4 orders so the f32 device solve keeps the 2-3
    # digits the z-test needs.  Exact: beta/bse rescale covariantly,
    # λ and the residual scale are invariant (the REML criterion only
    # shifts by a λ-independent constant).
    col_scale = np.max(np.abs(X), axis=0)
    col_scale[col_scale == 0] = 1.0
    Xd = torch.from_numpy(np.asarray(X / col_scale, np.float32)).to(device)
    gd = torch.from_numpy(gidx.astype(np.int64)).to(device)
    cd = torch.from_numpy(counts).to(device)
    terms = _design_terms(Xd, gd, len(uniq))

    t0 = time.perf_counter()

    def lap(key):
        """Seconds since the last lap, after the device has caught up."""
        nonlocal t0
        if diagnostics is not None:
            _device.synchronize(device)
            sec = time.perf_counter() - t0
            if key == "solve_sec":
                diagnostics.setdefault(key, []).append(sec)
            else:
                diagnostics[key] = diagnostics.get(key, 0.0) + sec
            t0 = time.perf_counter()

    Yd = torch.from_numpy(np.ascontiguousarray(Y, np.float32)).to(device)
    lap("upload_sec")
    outs = []
    for start in range(0, Yd.shape[0], _REML_BLOCK):
        outs.append(_reml_block(terms, Yd[start:start + _REML_BLOCK], cd))
        lap("solve_sec")
    beta, bse, scale, lam = (torch.cat(parts).cpu().numpy()
                             for parts in zip(*outs))
    lap("download_sec")
    beta = beta.astype(np.float64) / col_scale
    bse = bse.astype(np.float64) / col_scale
    with np.errstate(divide='ignore', invalid='ignore'):
        z = np.where(bse > 0, beta / bse, np.nan)
    pvalues = 2 * stats.norm.sf(np.abs(z))
    return {"beta": beta, "bse": bse, "pvalues": pvalues,
            "scale": scale, "lam": lam}
