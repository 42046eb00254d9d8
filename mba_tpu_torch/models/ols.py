"""Closed-form OLS (statsmodels.ols replacement).

t-distributed p-values with df = n − k, matching statsmodels OLS output
used at reference statistical_modelling.py:206.

A copy of ``mba_tpu/models/ols.py`` (numpy and scipy), since the port
never imports ``mba_tpu``.
"""
from __future__ import annotations

import numpy as np
from scipy import stats


def fit_ols(X: np.ndarray, y: np.ndarray) -> dict:
    """OLS fit returning params/bse/pvalues/resid/R² (statsmodels names)."""
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    n, k = X.shape
    beta, _, rank, _ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ beta
    dof = n - rank
    mse_resid = resid @ resid / max(dof, 1)
    xtx_inv = np.linalg.pinv(X.T @ X)
    bse = np.sqrt(np.maximum(np.diag(xtx_inv) * mse_resid, 0.0))
    with np.errstate(divide='ignore', invalid='ignore'):
        tvals = np.where(bse > 0, beta / bse, np.nan)
    pvals = 2 * stats.t.sf(np.abs(tvals), max(dof, 1))

    ss_tot = np.sum((y - y.mean()) ** 2)
    ss_res = resid @ resid
    r2 = 1 - ss_res / ss_tot if ss_tot > 0 else np.nan
    r2_adj = (1 - (1 - r2) * (n - 1) / max(dof, 1)
              if np.isfinite(r2) else np.nan)
    return {
        "params": beta, "bse": bse, "tvalues": tvals, "pvalues": pvals,
        "resid": resid, "mse_resid": float(mse_resid),
        "rsquared": float(r2), "rsquared_adj": float(r2_adj),
        "df_resid": int(dof), "rank": int(rank),
    }
