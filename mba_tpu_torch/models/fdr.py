"""Benjamini–Hochberg FDR (statsmodels.multipletests 'fdr_bh' replacement).

A copy of ``mba_tpu/models/fdr.py`` (numpy only), since the port never
imports ``mba_tpu``.
"""
from __future__ import annotations

import numpy as np


def benjamini_hochberg(p_values, alpha: float = 0.05):
    """BH step-up procedure.

    Returns (reject bool array, adjusted p-values) identical to
    ``statsmodels.stats.multitest.multipletests(..., method='fdr_bh')``.
    """
    p = np.asarray(p_values, float)
    n = len(p)
    order = np.argsort(p)
    ranked = p[order]
    adj = ranked * n / np.arange(1, n + 1)
    # monotone non-decreasing from the largest p downwards
    adj = np.minimum.accumulate(adj[::-1])[::-1]
    adj = np.clip(adj, 0, 1)
    p_adj = np.empty(n)
    p_adj[order] = adj
    reject = p_adj <= alpha
    return reject, p_adj
