"""The control of the rotation null's 16-bit cells: the reference of
``null.py`` one step below bfloat16 operands.

The program's 16-bit contraction rounds its two operands, the trig
features and the cohort's coefficients, once to bfloat16 or float16,
and keeps the coefficient pass, the products' sums and the epilogue in
float32.  The control rounds those two operands to float8 e4m3 (3
mantissa bits, round to nearest even), below bfloat16's 7, and the rest
as ``null.cohort_null(control=True)`` does: float32, the coefficient
pass's band spectra rounded to TF32, the step below the float32 of that
pass.  Built from ``null.py``'s pieces.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference import null, threefry
from benchmarks.reference.spectra import tapers, window_starts


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest float8 e4m3 value, as a float32."""
    return x.to(torch.float8_e4m3fn).to(torch.float32)


def cohort_null(eeg, emg, p: dict, seed: int, device, starts=None) -> dict:
    """``null.cohort_null(..., control=True)`` with the contraction's
    operands rounded to e4m3 instead of TF32; the same results."""
    J, n, nE = eeg.shape
    nM = emg.shape[2]
    ws = int(p["window_sec"] * p["fs"])
    tap = torch.as_tensor(tapers(ws, p["nw"], p["taper_threshold"]),
                          dtype=torch.float32, device=device)
    K = tap.shape[0]
    lo, hi = null.band_bins(ws, p["fs"], p["band"])
    nF = hi - lo
    if starts is None:
        starts = window_starts(n, ws, p["overlap"])
    starts = np.asarray(starts)[null.disjoint(np.asarray(starts), ws)]
    bases, coefs = [], []
    for j in range(J):
        b, c = null.subject_coefficients(
            torch.from_numpy(eeg[j]).to(device),
            torch.from_numpy(emg[j]).to(device), starts, ws, tap, lo, hi,
            control=True)
        bases.append(b.reshape(nF, nE * nM))
        coefs.append(c.reshape(-1, nF, nE * nM))
    base = torch.stack(bases).mean(0)                       # (F, N)
    P = coefs[0].shape[0]
    observed = base + torch.stack([c[:P // 2].sum(0) for c in coefs]
                                  ).mean(0)
    coef = round_e4m3(torch.stack(coefs).permute(2, 0, 1, 3)
                      .reshape(nF, J * P, -1))
    del bases, coefs
    counts = torch.zeros_like(observed, dtype=torch.int64)
    maxima = []
    key = threefry.prng_key(seed)
    n_drawn, S = 0, int(min(p["surrogate_chunk"], p["n_surrogates"]))
    while n_drawn < p["n_surrogates"]:
        key, sub = threefry.split(key)
        phi = threefry.uniform(sub, (J, S, K, nF), 0.0, 2 * np.pi, device)
        g = round_e4m3(null.features(phi, torch.float32))
        stat = base[:, None, :] + torch.bmm(g, coef) / J    # (F, S, N)
        maxima.append(stat.amax(dim=(0, 2)))
        counts += (stat >= observed[:, None, :]).sum(1)
        n_drawn += S
        del stat, g, phi
    max_stat = torch.cat(maxima)[:p["n_surrogates"]]
    p_fwe = (1.0 + float((max_stat >= observed.max()).sum())) \
        / (1.0 + len(max_stat))
    shape = (nF, nE, nM)
    return {"observed": observed.reshape(shape).cpu().numpy(),
            "max_stat": max_stat.cpu().numpy(),
            "counts": counts.reshape(shape).cpu().numpy(),
            "n_drawn": n_drawn, "p_fwe": p_fwe}
