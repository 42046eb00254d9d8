"""Plain reference of the cohort rotation null, and the comparison that
decides ``correct`` in the null cells.

The null's statistic is the cohort mean, over subjects, of each
subject's weighted window mean of the K-taper MSC
|Σ_k conj(E_k)·M_k|² / (Σ_k |E_k|² · Σ_k |M_k|²) in every band bin and
EEG×EMG pair.  A surrogate turns subject j's EMG spectrum of taper k at
bin f by a phase φ_jkf shared by every window and channel.  With
y_k = conj(E_k)·M_k·sqrt(w / (pe·pm)), the turned statistic is

    Σ_w Σ_k |y_k|² + Σ_{k<l} [2·Re C_kl · cos(φ_k − φ_l)
                              − 2·Im C_kl · sin(φ_k − φ_l)],
    C_kl = Σ_w y_k·conj(y_l),

over the weight sum, so each surrogate is a dot product of trig
features with per-subject coefficients.  This module forms y_k directly
per window (no factorised gram products), draws the phases from its own
frozen copy of the key schedule (``threefry.py``), and contracts in
float64.  The windows are the greedy largest disjoint subset of the
call's windows (the sliding grid, or the task windows a session's
configuration names), as the null's default
``p_value_windows='disjoint'``.

``control=True`` computes the same in float32 with the operands of its
products rounded to TF32 (10-bit mantissa, round to nearest even), as
cuBLAS does with TF32 on: the band spectra of the coefficient pass and
both operands of the contraction.  It is the step below the float32
that the configuration states, for the control run.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference import threefry
from benchmarks.reference.spectra import tapered_spectra, tapers, \
    window_starts


def disjoint(starts: np.ndarray, window_samples: int) -> np.ndarray:
    """Mask of the greedy largest non-overlapping subset, in start
    order."""
    keep = np.zeros(len(starts), bool)
    last = None
    for i in np.argsort(starts, kind="stable"):
        if last is None or starts[i] >= last + window_samples:
            keep[i] = True
            last = starts[i]
    return keep


def band_bins(window_samples: int, fs: float, band) -> tuple[int, int]:
    """[lo, hi) rFFT bins with band[0] ≤ f ≤ band[1], never DC nor
    Nyquist."""
    f = np.fft.rfftfreq(window_samples, 1.0 / fs)
    ok = (f >= band[0]) & (f <= band[1])
    ok[0] = False
    if window_samples % 2 == 0:
        ok[-1] = False
    bins = np.nonzero(ok)[0]
    return int(bins[0]), int(bins[-1]) + 1


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits), ties to
    even, as a float32."""
    b = x.contiguous().view(torch.int32)
    bias = ((b >> 13) & 1) + 0xFFF
    return ((b + bias) & ~0x1FFF).view(torch.float32)


def _tf32_complex(x: torch.Tensor) -> torch.Tensor:
    return torch.complex(round_tf32(x.real), round_tf32(x.imag))


def subject_coefficients(eeg: torch.Tensor, emg: torch.Tensor,
                         starts: np.ndarray, ws: int, tap: torch.Tensor,
                         lo: int, hi: int, chunk: int = 8,
                         control: bool = False):
    """One subject: (base (F, E, M), coef (P, F, E, M)) over its windows
    (weight 1 each), P = K(K−1): 2·Re C_kl for k < l, then −2·Im C_kl.
    ``control``: the band spectra, the operands of the pair products,
    rounded to TF32 (as a TF32 band DFT would leave them)."""
    K = tap.shape[0]
    ks, ls = np.triu_indices(K, k=1)
    base = c_re = c_im = 0
    for c0 in range(0, len(starts), chunk):
        s = starts[c0:c0 + chunk]
        E = tapered_spectra(eeg, s, ws, tap)[:, :, lo:hi]   # (w, K, F, E)
        M = tapered_spectra(emg, s, ws, tap)[:, :, lo:hi]
        if control:
            E, M = _tf32_complex(E), _tf32_complex(M)
        pe = (E.real ** 2 + E.imag ** 2).sum(1)
        pm = (M.real ** 2 + M.imag ** 2).sum(1)
        scale = torch.rsqrt(pe[..., :, None] * pm[..., None, :])
        y = torch.conj(E)[..., :, None] * M[..., None, :] * scale[:, None]
        base = base + (y.real ** 2 + y.imag ** 2).sum((0, 1))
        c = (y[:, ks] * torch.conj(y[:, ls])).sum(0)        # (P2,F,E,M)
        c_re, c_im = c_re + c.real, c_im + c.imag
        del E, M, y, c
    n = len(starts)
    return base / n, torch.cat([2 * c_re, -2 * c_im]) / n


def features(phi: torch.Tensor, dtype) -> torch.Tensor:
    """(J, S, K, F) phases → (F, S, J·P) trig features: cos(φ_k − φ_l)
    for k < l, then sin(φ_k − φ_l)."""
    K = phi.shape[2]
    ks, ls = np.triu_indices(K, k=1)
    d = phi.to(dtype)[:, :, ks] - phi.to(dtype)[:, :, ls]   # (J,S,P2,F)
    g = torch.cat([torch.cos(d), torch.sin(d)], dim=2)      # (J,S,P,F)
    J, S, P, F = g.shape
    return g.permute(3, 1, 0, 2).reshape(F, S, J * P)


def cohort_null(eeg, emg, p: dict, seed: int, device, starts=None,
                control: bool = False) -> dict:
    """The null of one call: eeg (J, n, E) and emg (J, n, M) host float32;
    p the call's parameters (fs, window_sec, overlap, nw, taper_threshold,
    band, n_surrogates, surrogate_chunk); ``starts`` the call's window
    starts, every subject's the same (None: the sliding grid over the
    whole recording).  Returns observed (F, E, M), max_stat (n_drawn,),
    counts (F, E, M) and p_fwe, as float64 numpy (float32 values with
    ``control``)."""
    dtype = torch.float32 if control else torch.float64
    J, n, nE = eeg.shape
    nM = emg.shape[2]
    ws = int(p["window_sec"] * p["fs"])
    tap = torch.as_tensor(tapers(ws, p["nw"], p["taper_threshold"]),
                          dtype=dtype, device=device)
    K = tap.shape[0]
    lo, hi = band_bins(ws, p["fs"], p["band"])
    nF = hi - lo
    if starts is None:
        starts = window_starts(n, ws, p["overlap"])
    starts = np.asarray(starts)[disjoint(np.asarray(starts), ws)]
    bases, coefs = [], []
    for j in range(J):
        b, c = subject_coefficients(
            torch.from_numpy(eeg[j]).to(device),
            torch.from_numpy(emg[j]).to(device), starts, ws, tap, lo, hi,
            control=control)
        bases.append(b.reshape(nF, nE * nM))
        coefs.append(c.reshape(-1, nF, nE * nM))
    base = torch.stack(bases).mean(0)                       # (F, N)
    P = coefs[0].shape[0]
    observed = base + torch.stack([c[:P // 2].sum(0) for c in coefs]
                                  ).mean(0)
    # (F, J·P, N), subject-major then feature, as features() flattens
    coef = torch.stack(coefs).permute(2, 0, 1, 3).reshape(nF, J * P, -1)
    if control:
        coef = round_tf32(coef)
    del bases, coefs
    counts = torch.zeros_like(observed, dtype=torch.int64)
    maxima = []
    key = threefry.prng_key(seed)
    n_drawn, S = 0, int(min(p["surrogate_chunk"], p["n_surrogates"]))
    while n_drawn < p["n_surrogates"]:
        key, sub = threefry.split(key)
        phi = threefry.uniform(sub, (J, S, K, nF), 0.0, 2 * np.pi, device)
        g = features(phi, dtype)
        if control:
            g = round_tf32(g)
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


def compare(program: dict, ref: dict) -> dict:
    """The numbers compared for one null call: ``observed_gap`` and
    ``max_stat_gap`` (largest absolute gaps), ``count_flips`` (the share
    of (surrogate, cell) exceedances on which program and reference
    disagree: Σ|Δcount| / (surrogates drawn × cells)) and ``p_fwe_gap``
    (|Δp_fwe| in surrogates, 0 where both count the same maxima)."""
    n = ref["n_drawn"]
    counts = np.rint(np.asarray(program["p_uncorrected"], np.float64)
                     * (1 + n)) - 1
    shapes = (np.shape(program["observed"]), np.shape(program["max_stat"]),
              counts.shape)
    want = (ref["observed"].shape, ref["max_stat"].shape,
            ref["counts"].shape)
    if shapes != want:
        raise ValueError(f"program results have shapes {shapes}, the "
                         f"reference {want}")
    return {
        "observed_gap": float(np.abs(program["observed"]
                                     - ref["observed"]).max()),
        "max_stat_gap": float(np.abs(program["max_stat"]
                                     - ref["max_stat"]).max()),
        "count_flips": float(np.abs(counts - ref["counts"]).sum()
                             / (n * counts.size)),
        "p_fwe_gap": float(abs(program["p_fwe"] - ref["p_fwe"])
                           * (1 + len(ref["max_stat"]))),
    }
