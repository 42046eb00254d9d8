"""Plain reference of the phase-randomised coherence null, and the
comparison that decides ``correct`` in its cell.

The statistic is the window mean of the K-taper MSC
|Σ_k conj(E_k)·M_k|² / (Σ_k |E_k|² · Σ_k |M_k|²), each window's clipped
to [0, 1], in every rFFT bin and EEG×EMG pair, over the sliding grid of
``window_sec`` windows at the hop.  Surrogate s turns the EMG's rFFT
over the whole recording by phases φ_s (one per bin and channel), DC
and, for an even length, Nyquist left unturned so that the signal stays
real, and goes back to time; its windows are then framed, tapered and
transformed as the recording's.  Chunk by chunk, ``key, sub =
split(key)`` from ``PRNGKey(seed)`` and φ = ``uniform(sub, (chunk, F,
M), 0, 2π)`` in float32, drawn from this package's frozen copy of the
key schedule (``threefry.py``), then widened; everything after the draw
is float64.  Every surrogate drawn, the last chunk's surplus included,
enters the per-cell histogram: bin min(⌊c·1024⌋, 1023) of cell (f, e,
m).  A cell's quantile q is (the number of bins whose cumulative count
over the surrogates drawn, as a float32 share, lies below float32 q,
plus 1) / 1024, in float32: the rule's own arithmetic.  The maximum of
each surrogate is taken over every bin but DC and Nyquist (by index)
and inside ``band``, and ``p_fwe = (1 + #{max ≥ observed max}) / (1 +
n_surrogates)`` over the first ``n_surrogates`` maxima.

Surrogates run in blocks on the call's device, so that no block holds
more than ``budget_bytes`` of float64 work.  ``control=True`` rounds
every window spectrum, the recording's and each surrogate's, to float16
(real and imaginary parts), the step below the float32 that the
configuration states, for the control run.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference import threefry
from benchmarks.reference.spectra import tapered_spectra, tapers, \
    window_starts

N_BINS = 1024
# float64 bytes of work per (window, taper, sample, EMG channel) of a
# surrogate in a block: the framed windows, their spectra, the products
_BYTES_PER_SAMPLE = 64


def freq_mask(window_samples: int, fs: float, band) -> np.ndarray:
    """Bins of the max statistic: never DC, nor Nyquist for an even
    window (by index), and inside ``band`` (None: every other bin)."""
    f = np.fft.rfftfreq(window_samples, 1.0 / fs)
    ok = np.ones(len(f), bool)
    ok[0] = False
    if window_samples % 2 == 0:
        ok[-1] = False
    if band is not None:
        ok &= (f >= band[0]) & (f <= band[1])
    return ok


def _rounded(x: torch.Tensor, control: bool) -> torch.Tensor:
    if not control:
        return x
    return torch.complex(x.real.half().double(), x.imag.half().double())


def window_msc(Ew: torch.Tensor, Mw: torch.Tensor) -> torch.Tensor:
    """(W, K, F, E) and (..., W, K, F, M) spectra → (..., F, E, M) window
    mean of the clipped MSC."""
    cross = (torch.conj(Ew)[..., :, None] * Mw[..., None, :]).sum(-4)
    pe = (Ew.real ** 2 + Ew.imag ** 2).sum(-3)
    pm = (Mw.real ** 2 + Mw.imag ** 2).sum(-3)
    c = (cross.real ** 2 + cross.imag ** 2) \
        / (pe[..., :, None] * pm[..., None, :])
    return torch.clamp(c, 0.0, 1.0).mean(-4)


def turned(emg_f: torch.Tensor, n: int, phi: torch.Tensor) -> torch.Tensor:
    """(F, M) rFFT of a length-n signal turned by (S, F, M) phases →
    (S, n, M) surrogates; DC and Nyquist (n even) unturned."""
    keep = torch.zeros(emg_f.shape[0], dtype=torch.bool, device=phi.device)
    keep[0] = True
    if n % 2 == 0:
        keep[-1] = True
    rot = torch.polar(torch.ones_like(phi), phi)
    rot = torch.where(keep[None, :, None], torch.ones_like(rot), rot)
    return torch.fft.irfft(emg_f[None] * rot, n=n, dim=1)


def histogram_quantiles(hist: torch.Tensor, n_total: int, quantiles
                        ) -> dict:
    """(..., N_BINS) int64 counts → {q: (...) float32 numpy} by the
    rule's float32 arithmetic."""
    cdf = hist.cumsum(-1).to(torch.float32) \
        / torch.tensor(n_total, dtype=torch.float32, device=hist.device)
    out = {}
    for q in quantiles:
        below = (cdf < torch.tensor(q, dtype=torch.float32,
                                    device=hist.device)).sum(-1)
        out[q] = ((below + 1).to(torch.float32) / N_BINS).cpu().numpy()
    return out


def phase_null(eeg: np.ndarray, emg: np.ndarray, p: dict, seed: int,
               device, control: bool = False,
               budget_bytes: float = 4e9) -> dict:
    """The null of one call: eeg (n, E) and emg (n, M) host float32; p
    the call's parameters (fs, window_sec, overlap, nw, taper_threshold,
    band, n_surrogates, surrogate_chunk, quantiles).  Returns observed
    (F, E, M) and max_stat (n_surrogates,) float64, null_quantiles {q:
    (F, E, M) float32}, p_fwe and n_drawn."""
    if p.get("max_stat_only"):
        raise ValueError("the reference covers the histogram's quantiles; "
                         "max_stat_only is not referenced")
    n, nE = eeg.shape
    nM = emg.shape[1]
    ws = int(p["window_sec"] * p["fs"])
    tap = torch.as_tensor(tapers(ws, p["nw"], p["taper_threshold"]),
                          dtype=torch.float64, device=device)
    K = tap.shape[0]
    starts = window_starts(n, ws, p["overlap"])
    W = len(starts)
    fmask = torch.as_tensor(freq_mask(ws, p["fs"], p["band"]),
                            device=device)
    x_eeg = torch.from_numpy(np.ascontiguousarray(eeg)).to(device)
    x_emg = torch.from_numpy(np.ascontiguousarray(emg)).to(device).double()
    Ew = _rounded(tapered_spectra(x_eeg, starts, ws, tap), control)
    observed = window_msc(
        Ew, _rounded(tapered_spectra(x_emg, starts, ws, tap), control))
    emg_f = torch.fft.rfft(x_emg, dim=0)                  # (F, M)
    idx = (torch.as_tensor(starts, device=device)[:, None]
           + torch.arange(ws, device=device))             # (W, ws)
    cells = observed.numel()
    hist = torch.zeros(cells * N_BINS, dtype=torch.int64, device=device)
    cell_base = torch.arange(cells, device=device) * N_BINS
    block = max(1, int(budget_bytes // (W * K * ws * nM * _BYTES_PER_SAMPLE
                                         + W * observed.numel() * 48)))
    maxima = []
    key = threefry.prng_key(seed)
    S = int(min(p["surrogate_chunk"], p["n_surrogates"]))
    n_drawn = 0
    while n_drawn < p["n_surrogates"]:
        key, sub = threefry.split(key)
        phi = threefry.uniform(sub, (S, emg_f.shape[0], nM), 0.0,
                               2 * np.pi, device).double()
        for s0 in range(0, S, block):
            surr = turned(emg_f, n, phi[s0:s0 + block])     # (b, n, M)
            frames = surr[:, idx]                           # (b, W, ws, M)
            Ms = torch.fft.rfft(frames[:, :, None] * tap[None, None, :, :,
                                                         None], dim=3)
            c = window_msc(Ew, _rounded(Ms, control))       # (b, F, E, M)
            del surr, frames, Ms
            maxima.append(c[:, fmask].flatten(1).amax(1))
            bins = torch.clamp(torch.floor(c * N_BINS), 0, N_BINS - 1)
            flat = (cell_base + bins.flatten(1).long()).reshape(-1)
            hist += torch.bincount(flat, minlength=hist.numel())
            del c, bins, flat
        n_drawn += S
        del phi
    max_stat = torch.cat(maxima)[:p["n_surrogates"]].cpu().numpy()
    obs = observed.cpu().numpy()
    observed_max = float(obs[fmask.cpu().numpy()].max())
    p_fwe = (1.0 + float((max_stat >= observed_max).sum())) \
        / (1.0 + len(max_stat))
    quant = histogram_quantiles(hist.reshape(*obs.shape, N_BINS), n_drawn,
                                p["quantiles"])
    return {"observed": obs, "max_stat": max_stat, "null_quantiles": quant,
            "p_fwe": p_fwe, "n_drawn": n_drawn}


def compare(program: dict, ref: dict) -> dict:
    """The numbers compared for one phase-null call: ``observed_gap`` and
    ``max_stat_gap`` (largest absolute gaps), ``quantile_flips`` (the
    share of (cell, q) quantiles whose histogram bin differs) and
    ``p_fwe_gap`` (|Δp_fwe| in surrogates, 0 where both count the same
    maxima)."""
    qs = list(ref["null_quantiles"])
    shapes = (np.shape(program["observed"]), np.shape(program["max_stat"]),
              [np.shape(program["null_quantiles"][q]) for q in qs])
    want = (ref["observed"].shape, ref["max_stat"].shape,
            [ref["null_quantiles"][q].shape for q in qs])
    if shapes != want:
        raise ValueError(f"program results have shapes {shapes}, the "
                         f"reference {want}")
    flips = sum(int(np.count_nonzero(
        np.asarray(program["null_quantiles"][q], np.float32)
        != ref["null_quantiles"][q])) for q in qs)
    n_cells = sum(ref["null_quantiles"][q].size for q in qs)
    return {
        "observed_gap": float(np.abs(program["observed"]
                                     - ref["observed"]).max()),
        "max_stat_gap": float(np.abs(program["max_stat"]
                                     - ref["max_stat"]).max()),
        "quantile_flips": flips / n_cells,
        "p_fwe_gap": float(abs(program["p_fwe"] - ref["p_fwe"])
                           * (1 + len(ref["max_stat"]))),
    }
