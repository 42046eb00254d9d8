"""Plain reference of the jackknifed multitaper CMC, and the comparison
that decides ``correct`` in the CMC cells.

Per window, frequency and EEG×EMG pair, from the K tapered spectra:
leave-one-taper-out coherences |Σ'CSD|² / (Σ'PSD_e · Σ'PSD_m) over the
other K − 1 tapers, their mean (clipped to [0, 1]) as the estimate, and
a Student-t interval on the Fisher z = atanh of those replicates
(jackknife variance (K − 1)/K · Σ(z_k − z̄)², z clamped to
[1e-10, 1 − 1e-10] before the transform), mapped back by tanh² and
widened to contain the estimate.  With the EMG max-pool each (window,
frequency, EEG channel) keeps the EMG channel of largest estimate and
that channel's interval.  Computed in float64 on the program's float32
input, window chunk by window chunk, so nothing of size (W, F, E, M) is
ever held whole.
"""
from __future__ import annotations

import numpy as np
import scipy.stats
import torch

from benchmarks.reference.spectra import tapered_spectra, tapers

# EMG channels whose reference coherence lies within TIE of the cell's
# largest are all taken as the max-pool's pick: float32 rounding of the
# estimates (~1e-6) reorders near-equal channels, and the interval is
# then judged against the nearest of them
TIE = 1e-4
_TINY = float(np.finfo(np.float32).tiny)
_EPS = 1e-10
# bytes of float64 work per (window, taper, frequency, EEG, EMG) cell
_BYTES_PER_CELL = 64


def _fisher(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, _EPS, 1 - _EPS)
    return 0.5 * torch.log((1 + c) / (1 - c))


def jackknife(Xe: torch.Tensor, Xm: torch.Tensor, t_crit: float) -> dict:
    """(w, K, F, E) and (w, K, F, M) spectra → (w, F, E, M) estimate,
    interval and the largest leave-one-out replicate."""
    K = Xe.shape[1]
    pe = Xe.real ** 2 + Xe.imag ** 2
    pm = Xm.real ** 2 + Xm.imag ** 2
    csd = torch.conj(Xe)[..., :, None] * Xm[..., None, :]   # (w,K,F,E,M)
    loo_c = (csd.sum(1, keepdim=True) - csd) / (K - 1)
    del csd
    loo_e = (pe.sum(1, keepdim=True) - pe) / (K - 1)
    loo_m = (pm.sum(1, keepdim=True) - pm) / (K - 1)
    den = torch.clamp_min(loo_e[..., :, None] * loo_m[..., None, :], _TINY)
    coh_k = torch.clamp((loo_c.real ** 2 + loo_c.imag ** 2) / den, 0, 1)
    del loo_c, den
    coh = torch.clamp(coh_k.mean(1), 0, 1)
    z_k = _fisher(coh_k)
    se = torch.sqrt((K - 1) / K
                    * ((z_k - z_k.mean(1, keepdim=True)) ** 2).sum(1))
    del z_k
    zc = _fisher(coh)
    return {"coherence": coh,
            "lower": torch.minimum(torch.tanh(zc - t_crit * se) ** 2, coh),
            "upper": torch.maximum(torch.tanh(zc + t_crit * se) ** 2, coh),
            "loo_max": coh_k.amax(1)}


def compare(program: dict, eeg: np.ndarray, emg: np.ndarray, p: dict,
            device, dtype=torch.float64,
            budget_bytes: float = 12e9) -> dict:
    """The numbers compared for one CMC call.

    program: the call's (W, F, E) ``coherence``, ``lower``, ``upper``
    host arrays; eeg (n, E) and emg (n, M) the float32 input the call was
    given; p the call's parameters (fs, window_sec, overlap, nw,
    taper_threshold, alpha).  Returns ``coherence_gap`` (largest
    |estimate − reference's EMG max|) and ``ci_gap`` (largest interval
    gap, each weighted by 1 − the largest leave-one-out replicate, since
    Fisher z magnifies a rounding of a replicate c by 1/(1 − c²)).
    """
    ws = int(p["window_sec"] * p["fs"])
    tap = torch.as_tensor(tapers(ws, p["nw"], p["taper_threshold"]),
                          dtype=dtype, device=device)
    K = tap.shape[0]
    t_crit = float(scipy.stats.t.ppf(1 - p["alpha"] / 2, K - 1))
    starts = np.arange((len(eeg) - ws) // int(ws * (1 - p["overlap"])) + 1
                       ) * int(ws * (1 - p["overlap"]))
    W = len(starts)
    shapes = {k: np.shape(program[k]) for k in ("coherence", "lower",
                                                "upper")}
    want = (W, ws // 2 + 1, eeg.shape[1])
    if any(s != want for s in shapes.values()):
        raise ValueError(f"program results have shapes {shapes}, the "
                         f"reference {want}")
    out = {"coherence_gap": 0.0, "ci_gap": 0.0}
    x_e = torch.from_numpy(np.ascontiguousarray(eeg)).to(device)
    x_m = torch.from_numpy(np.ascontiguousarray(emg)).to(device)
    cells = K * want[1] * eeg.shape[1] * emg.shape[1]
    chunk = max(1, int(budget_bytes // (_BYTES_PER_CELL * cells)))
    for c0 in range(0, W, chunk):
        w = np.arange(c0, min(c0 + chunk, W))
        ref = jackknife(tapered_spectra(x_e, starts[w], ws, tap),
                        tapered_spectra(x_m, starts[w], ws, tap), t_crit)
        got = {k: torch.from_numpy(program[k][w]).to(device, dtype)
               for k in shapes}
        cmax = ref["coherence"].amax(-1)
        gap = (got["coherence"] - cmax).abs().max()
        near = ref["coherence"] >= (cmax - TIE)[..., None]
        ci = torch.maximum((got["lower"][..., None] - ref["lower"]).abs(),
                           (got["upper"][..., None] - ref["upper"]).abs())
        ci = torch.where(near, ci * (1 - ref["loo_max"]), torch.inf)
        gaps = {"coherence_gap": float(gap),
                "ci_gap": float(ci.amin(-1).max())}
        del ref, got, ci, near
        for k, v in gaps.items():   # a NaN anywhere is a gap of NaN
            out[k] = v if not np.isfinite(v) else max(out[k], v)
    return out
