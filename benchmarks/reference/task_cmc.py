"""Plain reference of the study's task-wise CMC, and the comparison that
decides ``correct`` in its cells.

The task mask is built anew from the raw experiment log, by the
upstream study's rules (``src/pipeline/signal_features.py:842-895`` and
the task start and end helpers of ``src/pipeline/data_integration.py``):
a trial's task runs from its "Starting motor task" row to the last row
at least ``rmse_delay_sec`` before its "Achieved RMSE" row; its start is
moved by the latency, its end by the latency less the cut-off; both are
taken from the recording's start, ``trigger_latency_sec`` after the
Start Trigger; and a window is active where its centre lies within the
buffers of some task.  The EEG channels are taken by the
configuration's indices, and the active windows' jackknifed CMC is
``reference/cmc.py``'s, in float64, with its EMG max-pool.

The gaps are ``reference/cmc.py``'s, each further weighed by the cell's
leave-one-out conditioning (``loo_kappa``): float32 forms a leave-one-out
power as total − taper k's, which magnifies the rounding of the total by
κ = total / (total − taper k's).  Where one taper carries nearly all of
a cell's power, most often at the real-valued 0-Hz and Nyquist bins
where a power has one degree of freedom instead of two, κ reaches
1e3-1e4 over a session's ~1e6 cells a frequency, and the reference's own
float32 arithmetic then misses its float64 by more than a limit.  A cell
with κ above ``KAPPA`` has its gaps scaled by ``KAPPA`` / κ; every other
cell is compared as in ``reference/cmc.py``.
"""
from __future__ import annotations

import re

import numpy as np
import scipy.stats
import torch

from benchmarks.reference.cmc import TIE, _BYTES_PER_CELL, jackknife
from benchmarks.reference.spectra import tapered_spectra, tapers, \
    window_starts

_TASK_START = re.compile(r"Starting(?!\s+test)\s+motor task")
# the leave-one-out conditioning up to which a cell's gaps are taken
# whole: at most 4 of float32's 24 bits lost to total − taper k's
KAPPA = 16.0
_TINY64 = float(np.finfo(np.float64).tiny)


def task_spans(rows, m: dict) -> list[tuple[float, float]]:
    """Each trial's task as (start, end) in seconds from the recording's
    start.  ``rows``: the raw log's rows in time order, (seconds, event,
    questionnaire); ``m``: the configuration's ``task_mask``."""
    origin = next(t for t, event, _ in rows if event == "Start Trigger") \
        + m["trigger_latency_sec"]
    times = np.array([t for t, _, _ in rows])
    spans, opened = [], None
    for t, _, text in rows:
        if _TASK_START.search(text):
            opened = t
        elif "Achieved RMSE" in text and opened is not None:
            last = times[(times >= opened)
                          & (times <= t - m["rmse_delay_sec"])].max()
            spans.append((opened + m["latency_sec"] - origin,
                          last + m["latency_sec"] - m["end_cutoff_sec"]
                          - origin))
            opened = None
    return spans


def active_windows(n_samples: int, p: dict, spans, m: dict) -> np.ndarray:
    """The windows whose centre lies within a task's buffers (bool)."""
    ws = int(p["window_sec"] * p["fs"])
    centres = (window_starts(n_samples, ws, p["overlap"]) + ws / 2) / p["fs"]
    mask = np.zeros(len(centres), bool)
    for a, b in spans:
        mask |= (centres >= a - m["pre_buffer_sec"]) \
            & (centres <= b + m["post_buffer_sec"])
    return mask


def runs(mask: np.ndarray) -> int:
    """The runs of consecutive active windows."""
    return int(np.count_nonzero(np.diff(mask.astype(np.int8),
                                        prepend=0) == 1))


def loo_kappa(X: torch.Tensor) -> torch.Tensor:
    """(w, K, F, C) spectra → (w, F, C): the largest, over the tapers k,
    of a cell's total power over its leave-one-out power, total − taper
    k's (K / (K − 1) for tapers of equal power; 0 for a cell of none)."""
    p = X.real ** 2 + X.imag ** 2
    total = p.sum(1, keepdim=True)
    return (total / torch.clamp_min(total - p, _TINY64)).amax(1)


def gaps(Xe: torch.Tensor, Xm: torch.Tensor, got: dict,
         t_crit: float) -> dict:
    """``coherence_gap`` and ``ci_gap`` of the program's max-pooled
    (w, F, E) ``coherence``, ``lower`` and ``upper`` against the float64
    jackknife of the (w, K, F, E) and (w, K, F, M) spectra, as
    ``reference/cmc.py:compare`` forms them, each cell's weighed by
    min(1, KAPPA / κ), κ the larger of its EEG and EMG ``loo_kappa``
    (the coherence's at the reference's pick)."""
    ref = jackknife(Xe, Xm, t_crit)
    weight = torch.clamp(
        KAPPA / torch.maximum(loo_kappa(Xe)[..., :, None],
                              loo_kappa(Xm)[..., None, :]), max=1.0)
    cmax, pick = ref["coherence"].max(-1)
    gap = (got["coherence"] - cmax).abs() \
        * weight.gather(-1, pick[..., None])[..., 0]
    near = ref["coherence"] >= (cmax - TIE)[..., None]
    ci = torch.maximum((got["lower"][..., None] - ref["lower"]).abs(),
                       (got["upper"][..., None] - ref["upper"]).abs())
    ci = torch.where(near, ci * (1 - ref["loo_max"]) * weight, torch.inf)
    return {"coherence_gap": float(gap.max()),
            "ci_gap": float(ci.amin(-1).max())}


def compare(program: dict, eeg: np.ndarray, emg: np.ndarray,
            channels, active: np.ndarray, p: dict, device,
            dtype=torch.float64, budget_bytes: float = 12e9) -> dict:
    """The numbers compared for one task-wise CMC call.

    program: the call's full-grid (W, F, E) ``coherence``, ``lower`` and
    ``upper``; eeg (n, 64) and emg (n, M) the float32 input; channels
    the EEG subset's indices; active the reference's task mask; p the
    call's parameters (fs, window_sec, overlap, nw, taper_threshold,
    alpha).  Returns, in order, ``coherence_gap`` and ``ci_gap`` over
    the active windows (``gaps``),
    ``masked_nonzero`` (the masked windows with any value not exactly 0)
    and ``mask_mismatch`` (the windows whose state, any value not 0,
    differs from the reference's mask).
    """
    ws = int(p["window_sec"] * p["fs"])
    tap = torch.as_tensor(tapers(ws, p["nw"], p["taper_threshold"]),
                          dtype=dtype, device=device)
    K = tap.shape[0]
    t_crit = float(scipy.stats.t.ppf(1 - p["alpha"] / 2, K - 1))
    starts = window_starts(len(eeg), ws, p["overlap"])
    want = (len(starts), ws // 2 + 1, len(channels))
    shapes = {k: np.shape(program[k]) for k in ("coherence", "lower",
                                                "upper")}
    if any(s != want for s in shapes.values()) or active.shape != want[:1]:
        raise ValueError(f"program results have shapes {shapes}, the "
                         f"reference {want}, the mask {active.shape}")
    computed = np.zeros(want[0], bool)
    for k in shapes:
        computed |= np.any(program[k] != 0, axis=(1, 2))
    out = {"coherence_gap": 0.0, "ci_gap": 0.0}
    x_e = torch.from_numpy(np.ascontiguousarray(eeg[:, list(channels)])
                           ).to(device)
    x_m = torch.from_numpy(np.ascontiguousarray(emg)).to(device)
    rows = np.flatnonzero(active)
    cells = K * want[1] * len(channels) * emg.shape[1]
    chunk = max(1, int(budget_bytes // (_BYTES_PER_CELL * cells)))
    for c0 in range(0, len(rows), chunk):
        w = rows[c0:c0 + chunk]
        got = {k: torch.from_numpy(program[k][w]).to(device, dtype)
               for k in shapes}
        found = gaps(tapered_spectra(x_e, starts[w], ws, tap),
                     tapered_spectra(x_m, starts[w], ws, tap), got, t_crit)
        del got
        for k, v in found.items():   # a NaN anywhere is a gap of NaN
            out[k] = v if not np.isfinite(v) else max(out[k], v)
    out["masked_nonzero"] = int(np.count_nonzero(computed & ~active))
    out["mask_mismatch"] = int(np.count_nonzero(computed != active))
    return out
