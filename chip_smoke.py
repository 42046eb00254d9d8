#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit's ``nvcc`` and ``nvidia-smi``;
imports nothing of JAX or of the ``mba_tpu`` package.  Phases, each of
which raises on failure (the script then exits non-zero and prints no
result):

1. the card: name and power limit from ``nvidia-smi``, torch and CUDA
   versions.  Without a card the script stops here with exit code 1;
2. build the hand-written kernels from ``mba_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with CUDA-event times of both;
4. the port on a small input on the card against the same call on the
   CPU, where every kernel wrapper runs its plain version;
5. the main paths at ``bench.py``'s configuration, each with every
   launch count set to 0 just before it and read just after: (a)
   multitaper CMC with jackknife CIs and the EMG max-pool over 64×64
   pairs, 120 s at 2048 Hz (bench.py:42-70, 135-162); (b) the cohort FWE
   rotation null, 12 subjects × 120 s × 64×64, 10 000 surrogates,
   13-100 Hz (bench.py:247-311), with the gram coefficient pass; (c) the
   same null with ``coeff_engine='pallas'``, whose pair pass is kernel
   B3, its observed map held to (b)'s; then the ``'xla'`` engine's
   coefficient pass alone (plain PyTorch, no kernel) on the same cohort.
   Each kernel of a path must have launched; the CMC must peak in the
   planted 15-30 Hz band and each null must detect the planted coupling;
6. the per-window rotation null on 12 subjects × 120 s × 8×8 pairs,
   2 000 surrogates, and the full-FFT null on 2 subjects × 12 s × 8×8,
   200 surrogates, whose flop rate sets the CUDA default of
   ``cohort_msc_null``'s ``fft_flop_budget``; both must detect the
   planted coupling;
7. one JSON line describing the kernels, then the result line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import mba_tpu_torch
from mba_tpu_torch import _build
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.ops import coherence as TC
from mba_tpu_torch.ops import cuda_coeffs, cuda_msc, cuda_null
from mba_tpu_torch.ops.dpss import filtered_tapers
from mba_tpu_torch.ops.framing import frame_signal, window_grid
from mba_tpu_torch.ops.rotation_coeffs import band_spectra

FS = 2048.0
SECONDS = 120.0
WINDOW_SEC = 2.0
OVERLAP = 0.5
N_EEG = 64
N_EMG = 64
NW = 3
N_SUBJECTS = 12
N_SURROGATES = 10_000
BAND = (13.0, 100.0)
SURROGATE_CHUNK = 500
WINDOW_CHUNK = 32       # cohort_msc_rotation_null's default
PW_CHANNELS = 8         # the per-window and full-FFT nulls' pairs: 8×8
PW_SURROGATES = 2000
FFT_SUBJECTS, FFT_SECONDS, FFT_SURROGATES = 2, 12.0, 200
FFT_BUDGET_SEC = 3.0    # cohort_msc_null's CUDA budget: ~3 s of this phase

MSC_ATOL = 5e-5         # Pallas vs XLA, tests/test_ops_coherence.py:217
NULL_TOL = 1e-5         # max_stat, rel and abs
COEFF_RTOL, COEFF_ATOL = 2e-5, 2e-6   # B3 sums / weight sum, cuda_coeffs.py
GRAM_RTOL, GRAM_ATOL = 2e-4, 2e-5     # × max; tests/test_gram_coeffs.py:65
TIE_FRACTION = 1e-4     # cells whose argmax pick or count may differ


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def make_signals(seed, n_eeg, n_emg, seconds):
    """bench.py:55-70: a 15-30 Hz shared drive (amplitude 0.4) under
    unit white noise in every channel, float32."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    f = np.fft.rfftfreq(n, 1 / FS)
    spec[(f < 15) | (f > 30)] = 0
    shared = np.fft.irfft(spec, n=n)
    shared /= shared.std() + 1e-12
    eeg = (0.4 * shared[:, None]
           + rng.standard_normal((n, n_eeg))).astype(np.float32)
    emg = (0.4 * shared[:, None]
           + rng.standard_normal((n, n_emg))).astype(np.float32)
    return eeg, emg


def make_cohort(n_subjects, seconds, n_eeg, n_emg, seed=9):
    """bench.py:261-279: a random-phase 15-30 Hz drive (amplitude 0.25)
    shared by every channel of every subject, under unit noise."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    f = np.fft.rfftfreq(n, 1 / FS)
    sel = (f >= 15) & (f <= 30)
    spec = np.zeros(len(f), np.complex64)
    spec[sel] = np.exp(1j * rng.uniform(0, 2 * np.pi, int(sel.sum())))
    shared = np.fft.irfft(spec, n=n).astype(np.float32)
    shared /= shared.std() + 1e-12
    eeg = np.stack([0.25 * shared[:, None]
                    + rng.standard_normal((n, n_eeg)).astype(np.float32)
                    for _ in range(n_subjects)])
    emg = np.stack([0.25 * shared[:, None]
                    + rng.standard_normal((n, n_emg)).astype(np.float32)
                    for _ in range(n_subjects)])
    return eeg, emg


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events, after one warm
    call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _np(d: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in d.items()}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main_path_msc_chunk(eeg, emg, device):
    """The tapered spectra of the main path's first window chunk: the
    exact operands ``multitaper_msc`` hands to the B1 wrapper."""
    ws = int(WINDOW_SEC * FS)
    tapers = filtered_tapers(ws, NW, 0.9)
    K = tapers.shape[0]
    W = TC._auto_chunk(ws, K, eeg.shape[1], emg.shape[1], True, fused=True)
    starts, _ = window_grid(eeg.shape[0], ws, int(ws * (1 - OVERLAP)), FS)
    starts = starts[:W]
    n = int(starts[-1]) + ws
    tap = torch.as_tensor(tapers, dtype=torch.float32, device=device)
    spec = [TC.tapered_rfft(frame_signal(torch.from_numpy(x[:n]).to(device),
                                         starts, ws), tap)
            for x in (eeg, emg)]
    return spec[0], spec[1], TC.jackknife_t_crit(K, 0.05)


def check_msc_kernel(eeg, emg, device, reps=5) -> dict:
    """B1 against its plain version in both EMG modes.  Coherence within
    MSC_ATOL; CIs within ``cuda_msc.ci_tolerance``: MSC_ATOL, plus the
    float32 rounding of the jackknife replicates that Fisher z amplifies
    where a replicate nears 1.  In the EMG-max mode the CIs are compared
    where the two argmax picks agree, and the picks may differ
    (near-ties) in at most TIE_FRACTION of the cells."""
    e, m, t_crit = main_path_msc_chunk(eeg, emg, device)
    kf = _np(cuda_msc.msc_jackknife(e, m, t_crit, emg_max=False))
    km = _np(cuda_msc.msc_jackknife(e, m, t_crit, emg_max=True))
    pf = _np(cuda_msc.msc_jackknife_plain(e, m, t_crit, emg_max=False))
    pm = _np(cuda_msc.msc_jackknife_plain(e, m, t_crit, emg_max=True))
    tol = cuda_msc.ci_tolerance(
        cuda_msc.loo_coherence_max(e, m).cpu().numpy(), MSC_ATOL)
    p_idx = np.argmax(pf["coherence"], axis=-1)
    # the kernel's pick: where its full grid holds its EMG-max value
    k_idx = np.argmin(np.abs(kf["coherence"] - km["coherence"][..., None]),
                      axis=-1)
    same = k_idx == p_idx
    tie_frac = float(1.0 - same.mean())
    tol_max = np.take_along_axis(tol, p_idx[..., None], -1)[..., 0]
    errs, excess, over_atol = {}, {}, {}
    for mode, k, p, t, sel in (("full", kf, pf, tol, ...),
                               ("max", km, pm, tol_max, same)):
        for key in ("coherence", "ci_lower", "ci_upper"):
            _require(bool(np.isfinite(k[key]).all()),
                     f"B1 {mode} {key}: non-finite values")
            d = np.abs(k[key] - p[key])
            if key != "coherence":
                d, bound = d[sel], t[sel]
            else:
                bound = MSC_ATOL
            name = f"{mode}_{key}"
            errs[name] = float(d.max())
            excess[name] = float((d / bound).max())
            over_atol[name] = int((d > MSC_ATOL).sum())
    max_err = max(errs.values())
    log(json.dumps({"check": "msc_jackknife", "shape": list(e.shape),
                    "max_abs_err": errs, "max_err_over_tolerance": excess,
                    "cells_over_atol": over_atol,
                    "argmax_pick_differs": tie_frac, "atol": MSC_ATOL}))
    _require(max(excess.values()) <= 1.0,
             f"B1 disagrees with its plain version: {excess}")
    _require(tie_frac <= TIE_FRACTION,
             f"B1 argmax picks differ in {tie_frac:.2e} of cells")
    ms = cuda_ms(lambda: cuda_msc.msc_jackknife(e, m, t_crit), reps)
    plain_ms = cuda_ms(lambda: cuda_msc.msc_jackknife_plain(e, m, t_crit),
                       reps)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def null_check_state(device, K=5, seed=0):
    """Random rotation-null state at the main path's shapes: nF band
    bins of 13-100 Hz at 2-s windows, J subjects, N = E·M cells and
    P = K(K−1) features."""
    J, N = N_SUBJECTS, N_EEG * N_EMG
    ws = int(WINDOW_SEC * FS)
    freqs = np.fft.rfftfreq(ws, 1 / FS)
    nF = int(np.searchsorted(freqs, BAND[1], side="right")
             - np.searchsorted(freqs, BAND[0], side="left"))
    P = K * (K - 1)
    g = torch.Generator(device).manual_seed(seed)
    coef = 0.05 * torch.randn((J, nF, N, P), generator=g, device=device)
    base = 0.1 + 0.2 * torch.rand((nF, N), generator=g, device=device)
    obs = base - 0.05 + 0.25 * torch.rand((nF, N), generator=g,
                                          device=device)
    return TN.null_state(base, coef, obs), g, K


def check_null_kernel(device, reps=10) -> dict:
    """B2 against its plain version at S = 500 (the main path's chunk)
    and S = 13 (padded rows must not count).  max_stat within NULL_TOL;
    counts equal but in at most TIE_FRACTION of the cells, by one, where
    float32 accumulation order moves a stat across obs."""
    state, g, K = null_check_state(device)
    J = state.n_subjects
    nF = state.coefT.shape[0]
    out = {}
    for S in (SURROGATE_CHUNK, 13):
        G = cuda_null.null_features(TN.phase_features(
            TN.draw_phases(g, J, S, K, nF)))
        ms, cnt = cuda_null.null_tile(G, state.coefT, state.base_flat,
                                      state.observed_flat, J)
        ms_p, cnt_p = cuda_null.null_tile_plain(
            G, state.coefT, state.base_flat, state.observed_flat, J)
        _require(bool(torch.isfinite(ms).all()), "B2: non-finite max_stat")
        err = float((ms - ms_p).abs().max())
        rel_ok = bool(((ms - ms_p).abs()
                       <= NULL_TOL + NULL_TOL * ms_p.abs()).all())
        diff = (cnt - cnt_p).abs()
        cnt_frac = float((diff > 0).float().mean())
        log(json.dumps({"check": "null_tile", "S": S,
                        "shape": [nF, S, G.shape[2], state.coefT.shape[2]],
                        "max_stat_abs_err": err,
                        "count_cells_differ": cnt_frac,
                        "count_max_diff": int(diff.max()),
                        "tol": NULL_TOL}))
        _require(rel_ok, f"B2 max_stat disagrees (S={S}): {err}")
        _require(int(diff.max()) <= 1 and cnt_frac <= TIE_FRACTION,
                 f"B2 counts disagree (S={S}): {cnt_frac:.2e} of cells")
        _require(int(cnt.max()) <= S, "B2 counted more than S surrogates")
        if S == SURROGATE_CHUNK:
            out = {"max_abs_err": err}
            args = (G, state.coefT, state.base_flat, state.observed_flat, J)
            out["ms"] = cuda_ms(lambda: cuda_null.null_tile(*args), reps)
            out["plain_ms"] = cuda_ms(
                lambda: cuda_null.null_tile_plain(*args), reps)
    return out


def check_coeff_kernel(cohort, device, reps=10) -> dict:
    """B3 against its plain version at the main path's chunk: the first
    WINDOW_CHUNK windows of the bench cohort's first subject, their
    weights from the disjoint subset (so half of them are 0), K = 5,
    13-100 Hz (nF = 175), 64×64.  The sums over the chunk's weight sum
    within COEFF_RTOL / COEFF_ATOL."""
    ws = int(WINDOW_SEC * FS)
    tapers = torch.as_tensor(filtered_tapers(ws, NW, 0.9),
                             dtype=torch.float32, device=device)
    _, lo, hi = TN._band_bins(ws, FS, BAND)
    starts, _ = window_grid(cohort[0].shape[1], ws, int(ws * (1 - OVERLAP)),
                            FS)
    weights = TN.disjoint_window_weights(
        starts[None], np.ones((1, len(starts)), np.float32), ws)[0]
    cs = torch.as_tensor(starts[:WINDOW_CHUNK], device=device)
    w = torch.as_tensor(weights[:WINDOW_CHUNK], device=device)
    e, m = (band_spectra(torch.from_numpy(x[0]).to(device), cs, tapers, ws,
                         lo, hi) for x in cohort)
    got = cuda_coeffs.coeff_pairs(e, m, w)
    ref = cuda_coeffs.coeff_pairs_plain(e, m, w)
    wsum = float(w.sum())
    errs, excess = {}, {}
    for name, a, b in zip(("diag", "pr", "pi"), got, ref):
        _require(bool(torch.isfinite(a).all()), f"B3 {name}: non-finite")
        d = (a - b).abs() / wsum
        bound = COEFF_ATOL + COEFF_RTOL * b.abs() / wsum
        errs[name] = float(d.max())
        excess[name] = float((d / bound).max())
    log(json.dumps({"check": "coeff_pairs", "shape": [list(e.shape),
                                                      list(m.shape)],
                    "weight_sum": wsum, "max_abs_err_over_wsum": errs,
                    "max_err_over_tolerance": excess,
                    "rtol": COEFF_RTOL, "atol": COEFF_ATOL}))
    _require(max(excess.values()) <= 1.0,
             f"B3 disagrees with its plain version: {excess}")
    ms = cuda_ms(lambda: cuda_coeffs.coeff_pairs(e, m, w), reps)
    plain_ms = cuda_ms(lambda: cuda_coeffs.coeff_pairs_plain(e, m, w), reps)
    return {"max_abs_err": max(errs.values()) * wsum, "ms": ms,
            "plain_ms": plain_ms}


def _require_close_observed(got, ref, what) -> None:
    """Observed maps within the gram tolerance."""
    sc = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    log(json.dumps({"check": what, "max_abs_err": err}))
    _require(np.allclose(got, ref, rtol=GRAM_RTOL, atol=GRAM_ATOL * sc),
             f"{what}: {err}")


def check_small_against_cpu(device) -> None:
    """The port's entry points on a small input, on the card and on the
    CPU (plain versions; the CPU tests tie those to ``mba_tpu``): the
    CMC, the rotation null with each coefficient engine and in the
    per-window mode, and the full-FFT null."""
    eeg, emg = make_signals(1, 8, 8, 8.0)
    kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP)
    got = TC.multitaper_msc(eeg, emg, FS, device=device, **kw)
    ref = TC.multitaper_msc(eeg, emg, FS, device="cpu", **kw)
    ws = int(WINDOW_SEC * FS)
    starts, _ = window_grid(len(eeg), ws, int(ws * (1 - OVERLAP)), FS)
    tap = torch.as_tensor(filtered_tapers(ws, NW, 0.9), dtype=torch.float32)
    e, m = (TC.tapered_rfft(frame_signal(torch.from_numpy(x), starts, ws),
                            tap) for x in (eeg, emg))
    tol = cuda_msc.ci_tolerance(cuda_msc.loo_coherence_max(e, m).numpy(),
                                MSC_ATOL)
    for key in ("coherence_raw", "coherence_ci_lower", "coherence_ci_upper"):
        d = np.abs(got[key] - ref[key])
        bound = MSC_ATOL if key == "coherence_raw" else tol
        log(json.dumps({"check": f"multitaper_msc small, card vs cpu: {key}",
                        "max_abs_err": float(d.max()),
                        "max_err_over_tolerance": float((d / bound).max())}))
        _require(bool((d <= bound).all()),
                 f"multitaper_msc {key}: card vs cpu {float(d.max())}")
    ce, cm = make_cohort(2, 12.0, 8, 8)
    kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
              band=BAND, n_surrogates=1000, surrogate_chunk=SURROGATE_CHUNK)
    for extra in ({}, dict(coeff_engine="pallas"), dict(coeff_engine="xla"),
                  dict(rotation_mode="per_window")):
        got = TN.cohort_msc_rotation_null(ce, cm, FS, device=device, **kw,
                                          **extra)
        ref = TN.cohort_msc_rotation_null(ce, cm, FS, device="cpu", **kw,
                                          **extra)
        _require_close_observed(
            got["observed"], ref["observed"],
            f"rotation null {extra or 'gram'} small, card vs cpu: observed")
        _require(got["max_stat"].shape == (1000,)
                 and bool(np.isfinite(got["max_stat"]).all()),
                 f"small null {extra}: bad max_stat")
    kw_fft = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
                  band=BAND, n_surrogates=16)
    got = TN.cohort_msc_fft_null(ce, cm, FS, device=device, **kw_fft)
    ref = TN.cohort_msc_fft_null(ce, cm, FS, device="cpu", **kw_fft)
    _require_close_observed(got["observed"], ref["observed"],
                            "fft null small, card vs cpu: observed")
    _require(bool(np.isfinite(got["max_stat"]).all()),
             "small fft null: bad max_stat")


def run_cmc(eeg, emg, device) -> dict:
    kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
              use_jackknife=True, aggregate_emg_max=True,
              apply_independence_threshold=False, collect_timings=True)
    t0 = time.perf_counter()
    res = TC.multitaper_msc(eeg, emg, FS, device=device, **kw)
    wall = time.perf_counter() - t0
    coh = res["coherence_raw"]
    n_windows = res["metadata"]["n_windows"]
    _require(coh.shape == (n_windows, int(WINDOW_SEC * FS) // 2 + 1, N_EEG),
             f"CMC shape {coh.shape}")
    lo, hi = res["coherence_ci_lower"], res["coherence_ci_upper"]
    _require(bool(np.isfinite(coh).all() and np.isfinite(lo).all()
                  and np.isfinite(hi).all()), "CMC: non-finite values")
    _require(bool((lo <= coh).all() and (coh <= hi).all()),
             "CMC: CIs do not contain the estimate")
    spectrum = coh.mean(axis=(0, 2))
    f_peak = float(res["freqs"][int(np.argmax(spectrum[1:])) + 1])
    _require(15.0 <= f_peak <= 30.0, f"CMC peaks at {f_peak} Hz")
    return {"wall_sec": wall, "n_windows": n_windows,
            "spectra_per_sec": n_windows * N_EEG * N_EMG / wall,
            "peak_hz": f_peak, "timings": res["timings"]}


def run_null(eeg, emg, device, n_surrogates=N_SURROGATES, **extra):
    """One rotation null; returns (summary dict, observed map)."""
    kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
              band=BAND, surrogate_chunk=SURROGATE_CHUNK, verbose=True)
    t0 = time.perf_counter()
    res = TN.cohort_msc_rotation_null(eeg, emg, FS, device=device,
                                      n_surrogates=n_surrogates, **kw,
                                      **extra)
    wall = time.perf_counter() - t0
    _require(res["max_stat"].shape == (n_surrogates,),
             f"max_stat shape {res['max_stat'].shape}")
    _require(bool(np.isfinite(res["max_stat"]).all()
                  and np.isfinite(res["observed"]).all()),
             "null: non-finite values")
    _require(res["p_fwe"] < 0.01, f"null {extra} p_fwe {res['p_fwe']}: the "
             "planted coupling was not detected")
    t = res["metadata"]["timings"]
    return {"wall_sec": wall, "p_fwe": res["p_fwe"],
            "observed_max": float(res["observed"].max()),
            "null_q95": res["null_quantiles"][0.95],
            "precompute_sec": t["precompute_sec"], "null_sec": t["null_sec"],
            "coeffs_sec": t["coeffs_sec"], "upload_sec": t["upload_sec"],
            "coeff_engine": t["coeff_engine"],
            "contraction_flops": res["metadata"]["contraction_flops"]}, \
        res["observed"]


def run_fft_null(cohort, device) -> dict:
    """The full-FFT null at its small scale, and its flop rate
    (``cohort_null.fft_null_flops`` over ``null_sec``)."""
    eeg, emg = cohort
    J, n, nE = eeg.shape
    ws = int(WINDOW_SEC * FS)
    t0 = time.perf_counter()
    res = TN.cohort_msc_fft_null(eeg, emg, FS, device=device,
                                 n_surrogates=FFT_SURROGATES, nw=NW,
                                 window_length_sec=WINDOW_SEC,
                                 overlap_frac=OVERLAP, band=BAND)
    wall = time.perf_counter() - t0
    _require(bool(np.isfinite(res["max_stat"]).all()
                  and np.isfinite(res["observed"]).all()),
             "fft null: non-finite values")
    _require(res["p_fwe"] < 0.01, f"fft null p_fwe {res['p_fwe']}: the "
             "planted coupling was not detected")
    W = (n - ws) // int(ws * (1 - OVERLAP)) + 1
    flops = TN.fft_null_flops(J, n, nE, emg.shape[2], W,
                              res["metadata"]["K_tapers"], ws,
                              len(res["freqs"]), FFT_SURROGATES)
    t = res["metadata"]["timings"]
    rate = flops / t["null_sec"]
    return {"wall_sec": wall, "p_fwe": res["p_fwe"],
            "precompute_sec": t["precompute_sec"], "null_sec": t["null_sec"],
            "estimated_flops": flops, "flop_rate": rate,
            "budget_for_3s": rate * FFT_BUDGET_SEC,
            "fft_flop_budget_cuda": TN.FFT_FLOP_BUDGET["cuda"]}


def reset_launches() -> None:
    cuda_msc.msc_jackknife.launches = 0
    cuda_null.null_tile.launches = 0
    cuda_coeffs.coeff_pairs.launches = 0
    torch.cuda.reset_peak_memory_stats()


def launches() -> dict:
    return {"msc_jackknife": cuda_msc.msc_jackknife.launches,
            "null_tile": cuda_null.null_tile.launches,
            "coeff_pairs": cuda_coeffs.coeff_pairs.launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card and nowhere else",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_name_and_power()
    log(card)
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "mba_tpu_torch": mba_tpu_torch.__version__,
                    "device": torch.cuda.get_device_name(0),
                    "tf32_matmul": torch.backends.cuda.matmul.allow_tf32}))

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(json.dumps({"phase": "build", "sec": time.perf_counter() - t0,
                    "library": lib_path.name,
                    "sources": [p.name for p in _build.sources()]}))

    eeg, emg = make_signals(0, N_EEG, N_EMG, SECONDS)
    msc = check_msc_kernel(eeg, emg, device)
    null = check_null_kernel(device)
    cohort = make_cohort(N_SUBJECTS, SECONDS, N_EEG, N_EMG)
    coeff = check_coeff_kernel(cohort, device)
    torch.cuda.empty_cache()
    check_small_against_cpu(device)
    # warm calls (cuFFT plans, cuBLAS handles) outside the counted runs
    TC.multitaper_msc(eeg[:int(12 * FS)], emg[:int(12 * FS)], FS,
                      device=device, window_length_sec=WINDOW_SEC,
                      aggregate_emg_max=True)
    for engine in ("gram", "pallas"):
        TN.cohort_msc_rotation_null(cohort[0][:2], cohort[1][:2], FS,
                                    device=device, coeff_engine=engine,
                                    n_surrogates=SURROGATE_CHUNK,
                                    surrogate_chunk=SURROGATE_CHUNK,
                                    band=BAND)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    reset_launches()
    cmc = run_cmc(eeg, emg, device)
    cmc["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    n_cmc = launches()
    _require(n_cmc["msc_jackknife"] > 0,
             "the CMC main path did not launch the B1 kernel")
    log(json.dumps({"phase": "cmc_main_path", "card": card, **cmc,
                    "launches": n_cmc}))
    del eeg, emg
    reset_launches()
    gram, observed_gram = run_null(*cohort, device)
    gram["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    n_gram = launches()
    _require(n_gram["null_tile"] > 0,
             "the null main path did not launch the B2 kernel")
    log(json.dumps({"phase": "null_main_path", "card": card, **gram,
                    "launches": n_gram}))
    reset_launches()
    pallas, observed_pallas = run_null(*cohort, device,
                                       coeff_engine="pallas")
    pallas["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    n_pallas = launches()
    _require(n_pallas["coeff_pairs"] > 0 and n_pallas["null_tile"] > 0,
             f"the 'pallas' null path did not launch B3 and B2: {n_pallas}")
    log(json.dumps({"phase": "null_pallas_engine_path", "card": card,
                    **pallas, "launches": n_pallas}))
    _require_close_observed(observed_pallas, observed_gram,
                            "null observed map: 'pallas' vs 'gram' engine")
    t0 = time.perf_counter()
    xla = TN.cohort_msc_rotation_null(
        *cohort, FS, device=device, coeff_engine="xla", precompute_only=True,
        nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP, band=BAND)
    t = xla["metadata"]["timings"]
    log(json.dumps({"phase": "xla_engine_precompute", "card": card,
                    "wall_sec": time.perf_counter() - t0,
                    "precompute_sec": t["precompute_sec"],
                    "coeffs_sec": t["coeffs_sec"],
                    "upload_sec": t["upload_sec"],
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    _require_close_observed(xla["observed"], observed_gram,
                            "null observed map: 'xla' vs 'gram' engine")
    torch.cuda.empty_cache()

    pw_cohort = tuple(np.ascontiguousarray(x[..., :PW_CHANNELS])
                      for x in cohort)
    del cohort
    reset_launches()
    pw, _ = run_null(*pw_cohort, device, n_surrogates=PW_SURROGATES,
                     rotation_mode="per_window")
    pw["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(json.dumps({"phase": "per_window_null", "card": card, **pw,
                    "launches": launches()}))
    del pw_cohort
    torch.cuda.empty_cache()
    reset_launches()
    fft = run_fft_null(make_cohort(FFT_SUBJECTS, FFT_SECONDS, PW_CHANNELS,
                                   PW_CHANNELS), device)
    fft["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(json.dumps({"phase": "fft_null", "card": card, **fft,
                    "launches": launches()}))

    kernels = [
        {"name": "msc_jackknife", "route": "cuda",
         "source": "mba_tpu_torch/csrc/msc_jackknife.cu",
         "replaces": "mba_tpu/ops/pallas_msc.py:40",
         "launches": n_cmc["msc_jackknife"], **msc},
        {"name": "null_tile", "route": "cuda",
         "source": "mba_tpu_torch/csrc/null_tile.cu",
         "replaces": "mba_tpu/ops/pallas_null.py:37",
         "launches": n_gram["null_tile"], **null},
        {"name": "coeff_pairs", "route": "cuda",
         "source": "mba_tpu_torch/csrc/coeff_pairs.cu",
         "replaces": "mba_tpu/ops/pallas_coeffs.py:83",
         "launches": n_pallas["coeff_pairs"], **coeff},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
