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
7. the feature-extraction stage and the phase-randomised null: (f) each
   entry point small on the card against the CPU; (g) one subject at
   study scale (1 698 s at 2048 Hz, 64-ch EEG and two 64-ch EMG grids):
   the log10 PSD of all three kept on the card and reduced to band
   aggregates there, then the task-wise CMC of the 11-channel motor
   subset against each grid with kernel B1 (its launch count set to 0
   before and read after; the CMC must peak in the planted 15-30 Hz
   band); (h) B1 against its plain version at that narrow montage,
   11×64; (i) bench.py's config 4, the single-pair 10 000-surrogate
   phase null, uncoupled (p_fwe ≥ 0.01) and coupled (p_fwe < 0.01);
8. one JSON line describing the kernels, then the result line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import datetime
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
from mba_tpu_torch.ops import spectral as TS
from mba_tpu_torch.ops import surrogate as TSu
from mba_tpu_torch.ops.dpss import filtered_tapers
from mba_tpu_torch.ops.framing import frame_signal, window_grid
from mba_tpu_torch.ops.rotation_coeffs import band_spectra
from mba_tpu_torch.pipeline import signal_features as TF
from mba_tpu_torch.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET

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

# one subject's recording (bench.py:314-323): 30 trials of 45 s with 12-s
# silences between them, 1 698 s; the feature-extraction settings of
# subject_feature_extraction_workflow (PSD 0.25-s windows; CMC 2-s
# windows, 3-s buffers, 3.25-s latency, 2-s end cut)
N_TRIALS, TRIAL_SEC, SILENCE_SEC = 30, 45.0, 12.0
PSD_WINDOW_SEC = 0.25
CMC_BUFFER_SEC, TASK_LATENCY_SEC, TASK_END_CUT_SEC = 3.0, 3.25, 2.0
# bench.py config 4 (bench.py:203-225): one pair, 120 s, 10 000 surrogates
PHASE_SURROGATES, PHASE_CHUNK, PHASE_COUPLED_SURROGATES = 10_000, 250, 1000

MSC_ATOL = 5e-5         # Pallas vs XLA, tests/test_ops_coherence.py:217
NULL_TOL = 1e-5         # max_stat, rel and abs
COEFF_RTOL, COEFF_ATOL = 2e-5, 2e-6   # B3 sums / weight sum, cuda_coeffs.py
GRAM_RTOL, GRAM_ATOL = 2e-4, 2e-5     # × max; tests/test_gram_coeffs.py:65
TIE_FRACTION = 1e-4     # cells whose argmax pick or count may differ
# the feature stage's CPU tests (tests/test_torch_{spectral,signal_
# features,surrogate}.py)
PSD_RTOL, PSD_ATOL_REL, LOG_PSD_ATOL = 1e-4, 1e-6, 1e-4
WELCH_RTOL = 1e-4
BAND_RTOL, BAND_ATOL = 1e-6, 1e-7
PHASE_MAX_RTOL, PHASE_MAX_ATOL = 1e-4, 5e-5
QUANTILE_CELLS = 1e-3   # cells whose null quantile may move by one bin


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
    _require_close(what, got, ref, GRAM_RTOL,
                   GRAM_ATOL * float(np.abs(ref).max()))


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


_DRAW_PHASES = TSu.draw_chunk_phases


def _cpu_phase_draw(seed):
    """A stand-in for ``surrogate.draw_chunk_phases`` that draws each
    chunk's phases on the CPU from one fresh generator, so the card and
    the CPU null get the same phases."""
    gen = torch.Generator().manual_seed(seed)
    return lambda _gen, s, f, m, device: _DRAW_PHASES(gen, s, f, m,
                                                      "cpu").to(device)


def _require_close(what, got, ref, rtol, atol, equal_nan=False) -> None:
    """|got − ref| ≤ atol + rtol·|ref| everywhere (NaN where ``ref`` is
    NaN, with ``equal_nan``); logs the largest difference."""
    got, ref = np.asarray(got), np.asarray(ref)
    _require(got.shape == ref.shape, f"{what}: shape {got.shape} vs "
             f"{ref.shape}")
    d = np.abs(got.astype(np.float64) - ref)
    ok = d <= atol + rtol * np.abs(ref)
    if equal_nan:
        ok = np.where(np.isnan(ref), np.isnan(got), ok)
    err = float(np.nanmax(d)) if d.size else 0.0
    log(json.dumps({"check": what, "max_abs_err": err, "rtol": rtol,
                    "atol": atol}))
    _require(bool(ok.all()), f"{what}: {err}")


def _require_ci_close(what, got, ref, tol) -> None:
    """EMG-max CIs within ``tol`` (``cuda_msc.ci_tolerance`` of the
    largest replicate over EMG) but in at most TIE_FRACTION of the
    cells, where near-tied EMG channels may be picked differently."""
    over = float((np.abs(got - ref) > tol).mean())
    log(json.dumps({"check": what, "max_abs_err": float(np.abs(got - ref)
                                                        .max()),
                    "cells_over_tolerance": over}))
    _require(over <= TIE_FRACTION, f"{what}: {over:.2e} of cells differ")


def check_features_small_against_cpu(device) -> None:
    """(f) The feature stage and the phase null on a small input (8
    channels, a few seconds), on the card and on the CPU, with the CPU
    tests' tolerances: the multitaper PSD (linear and log10), Welch, the
    amplitude spectrum, the band aggregates of the card's spectrogram
    against the host path (NaN bins included), the task-wise CMC with a
    window mask in the fused and the threshold mode, and the phase null
    with the same phases injected on both."""
    eeg, emg = make_signals(2, 8, 8, 6.0)
    for log_scale in (False, True):
        kw = dict(nw=NW, window_length_sec=PSD_WINDOW_SEC,
                  overlap_frac=OVERLAP, axis=0, apply_log_scale=log_scale)
        spec, _, freqs = TS.multitaper_psd(eeg, FS, device=device,
                                           device_output=True, **kw)
        ref = TS.multitaper_psd(eeg, FS, device="cpu", **kw)[0]
        _require(spec.device.type == "cuda", "multitaper_psd left the card")
        _require_close(f"multitaper_psd small log10={log_scale}, card vs cpu",
                       spec.cpu().numpy(), ref, 0.0 if log_scale else PSD_RTOL,
                       LOG_PSD_ATOL if log_scale
                       else PSD_ATOL_REL * float(np.abs(ref).max()))
    spec[1] = float("nan")
    spec[2, 3:9, 0] = float("nan")
    payload, names, _ = TF.band_aggregate_spectrogram(spec, freqs)
    host, names_h, _ = TF.band_aggregate_spectrogram(spec.cpu().numpy(),
                                                     freqs)
    _require(payload.device.type == "cuda" and names == names_h,
             "band aggregates: not on the card, or other bands")
    _require_close("band aggregates small, card vs host",
                   payload.cpu().numpy(), host, BAND_RTOL, BAND_ATOL,
                   equal_nan=True)
    _require_close("welch_psd small, card vs cpu",
                   TS.welch_psd(eeg, FS, int(FS), device=device)[1],
                   TS.welch_psd(eeg, FS, int(FS), device="cpu")[1],
                   WELCH_RTOL, 0.0)
    amp = TS.amplitude_spectrum(eeg, FS, device="cpu")[0]
    _require_close("amplitude_spectrum small, card vs cpu",
                   TS.amplitude_spectrum(eeg, FS, device=device)[0], amp,
                   0.0, 1e-6 * float(amp.max()))

    ws = int(WINDOW_SEC * FS)
    starts, _ = window_grid(len(eeg), ws, int(ws * (1 - OVERLAP)), FS)
    mask = np.ones(len(starts), bool)
    mask[2] = False
    tap = torch.as_tensor(filtered_tapers(ws, NW, 0.9), dtype=torch.float32)
    e, m = (TC.tapered_rfft(frame_signal(torch.from_numpy(x), starts, ws),
                            tap) for x in (eeg, emg))
    tol = cuda_msc.ci_tolerance(
        cuda_msc.loo_coherence_max(e, m).numpy().max(-1), MSC_ATOL)
    for threshold in (False, True):
        kw = dict(window_size_sec=WINDOW_SEC, window_overlap_ratio=OVERLAP,
                  window_mask=mask, enforce_independence_threshold=threshold,
                  independence_threshold_alpha=1 - 1e-9)
        got = TF.compute_task_wise_aggregated_cmc(eeg, emg, int(FS), "flexor",
                                                  device=device, **kw)
        ref = TF.compute_task_wise_aggregated_cmc(eeg, emg, int(FS), "flexor",
                                                  device="cpu", **kw)
        mode = "threshold" if threshold else "fused"
        _require_close(f"task-wise CMC small {mode}, card vs cpu: "
                       "coherence", got[0], ref[0], 0.0, MSC_ATOL)
        for i, key in ((1, "ci_lower"), (2, "ci_upper")):
            _require_ci_close(f"task-wise CMC small {mode}, card vs cpu: "
                              f"{key}", got[i], ref[i], tol)
        _require(bool((got[0][~mask] == 0).all()),
                 "task-wise CMC: a masked window is not zero")

    pe, pm = make_signals(3, 2, 2, 8.0)
    kw = dict(window_length_sec=WINDOW_SEC, n_surrogates=200,
              surrogate_chunk=64, band=BAND)
    res = []
    for dev in (device, "cpu"):
        TSu.draw_chunk_phases = _cpu_phase_draw(5)
        res.append(TSu.msc_phase_randomized_null(pe, pm, FS, device=dev,
                                                 **kw))
    TSu.draw_chunk_phases = _DRAW_PHASES
    got, ref = res
    _require_close("phase null small, card vs cpu: observed",
                   got["observed"], ref["observed"], 0.0, MSC_ATOL)
    _require_close("phase null small, card vs cpu: max_stat",
                   got["max_stat"], ref["max_stat"], PHASE_MAX_RTOL,
                   PHASE_MAX_ATOL)
    _require(got["p_fwe"] == ref["p_fwe"], f"phase null small: p_fwe "
             f"{got['p_fwe']} vs {ref['p_fwe']}")
    for q, r in ref["null_quantiles"].items():
        d = np.abs(got["null_quantiles"][q] - r) * TSu.N_BINS
        log(json.dumps({"check": f"phase null small, card vs cpu: "
                        f"null_quantiles[{q}]", "bins_max_diff":
                        float(d.max()), "cells_differ": float(
                            (d > 0).mean())}))
        _require(d.max() <= 1 and (d > 0).mean() <= QUANTILE_CELLS,
                 f"phase null small: quantile {q} differs")


def make_recording(seed=4):
    """(g)'s input: one subject at study scale (bench.py:314-323), 64-ch
    EEG and two 64-ch EMG grids of unit float32 noise, 0.89 GB each,
    with a shared 15-30 Hz drive (amplitude 0.4, as :func:`make_signals`)
    during the trials only.  Returns (eeg, flexor, extensor, trial
    starts in seconds)."""
    rng = np.random.default_rng(seed)
    hop = TRIAL_SEC + SILENCE_SEC
    n = int(FS * (N_TRIALS * hop - SILENCE_SEC))
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1 / FS)
    spec[(f < 15) | (f > 30)] = 0
    shared = np.fft.irfft(spec, n=n)
    shared /= shared.std() + 1e-12
    trial_starts = np.arange(N_TRIALS) * hop
    on = np.zeros(n, bool)
    for t0 in trial_starts:
        on[int(t0 * FS):int((t0 + TRIAL_SEC) * FS)] = True
    drive = (0.4 * shared * on).astype(np.float32)[:, None]
    arrays = []
    for n_ch in (N_EEG, N_EMG, N_EMG):
        x = rng.standard_normal((n, n_ch), dtype=np.float32)
        x += drive
        arrays.append(x)
    return arrays[0], arrays[1], arrays[2], trial_starts


def _in_trials(centers, trial_starts):
    return np.any((centers[:, None] >= trial_starts)
                  & (centers[:, None] <= trial_starts + TRIAL_SEC), axis=1)


def run_psd(recording, device) -> dict:
    """(g), PSD: the three arrays as ``extract_psd_features`` computes
    them (0.25-s windows, nw 3, 50 % overlap, log10), kept on the card
    (``device_output``) and reduced there to the band aggregates.  Per
    array: upload (``torch.from_numpy(x).to(card)``), compute (PSD and
    band aggregates) and download (the aggregates).  The EEG's card
    aggregates are held to the host path on its downloaded spectrogram;
    in the trials the beta band must stand above gamma."""
    eeg, flexor, extensor, trial_starts = recording
    out = {}
    for modality, x in (("eeg", eeg), ("emg_1_flexor", flexor),
                        ("emg_2_extensor", extensor)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        xd = torch.from_numpy(x).to(device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        spec, tc, freqs = TF.multitaper_psd(
            xd, FS, nw=NW, window_length_sec=PSD_WINDOW_SEC,
            overlap_frac=OVERLAP, axis=0, apply_log_scale=True,
            device_output=True)
        payload, names, _ = TF.band_aggregate_spectrogram(spec, freqs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        agg = payload.cpu().numpy()
        t3 = time.perf_counter()
        ws = int(PSD_WINDOW_SEC * FS)
        _require(tuple(spec.shape) == (len(tc), ws // 2 + 1, x.shape[1])
                 and agg.shape == (len(tc), len(names), x.shape[1], 2),
                 f"PSD {modality}: shapes {tuple(spec.shape)}, {agg.shape}")
        _require(bool(np.isfinite(agg).all()), f"PSD {modality}: non-finite")
        trial = _in_trials(tc, trial_starts)
        mean = agg[..., 0]
        beta_over_gamma = float(
            (mean[trial, names.index("beta")]
             - mean[trial, names.index("gamma")]).mean())
        _require(beta_over_gamma > 0.3, f"PSD {modality}: beta stands "
                 f"{beta_over_gamma} log10 above gamma in the trials")
        out[modality] = {
            "wall_sec": t3 - t0, "upload_sec": t1 - t0,
            "compute_sec": t2 - t1, "download_sec": t3 - t2,
            "n_windows": len(tc), "spectrogram_gb": spec.numel() * 4 / 1e9,
            "beta_minus_gamma_log10": beta_over_gamma,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if modality == "eeg":
            host = TF.band_aggregate_spectrogram(spec.cpu().numpy(),
                                                 freqs)[0]
            _require_close("PSD band aggregates at study scale, card vs "
                           "host", agg, host, BAND_RTOL, BAND_ATOL,
                           equal_nan=True)
        del xd, spec, payload
    return out


def run_task_cmc(recording, device) -> dict:
    """(g), CMC: task-wise jackknifed CMC of the 11-channel motor subset
    against each EMG grid, 2-s windows, the window mask from the 30
    trial spans (3.25-s latency, 2-s end cut, 3-s buffers), the fused
    EMG max (kernel B1).  The mean EMG-max coherence over the active
    windows must peak in 15-30 Hz."""
    eeg, flexor, extensor, trial_starts = recording
    start = datetime.datetime(2024, 1, 1, tzinfo=datetime.timezone.utc)
    at = lambda s: start + datetime.timedelta(seconds=float(s))
    spans = [(at(s + TASK_LATENCY_SEC),
              at(s + TRIAL_SEC + TASK_LATENCY_SEC - TASK_END_CUT_SEC))
             for s in trial_starts]
    ws = int(WINDOW_SEC * FS)
    hop = int(ws * (1 - OVERLAP))
    n_windows = (len(eeg) - ws) // hop + 1
    centers = (np.arange(n_windows) * hop + ws / 2) / FS
    mask = TF.task_window_mask_from_spans(centers, spans, start,
                                          CMC_BUFFER_SEC, CMC_BUFFER_SEC,
                                          verbose=False)
    out = {}
    for muscle, emg in (("flexor", flexor), ("extensor", extensor)):
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        vals, lo, hi, _, freqs = TF.compute_task_wise_aggregated_cmc(
            eeg, emg, int(FS), muscle,
            eeg_channel_subset=CMC_EEG_CHANNEL_SUBSET,
            window_size_sec=WINDOW_SEC, window_overlap_ratio=OVERLAP,
            use_jackknife=True, window_mask=mask, timings_out=timings,
            device=device)
        wall = time.perf_counter() - t0
        E = len(CMC_EEG_CHANNEL_SUBSET)
        _require(vals.shape == (n_windows, ws // 2 + 1, E)
                 and lo.shape == hi.shape == vals.shape,
                 f"task CMC {muscle}: shape {vals.shape}")
        _require(bool(np.isfinite(vals).all() and np.isfinite(lo).all()
                      and np.isfinite(hi).all()),
                 f"task CMC {muscle}: non-finite values")
        _require(bool((lo <= vals).all() and (vals <= hi).all()),
                 f"task CMC {muscle}: CIs do not contain the estimate")
        _require(bool((vals[~mask] == 0).all()),
                 f"task CMC {muscle}: a masked window is not zero")
        spectrum = vals[mask].mean(axis=(0, 2))
        f_peak = float(freqs[int(np.argmax(spectrum[1:])) + 1])
        _require(15.0 <= f_peak <= 30.0,
                 f"task CMC {muscle} peaks at {f_peak} Hz")
        out[muscle] = {"wall_sec": wall, "n_windows": n_windows,
                       "n_active_windows": int(mask.sum()),
                       "peak_hz": f_peak, "timings": timings,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out


def run_phase_null(device) -> dict:
    """(i) bench.py config 4 (bench.py:203-225): one pair, 120 s at 2048
    Hz, 2-s windows, 50 % overlap, 10 000 surrogates in chunks of 250,
    histogram on, after one warm chunk.  Uncoupled white noise
    (bench.py:209-212) must give p_fwe ≥ 0.01; a pair sharing a
    stochastic 15-30 Hz drive, 1 000 surrogates, p_fwe < 0.01."""
    n = int(FS * SECONDS)
    rng = np.random.default_rng(3)
    eeg = rng.standard_normal((n, 1)).astype(np.float32)
    emg = rng.standard_normal((n, 1)).astype(np.float32)
    kw = dict(window_length_sec=WINDOW_SEC, surrogate_chunk=PHASE_CHUNK,
              device=device)
    TSu.msc_phase_randomized_null(eeg, emg, FS, n_surrogates=PHASE_CHUNK,
                                  **kw)
    out = {}
    for name, pair, n_surr in (
            ("uncoupled", (eeg, emg), PHASE_SURROGATES),
            ("coupled", make_signals(5, 1, 1, SECONDS),
             PHASE_COUPLED_SURROGATES)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = TSu.msc_phase_randomized_null(*pair, FS, n_surrogates=n_surr,
                                            **kw)
        wall = time.perf_counter() - t0
        F = int(WINDOW_SEC * FS) // 2 + 1
        _require(res["max_stat"].shape == (n_surr,)
                 and res["observed"].shape == (F, 1, 1)
                 and res["null_quantiles"][0.95].shape == (F, 1, 1),
                 f"phase null {name}: shapes")
        _require(bool(np.isfinite(res["max_stat"]).all()
                      and np.isfinite(res["observed"]).all()),
                 f"phase null {name}: non-finite values")
        if name == "uncoupled":
            _require(res["p_fwe"] >= 0.01, f"phase null uncoupled: p_fwe "
                     f"{res['p_fwe']} < 0.01")
        else:
            _require(res["p_fwe"] < 0.01, f"phase null coupled: p_fwe "
                     f"{res['p_fwe']}, the coupling was not detected")
        out[name] = {"wall_sec": wall, "n_surrogates": n_surr,
                     "p_fwe": res["p_fwe"],
                     "observed_max": res["observed_max"],
                     "null_q95_max": float(res["null_quantiles"][0.95]
                                           .max()),
                     "timings": res["timings"],
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out


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
    torch.cuda.empty_cache()

    check_features_small_against_cpu(device)
    t0 = time.perf_counter()
    recording = make_recording()
    log(json.dumps({"phase": "study_recording", "host_sec":
                    time.perf_counter() - t0, "samples": len(recording[0]),
                    "gb_each": recording[0].nbytes / 1e9}))
    reset_launches()
    psd = run_psd(recording, device)
    cmc_task = run_task_cmc(recording, device)
    n_feat = launches()
    _require(n_feat["msc_jackknife"] > 0,
             "the feature-extraction path did not launch the B1 kernel")
    log(json.dumps({"phase": "feature_extraction", "card": card,
                    "psd": psd, "task_cmc": cmc_task, "launches": n_feat}))
    del recording
    torch.cuda.empty_cache()
    narrow = check_msc_kernel(*make_signals(
        0, len(CMC_EEG_CHANNEL_SUBSET), N_EMG, SECONDS), device)
    log(json.dumps({"phase": "b1_narrow_montage", "card": card,
                    "eeg_channels": len(CMC_EEG_CHANNEL_SUBSET),
                    "emg_channels": N_EMG, **narrow}))
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "phase_null_config4", "card": card,
                    **run_phase_null(device)}))

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
