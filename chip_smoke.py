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
   shapes the main path gives it, with CUDA-event times of both (B3 also
   in its accumulate form over two chunks, with the registers and spills
   ``nvcc -Xptxas -v`` reports for each of its K instances);
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
8. the preprocessing stage: (j) the cascade (filters, average
   reference, amplitude annotation, an 8-component ICA with its labels,
   the Laplacian, db4 denoising) and the workflow on 16 EEG channels ×
   60 s at 512 Hz and on 16 EMG channels, on the card against the CPU:
   each stage, the bad channels and annotations, the ICA sources (up to
   sign and order), the labels and the output; (k) the study-scale
   EEG of (g), 64 ch × 1 698 s at 2048 Hz, in volts, with a planted
   50-Hz line and harmonics, one bad channel and an ECG-like component,
   through the workflow's defaults (25 ICA components, every stage kept
   on the card), then db4 denoising of the output, then one EMG grid
   through its default cascade: the line must drop 100×, the bad
   channel and the ECG component ('heart beat', excluded) be caught,
   the ICA converge; each stage timed, the ICA per epoch;
9. the statistics stage, one JSON line: (a) the batched REML (S = 256),
   the bootstrap's weighted REML (B = 200, zero-weight rows), the CBPA
   null's sign matrices at (c)'s shape bit for bit, and the cluster null
   (128 permutations: the sign matrices bit for bit, H0, exact-mode p)
   on the card against the CPU; then, with the launch
   counts set to 0: (b) a "Combined Statistics 1seg" frame of 12
   subjects × 30 trials (DV ≈ 0.9 with a planted 0.015 effect), the
   Level-1 fits on the host and ``run_power_analysis`` on the card over
   every fixed effect × 7 multipliers × 500 simulations, timed as host
   draws, upload, solve per block and download: NaN fraction 0, the
   planted effect's power ≥ 0.95, a near-null covariate's rate in
   [0.02, 0.09], two jobs equal on the CPU within 2/500; (c) the
   2 000-resample mediation bootstrap against the CPU, and the two CBPA
   contrasts (12 × 40 × 11 channels, tail 1; 12 × 40 × 64, tail 0) at
   1 024 permutations, each with a cluster at p < 0.05 and the threefry
   kernel launched;
10. one JSON line describing the kernels: per kernel its launches on its
   main path (and on every path, ``launches_by_path``), its error
   against the plain version, CUDA-event times of the kernel and the
   plain version, its bound (the larger of the bytes it must move over
   3.35 TB/s and the operations it must do over 67 TFLOP/s, float32 on
   the CUDA cores, counted from this run's shapes), the share of that
   bound it reaches, and, for B2, the time of ``torch.bmm`` of the same
   product (TF32 off) as ``library_ms``; the threefry draw (port-only,
   it replaces no TPU kernel) is held bit for bit to its plain version
   before the main paths run; then the result line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Every null draws its phases with the threefry kernel from the JAX
package's keys, so a seed gives the same phases on the card and the CPU:
the card-against-CPU checks of (4) and (f) run both at one seed with
nothing replaced.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import mba_tpu_torch
from mba_tpu_torch import _build
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.ops import coherence as TC
from mba_tpu_torch.ops import cuda_coeffs, cuda_msc, cuda_null, cuda_prng
from mba_tpu_torch.ops import ica as TI
from mba_tpu_torch.ops import prng
from mba_tpu_torch.ops import spectral as TS
from mba_tpu_torch.ops import surrogate as TSu
from mba_tpu_torch.ops import wavelet as TW
from mba_tpu_torch.ops.dpss import filtered_tapers
from mba_tpu_torch.ops.framing import frame_signal, window_grid
from mba_tpu_torch.ops.rotation_coeffs import band_spectra
from mba_tpu_torch.pipeline import preprocessing as TP
from mba_tpu_torch.pipeline import signal_features as TF
from mba_tpu_torch.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET
from mba_tpu_torch.workflows import preprocessing_workflow as TPW

REPO = Path(__file__).resolve().parent

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
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): float32
# on the CUDA cores and HBM3; a kernel's bound is the larger of its
# operations and its bytes over these
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# the threefry checks: the null's phase draw (J, S, K, F) at the main
# path's chunk, an odd flat length, and split(key, 1000)
PRNG_NULL_SHAPE = (N_SUBJECTS, SURROGATE_CHUNK, 5, 175)
PRNG_ODD_LEN = 1_000_003
PRNG_SPLIT = 1000
PRNG_KEYS, PRNG_KEYS_SHAPE = 8, (2, 12289)   # the full-FFT null's chunk
# integer operations of one threefry draw: 20 rounds of add, rotate and
# xor, 12 key injections, and the float conversion (shift, or, subtract,
# fma, max) — counted at the float32 rate of PEAK_FP32_FLOPS
THREEFRY_OPS = 20 * 3 + 12 + 5
# the preprocessing stage: (j) small, on the card against the CPU; (k)
# the study recording's EEG and one EMG grid in volts (10 µV of noise a
# unit), with brain-like rhythms (``rhythm_sources``), a planted 50-Hz
# line (4 harmonics), an ECG-like spike train (40 µV peak through a
# random topography) and ±2 mV 20-Hz bursts on one channel, 0.4 s every
# 5 s (8 % of the time, over the 5 % rule)
PRE_FS, PRE_SECONDS, PRE_CHANNELS, PRE_ICA = 512.0, 60.0, 16, 8
PRE_VOLTS = 1e-5
STUDY_RHYTHMS = 22      # with the ECG and the bursts, 24 of 25 components
LINE_AMPS = (2e-5, 1e-5, 5e-6, 2.5e-6)
ECG_VOLTS, BURST_VOLTS, BAD_CHANNEL = 4e-5, 2e-3, 3
PRE_FILTER_RTOL = 1e-5   # × max|x|: the filter stages (tests/test_torch_
PRE_STAGE_RTOL = 1e-4    # preprocessing.py); the stages after the ICA
ICA_CORR_MIN = 0.999     # sources up to sign and order
LINE_DROP = 100.0        # line power at 50 Hz, input over output
QUEUE_AHEAD_CYCLES = 50_000_000   # ~25 ms of spin at the H100's ~2 GHz
# the statistics stage: a "Combined Statistics 1seg" frame of 12 subjects
# × 30 trials with the RQ-A Level-1 columns, a DV of ~0.9 with a planted
# 0.015 Happy-vs-Silence effect (commit 4d5deb3's power check), force
# 20-60 %MVC, trial id 0-29, per-subject skill and dancing habit, and a
# GSR mediator; the power grid of tools/bench_pipeline.py:727-733 (every
# Level-1 fixed effect × 7 multipliers × 500 simulations); the mediation
# bootstrap; the two CBPA contrasts of tools/bench_pipeline.py:675-692
STAT_SUBJECTS, STAT_TRIALS = 12, 30
STAT_CATEGORIES = ("Silence", "Happy", "Groovy", "Sad", "Classic")
STAT_DV, STAT_MEDIATOR = "CMC_Flexor_max_beta", "GSR"
PLANTED_EFFECT, STAT_RESID_SD, STAT_SUBJECT_SD = 0.015, 0.015, 0.02
HAPPY = "C(Q('Category or Silence'))[T.Happy]"
POWER_SIMULATIONS, MIN_POWER_JOBS = 500, 35
PLANTED_POWER_MIN = 0.95
NEAR_NULL_RATE = (0.02, 0.09)      # α = 0.05 within ~3 binomial SDs at 500
POWER_CPU_DIFF = 2 / POWER_SIMULATIONS
MEDIATION_RESAMPLES = 2000
CBPA_PERMUTATIONS, CBPA_TIMES = 1024, 40
CBPA_SEED, CBPA_CHUNK = 42, 256    # cluster_permutation_1samp_test's defaults
# card against CPU, small: REML at S = 256 (β within REML_BETA_SE of its
# SE: two float32 grid solves of this design, as the port and the JAX
# package on the CPU are, whose bound tests/test_torch_models.py holds
# at this design and at the power grid's Level-1 design; each lies
# 4-6e-3 SE from the float64 host fit there; SE and scale within
# REML_RTOL, the JAX package's batched-vs-host tolerance, tests/
# test_models.py:161-166); the weighted solver at B = 200
# (β within WEIGHTED_SD_FRAC of β's spread over the resamples: a
# percentile CI moves by < 1 % of its width); the cluster null at 128
# permutations (signs bit for bit; H0 within rtol/atol 1e-4, tests/
# test_stats_golden.py:298; exact-mode p equal)
REML_SMALL, WEIGHTED_SMALL, CLUSTER_SMALL = 256, 200, 128
REML_BETA_SE, REML_RTOL = 1e-2, 2e-3
WEIGHTED_SD_FRAC = 1e-2
H0_RTOL, H0_ATOL = 1e-4, 1e-4


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
    call.  A ~25 ms spin kernel goes first, so the host queues the timed
    calls while the card waits and a kernel shorter than its wrapper's
    host time is timed on the card, not on the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def roofline(ms: float, flops: float, nbytes: float) -> dict:
    """The least time the card could take for ``flops`` float32
    operations and ``nbytes`` moved once, what bounds it, and the share
    of it that ``ms`` reaches."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    return {"bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": bound / ms, "flops": flops, "bytes": nbytes}


def msc_emg_max_work(W, K, F, E, M) -> tuple[float, float]:
    """(flops, bytes) of B1's EMG-max function.  Per (w, f, e, m): the K
    cross terms (6 flops each) and their totals (2 each), the K
    leave-one-out ratios (two differences, |.|² in 3, the denominator
    product, the division, the running sum: 8 each) and their mean: 16K
    + 1; the argmax compare, and the CIs once per (w, f, e) (K Fisher
    transforms and the variance, ~10K + 12 with each transcendental
    counted as one), are counted too.  Bytes: both spectra read once,
    three (W, F, E) float32 results written once."""
    flops = W * F * E * (M * (16 * K + 2) + 10 * K + 12)
    nbytes = W * K * F * (E + M) * 8 + 3 * W * F * E * 4
    return float(flops), float(nbytes)


def msc_full_grid_work(W, K, F, E, M) -> tuple[float, float]:
    """(flops, bytes) of B1's full-grid function: the whole jackknife
    (16K + 1 + 10K + 12) at every (w, f, e, m), three (W, F, E, M)
    results written once."""
    flops = W * F * E * M * (26 * K + 13)
    nbytes = W * K * F * (E + M) * 8 + 3 * W * F * E * M * 4
    return float(flops), float(nbytes)


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


def check_msc_kernel(eeg, emg, device, reps=10) -> dict:
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
    # the EMG-max mode forms the CIs of its pick alone, through the code
    # of the full grid: bit for bit the full grid's at its first argmax
    first = np.argmax(kf["coherence"], axis=-1)[..., None]
    for key in ("coherence", "ci_lower", "ci_upper"):
        at_pick = np.take_along_axis(kf[key], first, -1)[..., 0]
        _require(np.array_equal(km[key], at_pick),
                 f"B1 EMG-max {key} is not the full grid's at its pick")
    ms = cuda_ms(lambda: cuda_msc.msc_jackknife(e, m, t_crit), reps)
    plain_ms = cuda_ms(lambda: cuda_msc.msc_jackknife_plain(e, m, t_crit),
                       reps)
    full_ms = cuda_ms(lambda: cuda_msc.msc_jackknife(e, m, t_crit,
                                                     emg_max=False), reps)
    W, K, F, E = e.shape
    M = m.shape[-1]
    full = roofline(full_ms, *msc_full_grid_work(W, K, F, E, M))
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            **roofline(ms, *msc_emg_max_work(W, K, F, E, M)),
            "library_ms": None, "shape": [W, K, F, E, M],
            "full_grid": {"ms": full_ms, "bound_ms": full["bound_ms"],
                          "bound_by": full["bound_by"],
                          "share_of_bound": full["share_of_bound"]}}


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
    return TN.null_state(base, coef, obs), prng.prng_key(seed), K


def check_null_kernel(device, reps=10) -> dict:
    """B2 against its plain version at S = 500 (the main path's chunk)
    and S = 13 (padded rows must not count).  max_stat within NULL_TOL;
    counts equal but in at most TIE_FRACTION of the cells, by one, where
    float32 accumulation order moves a stat across obs."""
    state, key, K = null_check_state(device)
    J = state.n_subjects
    nF = state.coefT.shape[0]
    out = {}
    for S in (SURROGATE_CHUNK, 13):
        key, sub = prng.split(key)
        G = cuda_null.null_features(TN.phase_features(
            TN.draw_phases(sub, J, S, K, nF, device)))
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
                        "shape": [nF, S, G.shape[1], state.coefT.shape[2]],
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
            JP, N = G.shape[1], state.coefT.shape[2]
            nbytes = 4 * (G.numel() + state.coefT.numel()
                          + 3 * nF * N + S)
            out.update(roofline(out["ms"], 2.0 * nF * S * JP * N, nbytes))
            out["library_ms"] = bmm_ms(G, state.coefT, reps)
            out["shape"] = [nF, S, JP, N]
    return out


def bmm_ms(G, coefT, reps) -> float:
    """B2's yardstick: ``torch.bmm`` of the same (nF, S, J·P) × (nF, J·P,
    N) product in float32 with TF32 off, into a preallocated output: the
    product alone, without the epilogue, on row-major features."""
    _require(not torch.backends.cuda.matmul.allow_tf32,
             "TF32 is on: the yardstick would not be float32")
    a = G.transpose(1, 2).contiguous()
    out = torch.empty((a.shape[0], a.shape[1], coefT.shape[2]),
                      dtype=torch.float32, device=G.device)
    ms = cuda_ms(lambda: torch.bmm(a, coefT, out=out), reps)
    del a, out
    torch.cuda.empty_cache()
    return ms


def check_prng_kernel(device, reps=20) -> dict:
    """The threefry draw against its plain version, bit for bit: the
    null's phase draw (PRNG_NULL_SHAPE, uniform on [0, 2π)), raw bits at
    an odd flat length, split(key, PRNG_SPLIT) as both words (the keys
    themselves), and one draw for each of PRNG_KEYS keys in one launch.
    Times the null's draw, kernel and plain version
    (the plain version's int64 ops on the card); its bound is the larger
    of the float32 output written over 3.35 TB/s and THREEFRY_OPS a draw
    over PEAK_FP32_FLOPS.  Port-only: no TPU kernel draws these bits."""
    key = prng.split(prng.prng_key(2024))[1]
    checks, err = {}, 0.0
    for kind, shape, bounds in (("uniform", PRNG_NULL_SHAPE, (0.0, 2 * np.pi)),
                                ("bits", (PRNG_ODD_LEN,), (0.0, 1.0)),
                                ("pairs", (PRNG_SPLIT,), (0.0, 1.0))):
        got = cuda_prng.threefry_draw(key, shape, kind, device, *bounds)
        ref = cuda_prng.threefry_draw(key, shape, kind, "cpu", *bounds)
        _require(got.device.type == "cuda" and got.dtype == ref.dtype
                 and got.shape == ref.shape, f"threefry {kind}: "
                 f"{got.device} {got.dtype} {tuple(got.shape)}")
        same = bool(torch.equal(got.cpu(), ref))
        checks[kind] = {"shape": list(shape), "bitwise_equal": same}
        _require(same, f"threefry {kind} {shape}: the kernel's bits differ "
                 "from the plain version's")
        if kind == "uniform":
            err = float((got.cpu() - ref).abs().max())
        if kind == "pairs":
            _require(np.array_equal(got.cpu().numpy().astype(np.uint32),
                                    prng.split(key, PRNG_SPLIT)),
                     "threefry pairs are not split's keys")
    # the full-FFT null's per-surrogate draws, one launch for a chunk
    keys = prng.split(key, PRNG_KEYS)
    got = cuda_prng.uniform_keys(keys, PRNG_KEYS_SHAPE, 0.0, 2 * np.pi,
                                 device)
    same = bool(torch.equal(got.cpu(), cuda_prng.uniform_keys(
        keys, PRNG_KEYS_SHAPE, 0.0, 2 * np.pi, "cpu")))
    checks["keys"] = {"shape": [PRNG_KEYS, *PRNG_KEYS_SHAPE],
                      "bitwise_equal": same}
    _require(same, "threefry many keys: the kernel's bits differ from the "
             "plain version's")
    ms = cuda_ms(lambda: cuda_prng.uniform(key, PRNG_NULL_SHAPE, 0.0,
                                           2 * np.pi, device), reps)
    plain_ms = cuda_ms(lambda: prng.uniform(key, PRNG_NULL_SHAPE, 0.0,
                                            2 * np.pi, device), 3)
    n = math.prod(PRNG_NULL_SHAPE)
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **roofline(ms, float(THREEFRY_OPS * n), 4.0 * n),
           "library_ms": None, "shape": list(PRNG_NULL_SHAPE),
           "checks": checks}
    log(json.dumps({"check": "threefry", "card": card_name_and_power(),
                    **out}))
    return out


def ptxas_report() -> dict:
    """Registers and spills of each instance of B3, as ``nvcc -Xptxas -v``
    reports them for the build's flags: {"K=5 wide": {"registers": ..,
    "spill_stores": .., "spill_loads": ..}, ...} (bytes for spills);
    "wide" is the instance whose lanes span 32 EMG channels (M = 64 on the
    main path), "narrow" the one for fewer."""
    src = _build.CSRC_DIR / "coeff_pairs.cu"
    obj = _build.BUILD_DIR / f"ptxas_report.{os.getpid()}.o"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
           "-o", str(obj), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    finally:
        obj.unlink(missing_ok=True)
    _require(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n"
             f"{proc.stdout}{proc.stderr}")
    out, k = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            inst = re.search(r"coeff_pairs_kernelILi(\d+)E\w*?Lb([01])E",
                             entry.group(1))
            k = (f"K={inst.group(1)} {('narrow', 'wide')[int(inst.group(2))]}"
                 if inst else None)
            continue
        if k is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            out.setdefault(k, {}).update(spill_stores=int(spill.group(1)),
                                         spill_loads=int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out.setdefault(k, {})["registers"] = int(used.group(1))
    _require(sorted(out) == sorted(f"K={k} {w}" for k in range(2, 9)
                                   for w in ("narrow", "wide")),
             f"ptxas report lacks an instance: {sorted(out)}")
    return out


def _coeff_excess(got, ref, wsum, what) -> tuple[dict, dict]:
    """Per output, the largest |kernel − plain| / wsum and its ratio to
    COEFF_ATOL + COEFF_RTOL·|plain| / wsum."""
    errs, excess = {}, {}
    for name, a, b in zip(("diag", "pr", "pi"), got, ref):
        _require(bool(torch.isfinite(a).all()), f"{what} {name}: non-finite")
        d = (a - b).abs() / wsum
        bound = COEFF_ATOL + COEFF_RTOL * b.abs() / wsum
        errs[name] = float(d.max())
        excess[name] = float((d / bound).max())
    return errs, excess


def check_coeff_kernel(cohort, device, reps=10) -> dict:
    """B3 against its plain version at the main path's chunk: the first
    WINDOW_CHUNK windows of the bench cohort's first subject, their
    weights from the disjoint subset (so half of them are 0), K = 5,
    13-100 Hz (nF = 175), 64×64.  The sums over the chunk's weight sum
    within COEFF_RTOL / COEFF_ATOL.  Then the accumulate form, as
    ``rotation_coeffs_subject`` runs it: the next WINDOW_CHUNK windows
    added by the kernel into the first chunk's sums (``out=``), against
    the plain version's ``add_``, over both chunks' weight sum.  The
    registers and spills nvcc reports for each K go with the times."""
    ws = int(WINDOW_SEC * FS)
    tapers = torch.as_tensor(filtered_tapers(ws, NW, 0.9),
                             dtype=torch.float32, device=device)
    _, lo, hi = TN._band_bins(ws, FS, BAND)
    starts, _ = window_grid(cohort[0].shape[1], ws, int(ws * (1 - OVERLAP)),
                            FS)
    weights = TN.disjoint_window_weights(
        starts[None], np.ones((1, len(starts)), np.float32), ws)[0]
    chunks = []
    for c0 in (0, WINDOW_CHUNK):
        cs = torch.as_tensor(starts[c0:c0 + WINDOW_CHUNK], device=device)
        w = torch.as_tensor(weights[c0:c0 + WINDOW_CHUNK], device=device)
        e, m = (band_spectra(torch.from_numpy(x[0]).to(device), cs, tapers,
                             ws, lo, hi) for x in cohort)
        chunks.append((e, m, w))
    (e, m, w), second = chunks
    got = cuda_coeffs.coeff_pairs(e, m, w)
    ref = cuda_coeffs.coeff_pairs_plain(e, m, w)
    wsum = float(w.sum())
    errs, excess = _coeff_excess(got, ref, wsum, "B3")
    acc = cuda_coeffs.coeff_pairs(*second, out=got)
    cuda_coeffs.coeff_pairs_plain(*second, out=ref)
    _require(acc is got, "B3 out= did not return out")
    wsum2 = wsum + float(second[2].sum())
    errs2, excess2 = _coeff_excess(acc, ref, wsum2, "B3 accumulate")
    log(json.dumps({"check": "coeff_pairs", "shape": [list(e.shape),
                                                      list(m.shape)],
                    "weight_sum": wsum, "max_abs_err_over_wsum": errs,
                    "max_err_over_tolerance": excess,
                    "accumulate_weight_sum": wsum2,
                    "accumulate_max_abs_err_over_wsum": errs2,
                    "accumulate_max_err_over_tolerance": excess2,
                    "rtol": COEFF_RTOL, "atol": COEFF_ATOL}))
    _require(max(excess.values()) <= 1.0,
             f"B3 disagrees with its plain version: {excess}")
    _require(max(excess2.values()) <= 1.0,
             f"B3's accumulate form disagrees with the plain add_: {excess2}")
    del acc, ref
    ms = cuda_ms(lambda: cuda_coeffs.coeff_pairs(e, m, w), reps)
    ms_acc = cuda_ms(lambda: cuda_coeffs.coeff_pairs(*second, out=got),
                     reps)
    plain_ms = cuda_ms(lambda: cuda_coeffs.coeff_pairs_plain(e, m, w), reps)
    # per (window, f, e, m): the denominator and its scale (4), per taper
    # the cross term, its scaling and |y|² into the diagonal (12), per
    # pair k < l the complex product into the sums (8); spectra read
    # once, the 1 + 2·P2 sums written once
    wc, K, nF, E = e.shape
    M = m.shape[-1]
    P2 = K * (K - 1) // 2
    flops = wc * nF * E * M * (4 + 12 * K + 8 * P2)
    nbytes = 8 * wc * K * nF * (E + M) + 4 * wc + 4 * (1 + 2 * P2) * nF * E * M
    out = {"max_abs_err": max(errs.values()) * wsum,
           "accumulate_max_abs_err": max(errs2.values()) * wsum2,
           "ms": ms, "accumulate_ms": ms_acc, "plain_ms": plain_ms,
           **roofline(ms, float(flops), float(nbytes)),
           "library_ms": None, "shape": [wc, K, nF, E, M],
           "ptxas": ptxas_report()}
    log(json.dumps({"check": "coeff_pairs timing", "card": card_name_and_power(),
                    **out}))
    return out


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
        what = f"rotation null {extra or 'gram'} small, card vs cpu"
        _require_close_observed(got["observed"], ref["observed"],
                                f"{what}: observed")
        _require(got["max_stat"].shape == (1000,)
                 and bool(np.isfinite(got["max_stat"]).all()),
                 f"small null {extra}: bad max_stat")
        # one seed, so the same phases: the surrogates agree as the
        # observed maps do
        _require_close_observed(got["max_stat"], ref["max_stat"],
                                f"{what}: max_stat at one seed")
    kw_fft = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
                  band=BAND, n_surrogates=16)
    got = TN.cohort_msc_fft_null(ce, cm, FS, device=device, **kw_fft)
    ref = TN.cohort_msc_fft_null(ce, cm, FS, device="cpu", **kw_fft)
    _require_close_observed(got["observed"], ref["observed"],
                            "fft null small, card vs cpu: observed")
    _require(bool(np.isfinite(got["max_stat"]).all()),
             "small fft null: bad max_stat")
    _require_close_observed(got["max_stat"], ref["max_stat"],
                            "fft null small, card vs cpu: max_stat at one "
                            "seed")


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
    at one seed, so with the same phases on both."""
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
    got, ref = (TSu.msc_phase_randomized_null(pe, pm, FS, device=dev, seed=5,
                                              **kw) for dev in (device, "cpu"))
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


def ecg_train(n, fs, rng) -> np.ndarray:
    """Unit-peak QRS spikes (σ 12 ms) with a T wave, ~70 bpm with ±3 %
    beat-to-beat jitter: (n,) float32."""
    k = np.arange(int(0.6 * fs))
    beat_shape = (np.exp(-0.5 * ((k - 0.05 * fs) / (0.012 * fs)) ** 2)
                  + 0.15 * np.exp(-0.5 * ((k - 0.3 * fs) / (0.04 * fs)) ** 2)
                  ).astype(np.float32)
    x = np.zeros(n, np.float32)
    beat = rng.uniform(0.0, 0.8) * fs
    while beat + len(k) < n:
        x[int(beat):int(beat) + len(k)] += beat_shape
        beat += fs * 60.0 / 70.0 * rng.uniform(0.97, 1.03)
    return x


def plant_artifacts(x, fs, seed, scale=1.0) -> np.ndarray:
    """In place on ``x`` (n, C) float32 in volts: the 50-Hz line and its
    harmonics (LINE_AMPS × ``scale``, a gain of 1 ± 0.2 a channel), the
    ECG train through a random topography (ECG_VOLTS × ``scale``), and
    BURST_VOLTS 20-Hz bursts on BAD_CHANNEL, 0.4 s every 5 s.  Returns
    the ECG train."""
    rng = np.random.default_rng(seed)
    n, C = x.shape
    t = np.arange(n) / fs
    line = np.zeros(n)
    for h, amp in enumerate(LINE_AMPS, 1):
        line += scale * amp * np.sin(2 * np.pi * 50.0 * h * t
                             + rng.uniform(0, 2 * np.pi))
    gains = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    x += line.astype(np.float32)[:, None] * gains
    ecg = ecg_train(n, fs, rng)
    topo = rng.uniform(-1.0, 1.0, C).astype(np.float32)
    x += ecg[:, None] * (np.float32(scale * ECG_VOLTS) * topo)
    width, period = int(0.4 * fs), int(5 * fs)
    burst = (BURST_VOLTS * np.sign(np.sin(
        2 * np.pi * 20 * np.arange(width) / fs))).astype(np.float32)
    for s0 in range(0, n - width, period):
        x[s0:s0 + width, BAD_CHANNEL] += burst
    return ecg


def line_power(x, fs, device, channels=4) -> float:
    """Power in 49.9-50.1 Hz of the last ``channels`` columns of ``x``
    (numpy or a tensor; away from BAD_CHANNEL and its neighbours), from
    one rFFT on the card."""
    cols = torch.as_tensor(x[:, -channels:], device=device).to(torch.float64)
    spec = torch.fft.rfft(cols, dim=0)
    f = np.fft.rfftfreq(cols.shape[0], 1 / fs)
    band = torch.as_tensor((f > 49.9) & (f < 50.1), device=device)
    return float((spec[band].abs() ** 2).sum())


def _matched_sources(a, b):
    """|corr| of each column of ``a`` with its best match in ``b``, and
    that match's index."""
    k = a.shape[1]
    c = np.abs(np.corrcoef(a.T, b.T)[:k, k:])
    return c.max(axis=1), c.argmax(axis=1)


def rhythm_sources(n, fs, rng, n_sources, n_channels) -> np.ndarray:
    """Brain-like rhythms, (n, n_channels) float32 volts: ``n_sources``
    sinusoids at frequencies spread over 4-45 Hz, 20 µV each, switched on
    for ~40 % of the time at its own slow rate, through random
    topographies.  Planted with the ECG and the bursts, they fill the
    leading ICA components with non-Gaussian sources, so the ICA's
    sources are defined up to sign and order: Gaussian noise components
    are defined only up to a rotation among themselves, which rounding
    turns, and with them in the majority extended Infomax at the study's
    block of 1 076 samples spread a 40 µV ECG over every component, on
    the CPU and the card alike."""
    t = np.arange(n) / fs
    freqs = np.linspace(4.0, 45.0, n_sources) + rng.uniform(-0.5, 0.5,
                                                            n_sources)
    src = np.empty((n, n_sources), np.float32)
    for i, f in enumerate(freqs):
        on = np.sin(2 * np.pi * rng.uniform(0.05, 0.3) * t
                    + rng.uniform(0, 2 * np.pi)) > 0.3
        src[:, i] = on * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    topo = rng.uniform(-1.0, 1.0, (n_sources, n_channels)).astype(np.float32)
    return src @ (np.float32(2e-5) * topo)


STAGES = (("np_filtered_data", PRE_FILTER_RTOL),
          ("np_referenced_data", PRE_FILTER_RTOL),
          ("np_artefact_free_data", PRE_STAGE_RTOL),
          ("np_spatially_filtered_data", PRE_STAGE_RTOL),
          ("np_output_data", PRE_STAGE_RTOL))


def check_preprocessing_small_against_cpu(device) -> dict:
    """(j) The cascade on PRE_CHANNELS EEG channels × PRE_SECONDS at
    PRE_FS with a PRE_ICA-component ICA and db4 denoising, and on as many
    EMG channels, on the card against the CPU: each stage within
    PRE_FILTER_RTOL / PRE_STAGE_RTOL × max|x|, the bad channels and
    annotations equal, the ICA sources equal up to sign and order
    (|corr| ≥ ICA_CORR_MIN), the labels equal under that matching; then
    the workflow on the card with every stage kept there, its saved
    output against the CPU cascade's."""
    rng = np.random.default_rng(12)
    n = int(PRE_FS * PRE_SECONDS)
    eeg = rhythm_sources(n, PRE_FS, rng, PRE_ICA - 2, PRE_CHANNELS)
    eeg += (0.1 * PRE_VOLTS * rng.standard_normal(eeg.shape)).astype(
        np.float32)
    plant_artifacts(eeg, PRE_FS, seed=13)
    emg = (5 * PRE_VOLTS * rng.standard_normal((n, PRE_CHANNELS))).astype(
        np.float32)
    plant_artifacts(emg, PRE_FS, seed=14, scale=5.0)
    kw = dict(sampling_freq=int(PRE_FS), n_ica_components=PRE_ICA,
              wavelet_type='db4')
    out = {}
    for modality, x in (("eeg", eeg), ("emg", emg)):
        extra = kw if modality == "eeg" else dict(
            sampling_freq=int(PRE_FS), n_ica_components=None)
        card = TP.BiosignalPreprocessor(x, modality=modality, device=device,
                                        **extra)
        cpu = TP.BiosignalPreprocessor(x, modality=modality, device="cpu",
                                       **extra)
        scale = float(np.abs(x).max())
        t0 = time.perf_counter()
        _ = card.np_output_data
        card_sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        _ = cpu.np_output_data
        cpu_sec = time.perf_counter() - t0
        for stage, rtol in STAGES:
            _require_close(f"preprocessing small {modality} {stage}, card "
                           "vs cpu", getattr(card, stage),
                           getattr(cpu, stage), 0.0, rtol * scale)
        _require(card.bad_channels == cpu.bad_channels
                 == [card.channel_names[BAD_CHANNEL]],
                 f"preprocessing small {modality}: bad channels "
                 f"{card.bad_channels} vs {cpu.bad_channels}")
        _require(card.bad_annotations == cpu.bad_annotations,
                 f"preprocessing small {modality}: annotations differ")
        out[modality] = {"card_sec": card_sec, "cpu_sec": cpu_sec,
                         "bad_channels": card.bad_channels,
                         "n_annotations": len(card.bad_annotations)}
        if modality == "emg":
            continue
        ica_c, ica_h = card.ica_result, cpu.ica_result
        best, match = _matched_sources(
            ica_c.get_sources(cpu.np_amplitude_compliant_data),
            ica_h.get_sources(cpu.np_amplitude_compliant_data))
        labels_c = card.ica_automatic_labels["labels"]
        labels_h = cpu.ica_automatic_labels["labels"]
        log(json.dumps({"check": "preprocessing small ICA, card vs cpu",
                        "source_corr_min": float(best.min()),
                        "match": match.tolist(), "epochs": [
                            ica_c.n_iter_, ica_h.n_iter_],
                        "labels": labels_c, "exclude": ica_c.exclude}))
        _require(best.min() >= ICA_CORR_MIN
                 and sorted(match) == list(range(len(match))),
                 f"ICA sources, card vs cpu: |corr| {best.min()}")
        _require([labels_h[m] for m in match] == labels_c,
                 f"IC labels, card vs cpu: {labels_c} vs {labels_h}")
        _require("heart beat" in labels_c,
                 f"the planted ECG was not labelled: {labels_c}")
        out["eeg"].update(ica_epochs=ica_c.n_iter_, labels=labels_c,
                          exclude=ica_c.exclude)
        with tempfile.TemporaryDirectory(dir=REPO) as tmp:
            np.save(Path(tmp) / "2024-01-01 10_00_00 Raw eeg.npy", eeg)
            wf = TPW.preprocess_subject_modality(
                0, "eeg", Path(tmp), device=device, device_resident=True,
                **kw)
            _require(wf.np_output_data.device.type == "cuda",
                     "workflow: the output left the card")
            saved = np.load(next(Path(tmp).glob("*Preprocessed eeg*.npy")))
        _require_close("preprocessing small workflow on the card vs the "
                       "cpu cascade", saved, cpu.np_output_data, 0.0,
                       PRE_STAGE_RTOL * scale)
    return out


def run_preprocessing_study(recording, device) -> dict:
    """(k) The study recording's EEG in volts with STUDY_RHYTHMS rhythms,
    the planted line, bad channel and ECG, through the workflow's
    defaults (25 ICA components,
    ``device_resident``), each stage timed; db4 denoising of the output;
    then the flexor grid (×5 in volts, planted alike) through its
    default cascade."""
    t0 = time.perf_counter()
    eeg = recording[0] * np.float32(PRE_VOLTS)
    eeg += rhythm_sources(len(eeg), FS, np.random.default_rng(20),
                          STUDY_RHYTHMS, eeg.shape[1])
    ecg = plant_artifacts(eeg, FS, seed=21)
    emg = recording[1] * np.float32(5 * PRE_VOLTS)
    plant_artifacts(emg, FS, seed=22, scale=5.0)
    host_sec = time.perf_counter() - t0
    times = {}

    def stage(name, fn):
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return res

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    x = stage("upload", lambda: torch.from_numpy(eeg).to(device))
    p = TP.BiosignalPreprocessor(x, int(FS), 'eeg', n_ica_components=25,
                                 device_resident=True)
    stage("filter", lambda: p.np_filtered_data)
    stage("reference", lambda: p.np_referenced_data)
    stage("amplitude", lambda: p.np_amplitude_compliant_data)
    ica = stage("ica_fit", lambda: p.ica_result)
    stage("label_apply", lambda: p.np_artefact_free_data)
    out = stage("laplacian", lambda: p.np_output_data)
    den = stage("wavelet", lambda: TW.wavelet_denoise(out, 'db4'))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _require(bool(torch.isfinite(out).all() and torch.isfinite(den).all()),
             "study preprocessing: non-finite output")
    drop = line_power(x, FS, device) / line_power(out, FS, device)
    _require(drop >= LINE_DROP, f"study preprocessing: 50-Hz power fell "
             f"only {drop:.1f}x")
    bad = p.channel_names[BAD_CHANNEL]
    _require(bad in p.bad_channels, f"study preprocessing: {bad} not in "
             f"bad channels {p.bad_channels}")
    _require(ica.n_iter_ < ica.max_iter, f"study ICA did not converge in "
             f"{ica.max_iter} epochs")
    src = TI._project(p.np_amplitude_compliant_data,
                      torch.as_tensor(ica._mean, dtype=torch.float32,
                                      device=device),
                      torch.as_tensor(ica.unmixing_, dtype=torch.float32,
                                      device=device))
    src = src - src.mean(dim=0)
    e = torch.as_tensor(ecg, device=device)
    e = e - e.mean()
    corr = ((src * e[:, None]).sum(dim=0)
            / (src.norm(dim=0) * e.norm())).abs().cpu().numpy()
    del src, e
    k = int(np.argmax(corr))
    labels = p.ica_automatic_labels["labels"]
    _require(labels[k] == "heart beat" and k in ica.exclude,
             f"study preprocessing: the ECG component {k} (|corr| "
             f"{corr[k]:.3f}) is labelled {labels[k]!r}, exclude "
             f"{ica.exclude}")
    res = {"host_sec": host_sec, "stage_sec": times,
           "ica_epochs": ica.n_iter_,
           "ica_ms_per_epoch": 1e3 * ica.timings_["epochs_sec"]
           / ica.n_iter_, "ica_capture_sec": ica.timings_["capture_sec"],
           "ica_block": ica.block_, "line_drop": drop,
           "bad_channels": p.bad_channels, "ecg_component": k,
           "ecg_corr": float(corr[k]), "labels": labels,
           "exclude": ica.exclude, "peak_mem_gb": peak_gb}
    del p, x, out, den
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    q = TP.BiosignalPreprocessor(emg, int(FS), 'emg', n_ica_components=None,
                                 device_resident=True, device=device)
    emg_out = q.np_output_data
    torch.cuda.synchronize()
    res["stage_sec"]["emg_cascade"] = time.perf_counter() - t
    _require(bool(torch.isfinite(emg_out).all()),
             "study EMG cascade: non-finite output")
    emg_drop = line_power(emg, FS, device) / line_power(emg_out, FS, device)
    _require(emg_drop >= LINE_DROP, f"study EMG: 50-Hz power fell only "
             f"{emg_drop:.1f}x")
    _require(q.channel_names[BAD_CHANNEL] in q.bad_channels,
             f"study EMG: bad channels {q.bad_channels}")
    res["emg"] = {"line_drop": emg_drop, "bad_channels": q.bad_channels,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del q, emg_out
    torch.cuda.empty_cache()
    return res


def make_statistics_frame(seed=11):
    """The study's "Combined Statistics 1seg" frame: 12 subjects × 30
    trials cycling through the five categories, DV ≈ 0.9 + 0.015·Happy +
    0.01·u + subject intercept (SD 0.02) + noise (SD 0.015), where u is
    the GSR mediator's own noise (GSR = 2 + 0.5·Happy + u); force 20-60
    %MVC, trial id 0-29, per-subject centered skill and dancing habit."""
    import pandas as pd
    rng = np.random.default_rng(seed)
    n = STAT_SUBJECTS * STAT_TRIALS
    subject = np.repeat(np.arange(STAT_SUBJECTS), STAT_TRIALS)
    trial = np.tile(np.arange(STAT_TRIALS), STAT_SUBJECTS)
    category = np.array(STAT_CATEGORIES)[trial % len(STAT_CATEGORIES)]
    happy = (category == "Happy").astype(float)
    skill = rng.integers(0, 8, STAT_SUBJECTS).astype(float)
    dancing = rng.integers(0, 8, STAT_SUBJECTS).astype(float)
    u = rng.normal(0.0, 0.5, n)
    dv = (0.9 + PLANTED_EFFECT * happy + 0.01 * u
          + rng.normal(0.0, STAT_SUBJECT_SD, STAT_SUBJECTS)[subject]
          + rng.normal(0.0, STAT_RESID_SD, n))
    return pd.DataFrame({
        "Subject ID": subject, "Trial ID": trial,
        "Category or Silence": category,
        "Music Listening": category != "Silence",
        "Median Unscaled Force [% MVC]": rng.uniform(20.0, 60.0, n),
        "Musical skill [0-7]_centered": (skill - skill.mean())[subject],
        "Dancing habit [0-7]_centered": (dancing - dancing.mean())[subject],
        STAT_MEDIATOR: 2.0 + 0.5 * happy + u, STAT_DV: dv})


def reml_small_problem(rng):
    """REML_SMALL responses of a Level-1-like design of the study's size
    (p = 7: intercept, force, trial id, four sparse dummies): X, Y,
    groups."""
    n, G = STAT_SUBJECTS * STAT_TRIALS, STAT_SUBJECTS
    groups = np.repeat(np.arange(G), STAT_TRIALS)
    X = np.column_stack([np.ones(n), rng.uniform(20, 60, n),
                         np.tile(np.arange(STAT_TRIALS), G),
                         rng.random((n, 4)) < 0.2])
    Y = (0.9 + 1e-4 * X[:, 1] + rng.normal(0, 0.02, (REML_SMALL, G))[:, groups]
         + rng.normal(0, 0.015, (REML_SMALL, n)))
    return X, Y, groups


def level1_design(frame):
    """The RQ-A Level-1 design of ``frame`` (p = 17 at the study's frame),
    its column names and the subject ids, as ``run_power_analysis`` builds
    them."""
    from mba_tpu_torch.pipeline import statistical_modelling as TStat
    from mba_tpu_torch.workflows import \
        statistics_RQ_A_omnibus_testing_workflow as TRQA
    level = TRQA.fetch_level_definitions(False)[1]
    design, names = TStat.build_design_matrix(
        frame, level["condition_vars"], level["explanatory_vars"],
        level["moderation_pairs"], level["reference_categories"])
    return design, names, frame["Subject ID"].to_numpy()


def check_statistics_small_against_cpu(device) -> dict:
    """(a) The device parts small, on the card against the CPU: the REML
    grid at S = REML_SMALL responses of a Level-1-like design; the
    weighted solver at B = WEIGHTED_SMALL with zero-weight rows; the
    sign matrices of the CBPA contrasts' null (CBPA_SEED, CBPA_CHUNK) bit
    for bit; the cluster null at CLUSTER_SMALL permutations (the sign
    matrices bit for bit, H0 within H0_RTOL/H0_ATOL) and in exact mode
    (p equal)."""
    from mba_tpu_torch.models import lme as TL
    from mba_tpu_torch.ops import permutation as TPerm
    rng = np.random.default_rng(5)
    X, Y, groups = reml_small_problem(rng)
    n, G = X.shape[0], STAT_SUBJECTS
    got = TL.batched_lme_pvalues(X, Y, groups, device=device)
    ref = TL.batched_lme_pvalues(X, Y, groups, device="cpu")
    beta_err = float(np.max(np.abs(got["beta"] - ref["beta"]) / ref["bse"]))
    se_err = float(np.max(np.abs(got["bse"] / ref["bse"] - 1)))
    scale_err = float(np.max(np.abs(got["scale"] / ref["scale"] - 1)))
    _require(beta_err <= REML_BETA_SE and se_err <= REML_RTOL
             and scale_err <= REML_RTOL,
             f"REML card vs CPU: beta {beta_err:.2e} SE, bse {se_err:.2e}, "
             f"scale {scale_err:.2e}")

    B, m = WEIGHTED_SMALL, STAT_TRIALS
    gidx = np.repeat(np.arange(G), m)
    x = (rng.random((B, n)) < 0.5).astype(np.float32)
    med = (0.5 * x + rng.normal(0, 0.5, (B, n))).astype(np.float32)
    y = (0.9 + 0.01 * x + 0.02 * med + rng.normal(0, 0.02, (B, n))
         + rng.normal(0, 0.01, (B, G))[:, gidx]).astype(np.float32)
    w = (rng.random((B, n)) > 0.2).astype(np.float32)   # absent rows
    Xb = np.stack([np.ones_like(x), x, med], 2)
    beta = [TL._batched_reml_weighted(
        *(torch.from_numpy(a).to(dev) for a in (Xb, y, w,
                                               gidx.astype(np.int64))),
        n_groups=G).cpu().numpy() for dev in (device, "cpu")]
    w_err = float(np.max(np.abs(beta[0] - beta[1]) / beta[1].std(0)))
    _require(w_err <= WEIGHTED_SD_FRAC,
             f"weighted REML card vs CPU: {w_err:.2e} of β's spread")

    Xc = rng.standard_normal((G, 10, len(CMC_EEG_CHANNEL_SUBSET))).astype(
        np.float32)
    Xc[:, 3:7, :4] += 1.0
    adj = TPerm.combine_adjacency(10, TPerm.delaunay_channel_adjacency(
        CMC_EEG_CHANNEL_SUBSET))
    for seed, n_perm, chunk in ((3, CLUSTER_SMALL, 64),
                                (CBPA_SEED, CBPA_PERMUTATIONS, CBPA_CHUNK)):
        signs = [TPerm._draw_signs(seed, -(-n_perm // chunk), chunk, G,
                                   dev).cpu() for dev in (device, "cpu")]
        _require(torch.equal(*signs), f"cluster null: the card's sign "
                 f"matrices differ from the CPU's ({n_perm} permutations "
                 f"in chunks of {chunk})")
    res = [TPerm.cluster_permutation_1samp_test(
        Xc, adj, n_permutations=CLUSTER_SMALL, tail=0, seed=3,
        permutation_chunk=64, device=dev) for dev in (device, "cpu")]
    h0_err = float(np.max(np.abs(res[0][3] - res[1][3])
                          - H0_RTOL * np.abs(res[1][3])))
    _require(h0_err <= H0_ATOL,
             f"cluster null card vs CPU: H0 {h0_err:.2e} over rtol")
    n_exact = int(np.log2(CLUSTER_SMALL))
    exact = [TPerm.cluster_permutation_1samp_test(
        Xc[:n_exact], adj, n_permutations=CLUSTER_SMALL, tail=1,
        device=dev) for dev in (device, "cpu")]
    _require(len(exact[0][3]) == CLUSTER_SMALL
             and np.array_equal(exact[0][2], exact[1][2]),
             f"exact cluster p card vs CPU: {exact[0][2]} vs {exact[1][2]}")
    return {"reml_S": REML_SMALL, "reml_beta_err_se": beta_err,
            "reml_bse_rel": se_err, "reml_scale_rel": scale_err,
            "weighted_B": B, "weighted_err_sd": w_err,
            "cluster_signs_bitwise_equal": [[3, CLUSTER_SMALL, 64],
                                            [CBPA_SEED, CBPA_PERMUTATIONS,
                                             CBPA_CHUNK]],
            "cluster_h0_err_over_rtol": h0_err,
            "cluster_p": [res[0][2].tolist(), res[1][2].tolist()],
            "exact_cluster_p": exact[0][2].tolist()}


def run_power_grid(frame, device) -> dict:
    """(b) The Level-1 fits on the host, then ``run_power_analysis`` on
    the card as tools/bench_pipeline.py:727-733 calls it, with the grid's
    seconds split into host draws, upload, each block's solve and
    download; then the first two jobs again on the CPU at the same seed.
    The planted effect's power at multiplier 1.0 must reach
    PLANTED_POWER_MIN, and the within-subject parameter whose fitted |z|
    is smallest (a near-null covariate) must reject at a rate inside
    NEAR_NULL_RATE."""
    import pandas as pd
    from mba_tpu_torch.pipeline import statistical_modelling as TStat
    from mba_tpu_torch.workflows import \
        statistics_RQ_A_omnibus_testing_workflow as TRQA
    level_defs = TRQA.fetch_level_definitions
    with tempfile.TemporaryDirectory() as tmp:
        csv = Path(tmp) / "2024-01-01 10_00_00 Combined Statistics 1seg.csv"
        frame.to_csv(csv, index=False)
        frame = pd.read_csv(csv)        # what run_power_analysis reads
        t0 = time.perf_counter()
        results, diags = [], []
        TStat.run_model_levels(frame, level_defs(False), STAT_DV, "H1",
                               1, results, diags, levels_to_include=[1],
                               verbose=False)
        fits_sec = time.perf_counter() - t0
        full = pd.DataFrame(results)
        full["N. Segments"] = 1
        cfg = TStat.PowerConfig(STAT_DV, comp_lvl=1, n_segments=1,
                                target_parameters=[],
                                n_simulations=POWER_SIMULATIONS)
        diag = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mde, curve = TStat.run_power_analysis(
            [cfg], full, Path(tmp), Path(tmp), level_defs, device=device,
            diagnostics=diag)
        power_sec = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lme = full[(full["Model_Type"] == "LME")
               & ~full["Parameter"].str.startswith("__")].set_index(
                   "Parameter")
    z = (lme["Coefficient"] / lme["SE_unadjusted"]).abs()
    between = ("Intercept", "Q('Musical skill [0-7]_centered')",
               "Q('Dancing habit [0-7]_centered')", HAPPY)
    near_null = z.drop(list(between), errors="ignore").idxmin()
    at_one = curve[curve["Effect_Multiplier"] == 1.0].set_index(
        "Parameter")["Power"]
    planted, null_rate = float(at_one[HAPPY]), float(at_one[near_null])
    n_jobs, n_refits = diag["n_jobs"], diag["n_refits"]
    nan_fraction = diag["n_nan_pvalues"] / n_refits
    _require(n_jobs >= MIN_POWER_JOBS, f"power grid: {n_jobs} jobs")
    _require(nan_fraction == 0.0, f"power grid: NaN fraction {nan_fraction}")
    _require(planted >= PLANTED_POWER_MIN,
             f"power grid: planted effect's power {planted}")
    _require(NEAR_NULL_RATE[0] <= null_rate <= NEAR_NULL_RATE[1],
             f"power grid: near-null {near_null} rejects at {null_rate}")

    # the first two jobs again, on the CPU, from the same seed: their
    # simulations are the first draws of the grid's shared generator
    gen = TStat._extract_lme_params(full, STAT_DV, 1, 1)
    design, names, subjects = level1_design(frame)
    _, subj_idx = np.unique(subjects, return_inverse=True)
    params = [q for q in gen["fixed_effects"] if q != "Intercept"]
    jobs = [(params[0], mult) for mult in cfg.effect_multipliers[:2]]
    t0 = time.perf_counter()
    cpu = TStat._simulate_jobs_and_fit(
        gen, design, names, subj_idx, jobs, POWER_SIMULATIONS, cfg.alpha,
        np.random.default_rng(cfg.random_seed), device="cpu")
    cpu_sec = time.perf_counter() - t0
    card = curve.set_index(["Parameter", "Effect_Multiplier"])["Power"]
    card = [float(card[job]) for job in jobs]
    diff = max(abs(a - b) for a, b in zip(card, cpu))
    _require(diff <= POWER_CPU_DIFF,
             f"power grid card vs CPU: {card} vs {cpu}")
    solve = diag["solve_sec"]
    return {"jobs": n_jobs, "refits": n_refits,
            "design_columns": design.shape[1], "fits_sec": fits_sec,
            "power_sec": power_sec, "host_draw_sec": diag["host_draw_sec"],
            "upload_sec": diag["upload_sec"], "solve_sec_per_block": solve,
            "solve_sec": sum(solve), "download_sec": diag["download_sec"],
            "refits_per_sec": n_refits / power_sec,
            "refits_per_solve_sec": n_refits / sum(solve),
            "nan_fraction": nan_fraction, "peak_mem_gb": peak_gb,
            "planted": HAPPY, "planted_fitted_z": float(z[HAPPY]),
            "planted_power": planted, "near_null": near_null,
            "near_null_fitted_z": float(z[near_null]),
            "near_null_rate": null_rate, "cpu_jobs": [list(j) for j in jobs],
            "card_powers": card, "cpu_powers": cpu, "cpu_sec": cpu_sec,
            "mde_rows": len(mde)}


def run_mediation_bootstrap(frame, device) -> dict:
    """(c) The Happy-vs-Silence GSR mediation of the DV: the paths on the
    host, the MEDIATION_RESAMPLES-resample bootstrap on the card, against
    the same resamples on the CPU: CI bounds and the median within
    WEIGHTED_SD_FRAC of the CI's width, the bootstrap p within two
    resamples."""
    from mba_tpu_torch.models import mediation as TM
    fit = TM.fit_mediation_model(frame, "Category or Silence",
                                 ("Happy", "Silence"), STAT_MEDIATOR, STAT_DV)
    _require(fit["status"] == "fitted", f"mediation fit: {fit['status']}")
    t0 = time.perf_counter()
    got = TM.bootstrap_indirect_effect(fit, MEDIATION_RESAMPLES,
                                       device=device)
    sec = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = TM.bootstrap_indirect_effect(fit, MEDIATION_RESAMPLES,
                                       device="cpu")
    cpu_sec = time.perf_counter() - t0
    width = ref["ci_width"]
    err = max(abs(got[k] - ref[k]) for k in
              ("ci_lower", "ci_upper", "bootstrap_median_indirect")) / width
    _require(got["bootstrap_status"] == "computed"
             and got["bootstrap_success"] == ref["bootstrap_success"]
             and err <= WEIGHTED_SD_FRAC
             and abs(got["bootstrap_p"] - ref["bootstrap_p"])
             <= 2 / MEDIATION_RESAMPLES,
             f"mediation bootstrap card vs CPU: {got} vs {ref}")
    return {"resamples": MEDIATION_RESAMPLES, "n_obs": fit["n_obs"],
            "indirect": fit["indirect_effect"], "bootstrap_sec": sec,
            "cpu_sec": cpu_sec, "ci": [got["ci_lower"], got["ci_upper"]],
            "bootstrap_p": got["bootstrap_p"], "err_over_ci_width": err}


def run_cbpa_contrasts(device) -> list:
    """(c) The two CBPA contrasts of tools/bench_pipeline.py:675-692, each
    a planted cluster (+1.2 over 10 time bins × 4 channels) in unit noise,
    12 subjects × 40 time bins, at CBPA_PERMUTATIONS sign-flip
    permutations: the 11-channel motor subset, tail 1, and all 64
    channels, tail 0.  Each must find a cluster with p < 0.05."""
    from mba_tpu_torch.channel_layout import EEG_CHANNELS
    from mba_tpu_torch.ops import permutation as TPerm
    out = []
    rng = np.random.default_rng(21)
    for channels, tail in ((CMC_EEG_CHANNEL_SUBSET, 1), (EEG_CHANNELS, 0)):
        X = rng.standard_normal((STAT_SUBJECTS, CBPA_TIMES,
                                 len(channels))).astype(np.float32)
        X[:, 15:25, :4] += 1.2
        adj = TPerm.combine_adjacency(
            CBPA_TIMES, TPerm.delaunay_channel_adjacency(list(channels)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, clusters, pv, H0 = TPerm.cluster_permutation_1samp_test(
            X, adj, n_permutations=CBPA_PERMUTATIONS, tail=tail,
            seed=CBPA_SEED, permutation_chunk=CBPA_CHUNK, device=device)
        sec = time.perf_counter() - t0
        _require(len(pv) and pv.min() < 0.05,
                 f"CBPA {len(channels)} channels: no cluster with p < 0.05 "
                 f"({pv})")
        _require(len(H0) == CBPA_PERMUTATIONS + 1
                 and bool(np.isfinite(H0).all()),
                 f"CBPA {len(channels)} channels: H0 {H0.shape}")
        out.append({"nodes": CBPA_TIMES * len(channels), "tail": tail,
                    "permutations": CBPA_PERMUTATIONS, "null_sec": sec,
                    "clusters": len(clusters), "min_p": float(pv.min())})
    return out


def reset_launches() -> None:
    cuda_msc.msc_jackknife.launches = 0
    cuda_null.null_tile.launches = 0
    cuda_coeffs.coeff_pairs.launches = 0
    cuda_prng.threefry_draw.launches = 0
    torch.cuda.reset_peak_memory_stats()


def launches() -> dict:
    return {"msc_jackknife": cuda_msc.msc_jackknife.launches,
            "null_tile": cuda_null.null_tile.launches,
            "coeff_pairs": cuda_coeffs.coeff_pairs.launches,
            "threefry": cuda_prng.threefry_draw.launches}


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

    threefry = check_prng_kernel(device)
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
    _require(n_gram["null_tile"] > 0 and n_gram["threefry"] > 0,
             f"the null main path did not launch B2 and threefry: {n_gram}")
    log(json.dumps({"phase": "null_main_path", "card": card, **gram,
                    "launches": n_gram}))
    reset_launches()
    pallas, observed_pallas = run_null(*cohort, device,
                                       coeff_engine="pallas")
    pallas["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    n_pallas = launches()
    _require(n_pallas["coeff_pairs"] > 0 and n_pallas["null_tile"] > 0
             and n_pallas["threefry"] > 0,
             f"the 'pallas' null path did not launch B3, B2 and threefry: "
             f"{n_pallas}")
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
    n_pw = launches()
    _require(n_pw["threefry"] > 0, "the per-window null did not launch "
             "threefry")
    log(json.dumps({"phase": "per_window_null", "card": card, **pw,
                    "launches": n_pw}))
    del pw_cohort
    torch.cuda.empty_cache()
    reset_launches()
    fft = run_fft_null(make_cohort(FFT_SUBJECTS, FFT_SECONDS, PW_CHANNELS,
                                   PW_CHANNELS), device)
    fft["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    n_fft = launches()
    _require(n_fft["threefry"] > 0, "the full-FFT null did not launch "
             "threefry")
    log(json.dumps({"phase": "fft_null", "card": card, **fft,
                    "launches": n_fft}))
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
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "preprocessing_small_against_cpu", "card": card,
                    **check_preprocessing_small_against_cpu(device)}))
    torch.cuda.empty_cache()
    reset_launches()
    pre = run_preprocessing_study(recording, device)
    n_pre = launches()
    log(json.dumps({"phase": "preprocessing_study_scale", "card": card,
                    **pre, "launches": n_pre}))
    del recording
    torch.cuda.empty_cache()
    narrow = check_msc_kernel(*make_signals(
        0, len(CMC_EEG_CHANNEL_SUBSET), N_EMG, SECONDS), device)
    log(json.dumps({"phase": "b1_narrow_montage", "card": card,
                    "eeg_channels": len(CMC_EEG_CHANNEL_SUBSET),
                    "emg_channels": N_EMG, **narrow}))
    torch.cuda.empty_cache()
    reset_launches()
    phase = run_phase_null(device)
    n_phase = launches()
    _require(n_phase["threefry"] > 0, "the phase null did not launch "
             "threefry")
    log(json.dumps({"phase": "phase_null_config4", "card": card, **phase,
                    "launches": n_phase}))
    torch.cuda.empty_cache()

    small = check_statistics_small_against_cpu(device)
    frame = make_statistics_frame()
    reset_launches()
    t0 = time.perf_counter()
    power = run_power_grid(frame, device)
    mediation = run_mediation_bootstrap(frame, device)
    cbpa = run_cbpa_contrasts(device)
    n_stat = launches()
    _require(n_stat["threefry"] > 0, "the statistics path did not launch "
             "threefry")
    sec = time.perf_counter() - t0
    log(json.dumps({"phase": "statistics", "card": card, "sec": sec,
                    "small_against_cpu": small, "power_grid": power,
                    "mediation": mediation, "cbpa": cbpa,
                    "launches": n_stat}))

    paths = {"cmc": n_cmc, "null_gram": n_gram, "null_pallas": n_pallas,
             "null_per_window": n_pw, "fft_null": n_fft,
             "feature_extraction": n_feat, "preprocessing": n_pre,
             "phase_null": n_phase, "statistics": n_stat}
    by_path = lambda k: {p: n[k] for p, n in paths.items()}
    kernels = [
        {"name": "msc_jackknife", "route": "cuda",
         "source": "mba_tpu_torch/csrc/msc_jackknife.cu",
         "replaces": "mba_tpu/ops/pallas_msc.py:40",
         "launches": n_cmc["msc_jackknife"],
         "launches_by_path": by_path("msc_jackknife"), **msc,
         "task_cmc_11x64": narrow},
        {"name": "null_tile", "route": "cuda",
         "source": "mba_tpu_torch/csrc/null_tile.cu",
         "replaces": "mba_tpu/ops/pallas_null.py:37",
         "launches": n_gram["null_tile"],
         "launches_by_path": by_path("null_tile"), **null},
        {"name": "coeff_pairs", "route": "cuda",
         "source": "mba_tpu_torch/csrc/coeff_pairs.cu",
         "replaces": "mba_tpu/ops/pallas_coeffs.py:83",
         "launches": n_pallas["coeff_pairs"],
         "launches_by_path": by_path("coeff_pairs"), **coeff},
        {"name": "threefry", "route": "cuda",
         "source": "mba_tpu_torch/csrc/threefry.cu", "replaces": None,
         "note": "port-only: jax.random's threefry2x32 bits for the nulls' "
                 "phases; no TPU kernel",
         "launches": n_gram["threefry"],
         "launches_by_path": by_path("threefry"), **threefry},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
