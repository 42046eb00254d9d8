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
   in its accumulate form over two chunks); meanwhile ``nvcc -Xptxas -v``
   compiles B1, B3 and B2's tensor-core source for the registers and
   spills of each instance (a ``wgmma`` serialization warning fails);
   after the timed phases, ``cuobjdump -sass`` of the library must show
   ``HGMMA`` in both 16-bit instances of B2;
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
   then the options phase, its sections timed by ``utils.profiling.
   StageTimer``: (a) the CMC leg at bench.py:146-149's own settings, an
   int8 download and an int16 upload, beside the float32 leg (its
   download ≤ 0.27× and upload ½ the float32 leg's bytes, values within
   half an int8 step of the float32 leg's per-lane spans plus 1e-4, the
   peak in the band); (b) (5b)'s null with bench.py:287-290's int16
   upload (observed map within 1e-5 of (b)'s, p_fwe < 0.01) and (c) with
   ``compute_dtype=torch.bfloat16`` and ``torch.float16`` (p_fwe <
   0.01), and B2's bf16 and f16 instances (the tensor cores) against
   their plain version on one chunk each; (d) B1 and B3 at
   nw = 5 (K = 9), nw = 9 (K = 17, the runtime-K instances) and nw =
   13.5 (K = 25) against their plain versions, timed at the main path's
   shapes (B3 also in its accumulate form, its bound with the old sums
   read), and B1's runtime-K path held bit for bit to its compile-time
   instances at K = 5 and 16 (64×64 and 11×64, both modes); (e) a small
   ``batch_layout='reference'`` ICA, card against CPU; (f) one B1
   launch under ``device_trace``, whose trace must hold its kernel;
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
10. the study pipeline of tools/bench_pipeline.py through the port's
   entry points, with every launch count set to 0 before it and read
   after (B1 and threefry must have launched), one JSON line of stage
   seconds and gate values: s1, subject 0's two 64-channel EMG grids
   (1 705 s at 2048 Hz, ``tools.synth_study``'s 30 trials of 45 s)
   written to OTB4 archives and read back as ADC counts; s2, the
   preprocessing workflow on its EEG (planted blinks, ECG, line and a
   gated 16-28 Hz drive; ICA 25) and both grids, on the card; s3,
   ``run_subject``: the log10 PSD, the task-wise CMC through B1 and the
   enriched serial frame, then subject 0's band aggregates on the card;
   subjects 1-11 as jittered copies of its artifacts; s4, the Combined
   Statistics frames at 1, 2, 5 and 10 segments for 12 subjects; s5, the
   RQ-A omnibus (14 DVs × 4 levels × 4 resolutions, FDR on levels 2-3),
   the two CBPA contrasts assembled from the stored artifacts (1 024
   permutations each, signs by threefry, the null on the card), the
   LOSO influence, the 500-simulation power grid and the Markdown report
   (``build_report`` on the results, with the methods note of one small
   ``cohort_msc_null`` run on the card before the counted run: one
   section per hypothesis and DV of the omnibus, frame-validation
   warnings only for the frames the phase does not write where the
   report reads).  Gates G1-G4 of tools/bench_pipeline.py:24-36: the
   music-trial beta CMC above the Beta(K−2, K−2) threshold; the
   music-over-silence Fisher-z gap above 0.15 with one-sided Welch
   p < 1e-3; the Level-0 music effect on ``CMC_Flexor_max_beta``
   positive with p < 0.05; a Happy-vs-Silence CMC cluster at p < 0.05.
   Then, on subject 0 of the same tree, the time-alignment validation:
   the EMG PSD and force loaded from s3's artifacts, the flexor/extensor
   power ratio (Welch) of the preprocessed grids on the card (and of
   their first 300 s on the card against the CPU), the envelope-force
   identity check (resampling) on the card against the CPU, the
   per-trial alignment and the cohort's sampling-rate sweep;
11. the music features: a synthetic 120-s 16-bit mono click track at
   44.1 kHz, 120 BPM with a syncopated click in each beat, through
   ``compute_all_musical_features`` on the card and on the CPU: the STFT
   magnitudes within tests/test_torch_music.py's tolerance, the BPM and
   the onset count equal, the BPM within 2 of the planted tempo;
12. the multi-device layer (``mba_tpu_torch.parallel`` and the nulls'
   ``mesh=``): (a) a world of one NCCL rank on the card, with the launch
   counts set to 0 before and read after: ``cohort_multitaper_msc``
   (jackknife, EMG max-pool) on (5)'s 12-subject cohort,
   ``cohort_msc_rotation_null(mesh=…, coeff_engine='pallas')`` at 10 000
   surrogates on it, ``time_sharded_msc`` of its subject 0 and config
   4's phase null: the cohort CMC equal to each subject's
   ``multitaper_msc`` and the time-sharded CMC to subject 0's within
   5e-5, the nulls' observed maps equal to the unsharded ones, the
   planted coupling at p_fwe < 0.01 and config 4 at p_fwe ≥ 0.01; B1,
   B2, B3 and threefry launched; (b) two gloo ranks spawned on the one
   card: the same three calls on 4 subjects × 30 s × 64×64 at 2 000
   surrogates (each rank's calls timed and its launches counted), then
   the four calls at 3 subjects × 8 s × 4×4 on the card and on the CPU
   in the same ranks: CMC within 5e-5 (the CIs within
   ``cuda_msc.ci_tolerance``), the rotation null's maxima within the
   gram tolerance, the phase null's within 1e-4/5e-5, ``p_fwe`` equal.
   The ranks' CPU reference is the same on every host: MESH_CPU_THREADS
   threads each and MKL in its reproducible mode (MESH_RANK_ENV); their
   CPU settings are printed, and on a failed comparison both ranks'
   arrays go into ``chip_smoke_out/mesh_small_failure_*/ranks.npz``.
   A rank that fails, or a join past its limit, fails the phase;
13. one JSON line describing the kernels (B2's bf16 and f16 instances
   their own entries, bound by the tensor cores' 989 TFLOP/s and timed
   beside ``torch.bmm`` in their type, B1 and B3 with their K = 9, 17
   and 25 checks, and the registers and spills of every instance): per
   kernel its launches on its main path (and on every path,
   ``launches_by_path``), its error against the plain version,
   CUDA-event times of the kernel and the plain version, its bound (the larger of the bytes it must move over
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

import atexit
import datetime
import json
import math
import os
import re
import shutil
import signal
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
from mba_tpu_torch.ops.framing import band_spectra, frame_signal, window_grid
from mba_tpu_torch.pipeline import preprocessing as TP
from mba_tpu_torch.pipeline import signal_features as TF
from mba_tpu_torch.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET
from mba_tpu_torch.utils.profiling import StageTimer, annotate, device_trace
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
PEAK_BF16_FLOPS = 989e12          # tensor cores, dense
PEAK_HBM_BYTES = 3.35e12
# the options phase (bench.py's own transfer settings): the CMC leg's int8
# download and int16 upload (bench.py:146-149) against the float32 leg;
# the null's int16 upload (bench.py:287-290); the null in bf16; B1 and B3
# at nw = 5 (K = 9) and nw = 9 (K = 17, the runtime-K instances above
# the K <= 16 compile-time ones); a small reference-layout ICA
OPT_DOWNLOAD_SHARE = 0.27   # int8 payload ¼ + per-(freq, EEG) sidecars
# the int16 upload's rounding of the signal (≤ 2^-16 of each channel's
# peak, ~4.8 σ here) moved the coherence by up to 2.8e-4 at the main
# path's shapes (NVIDIA H100 80GB HBM3, 700 W), within OPT_CMC_SLACK, and
# the CIs further where it moves a near-tied EMG pick or Fisher z
# amplifies it near 1: 0.013 % of the cells left half a step plus
# OPT_CMC_SLACK (0.17 % with 1e-4), within OPT_CI_MOVED
OPT_CMC_SLACK = 5e-4
OPT_CI_MOVED = 5e-3
OPT_NULL_OBS_ATOL = 1e-5    # int16 upload: the observed map
OPT_NWS = (5, 9)
B1_CMP_WINDOWS = 3          # the plain jackknife's (W, K, F, E, M) tensors
# B1 and B3 against their plain versions at a larger K too: nw 13.5 gives
# K = 25 at the main path's 4 096-sample windows (nw 13 gives 24 there);
# B1's runtime-K path held bit for bit to its compile-time instances at
# nw 3 and 8.5 (K = 5 and 16)
OPT_NW_LARGE = 13.5
OPT_B1_BITWISE_NWS = (3, 8.5)
ICA_REF_SHAPE, ICA_REF_BLOCK, ICA_REF_EPOCHS = (256 * 60, 4), 80, 3
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
# the study pipeline (tools/bench_pipeline.py): s1-s3 on one subject of
# tools/synth_study's study layout (30 trials of 45 s, 1 705 s at 2048 Hz),
# s4-s5 on 12 subjects, the frames at 1, 2, 5 and 10 segments; G2's
# Fisher-z gap and Welch p (tools/bench_pipeline.py:569); the planted
# beta drive's band (:66)
PIPE_SUBJECTS, PIPE_SEGMENTS = 12, (1, 2, 5, 10)
PIPE_BETA = (16.0, 28.0)
PIPE_Z_GAP, PIPE_WELCH_P = 0.15, 1e-3
# the report's methods note: one cohort_msc_null call on the card at
# check_small_against_cpu's cohort (2 subjects × 12 s × 8×8); at 20 000
# surrogates its full-FFT estimate (5.1e12 flop) is over the CUDA budget,
# so the rotation engine runs and the note on its detection limit shows;
# the frames validate_frames may find empty where the report reads
# (tools/bench_pipeline.py:739): the phase runs no subject-effect summary
# and writes its CBPA summary under stats_out/cbpa
REPORT_NULL_SURROGATES = 20_000
REPORT_EMPTY_FRAMES = ("subject_heterogeneity", "cbpa_results")
# the time-alignment validation: card against CPU at the CPU tests'
# tolerance (tests/test_torch_time_alignment.py); the power ratio's CPU
# Welch takes ~8 s over both whole grids, so card and CPU are compared on
# their first ALIGN_HEAD_SEC (the card also runs the whole grids)
ALIGN_RTOL = 1e-5
ALIGN_HEAD_SEC = 300.0
# the music phase: a 120-s 16-bit mono click track at 44.1 kHz, 120 BPM,
# a 1-kHz click on each beat and a softer 1.5-kHz one three quarters into
# it; the STFT card against CPU at tests/test_torch_music.py's tolerance
MUSIC_SR, MUSIC_SECONDS, MUSIC_BPM = 44100, 120.0, 120.0
MUSIC_SYNCOPATION, MUSIC_BPM_TOL = 0.75, 2.0
MESH_RANKS = 2                  # gloo ranks sharing the one card
MESH_SUBJECTS, MESH_SECONDS, MESH_SURROGATES = 4, 30.0, 2000
MESH_SMALL = (3, 8.0, 4)        # subjects, seconds, channels: card vs CPU
MESH_SMALL_SURROGATES, MESH_SMALL_CHUNK = 1000, 250
MESH_PG_TIMEOUT_SEC, MESH_JOIN_SEC = 300, 420
# The ranks' CPU reference, the same on every host: a fixed thread count
# per rank, and MKL (torch's CPU FFT and BLAS) in its conditional
# numerical reproducibility mode, whose code path does not depend on the
# host's instruction set (AVX-512, AVX2 and SSE4.2 paths round the FFT
# differently; ROADMAP C15)
MESH_CPU_THREADS = 4
MESH_RANK_ENV = {"MKL_CBWR": "COMPATIBLE"}
STFT_RTOL, STFT_ATOL = 1e-5, 1e-6      # atol × the spectrum's maximum


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


def roofline(ms: float, flops: float, nbytes: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> dict:
    """The least time the card could take for ``flops`` operations at
    ``peak_flops`` (float32 on the CUDA cores by default) and ``nbytes``
    moved once, what bounds it, and the share of it that ``ms``
    reaches."""
    t_ops = flops / peak_flops * 1e3
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


def main_path_msc_chunk(eeg, emg, device, nw=NW):
    """The tapered spectra of the main path's first window chunk: the
    exact operands ``multitaper_msc`` hands to the B1 wrapper (at ``nw``,
    whose taper count sets the chunk)."""
    ws = int(WINDOW_SEC * FS)
    tapers = filtered_tapers(ws, nw, 0.9)
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


def null_check_state(device, K=5, seed=0, dtype=torch.float32):
    """Random rotation-null state at the main path's shapes: nF band
    bins of 13-100 Hz at 2-s windows, J subjects, N = E·M cells and
    P = K(K−1) features; coefT in ``dtype``."""
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
    return TN.null_state(base, coef, obs, dtype), prng.prng_key(seed), K


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


def _coeff_instance(entry: str):
    """B3's instance label of a kernel entry name, or None."""
    m = re.search(r"coeff_pairs_kernelILi(\d+)E\w*?Lb([01])E", entry)
    if m:
        return f"K={m.group(1)} {('narrow', 'wide')[int(m.group(2))]}"
    if "coeff_powers_kernel" in entry:
        return "K=any powers"            # the runtime-K instance's first pass
    return "K=any" if "coeff_pairs_rt_kernel" in entry else None


def _msc_instance(entry: str):
    """B1's instance label of a kernel entry name, or None: "K=5 emg_max"
    (compile-time), "K<=20 emg_max" (runtime-K, bucket 20; "K<=16" serves
    the forced runtime-K path at K <= 16), "K=any emg_max" (beyond the
    buckets)."""
    m = re.search(r"msc_jackknife_(kernel|rt_kernel|any_kernel)I"
                  r"(?:Li(\d+)E)?(?:Li\d+E)?Lb([01])E", entry)
    if not m:
        return None
    mode = ("full", "emg_max")[int(m.group(3))]
    k = {"kernel": f"K={m.group(2)}", "rt_kernel": f"K<={m.group(2)}",
         "any_kernel": "K=any"}[m.group(1)]
    return f"{k} {mode}"


def _tc_instance(entry: str):
    """B2's tensor-core instance label of a kernel entry name, or None."""
    m = re.search(r"null_tile_tc_kernelILb([01])E", entry)
    return ("bf16", "f16")[int(m.group(1))] if m else None


# source: (entry name → instance label, every label expected)
PTXAS_SOURCES = {
    "coeff_pairs": (_coeff_instance,
                    [f"K={k} {w}" for k in range(2, 17)
                     for w in ("narrow", "wide")] + ["K=any",
                                                     "K=any powers"]),
    "msc_jackknife": (_msc_instance,
                      [f"{k} {w}" for k in [*(f"K={k}" for k in range(2, 17)),
                                            "K<=16", "K<=18", "K<=20",
                                            "K<=24", "K<=32",
                                            "K=any"]
                       for w in ("full", "emg_max")]),
    "null_tile_tc": (_tc_instance, ["bf16", "f16"]),
}


def ptxas_start() -> dict:
    """Start ``nvcc -Xptxas -v`` of B3's, B1's and B2's tensor-core
    sources with the build's flags, one process a source, to run while
    the card works; collect with :func:`ptxas_report`."""
    procs = {}
    for stem in PTXAS_SOURCES:
        obj = _build.BUILD_DIR / f"ptxas_report.{stem}.{os.getpid()}.o"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-c", "-o", str(obj), str(_build.CSRC_DIR / f"{stem}.cu")]
        procs[stem] = (obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True))
    atexit.register(_stop, [proc for _, proc in procs.values()])
    return procs


def _stop(procs) -> None:
    """Kill what is still running of ``procs`` (a phase that failed),
    with the compilers each nvcc started (its process group)."""
    for proc in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def ptxas_report(procs: dict) -> dict:
    """Registers and spills of each instance of B3, B1 and B2's tensor-
    core source from the processes of :func:`ptxas_start`:
    {"coeff_pairs": {"K=5 wide": {"registers": .., "spill_stores": ..,
    "spill_loads": ..}, ...}, "msc_jackknife": {"K=5 emg_max": ...},
    "null_tile_tc": {"bf16": ..., "f16": ...}} (bytes for spills).  B3's
    "wide" is the instance whose lanes span 32 EMG channels (M = 64 on
    the main path), "narrow" the one for fewer; B1's "emg_max" and
    "full" its two modes; "K=any" the runtime-K instances.  A warning
    that ptxas serialized a source's ``wgmma``s fails."""
    report = {}
    for stem, (obj, proc) in procs.items():
        try:
            text, _ = proc.communicate(timeout=600)
        finally:
            obj.unlink(missing_ok=True)
        _require(proc.returncode == 0, f"nvcc -Xptxas -v {stem} failed:\n"
                 f"{text}")
        label_of, expected = PTXAS_SOURCES[stem]
        serialized = [line for line in text.splitlines()
                      if "wgmma" in line and "serializ" in line]
        _require(not serialized, f"ptxas serialized wgmma in {stem}: "
                 f"{serialized}")
        out, k = {}, None
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                k = label_of(entry.group(1))
                continue
            if k is None:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            if spill:
                out.setdefault(k, {}).update(
                    spill_stores=int(spill.group(1)),
                    spill_loads=int(spill.group(2)))
            used = re.search(r"Used (\d+) registers", line)
            if used:
                out.setdefault(k, {})["registers"] = int(used.group(1))
        _require(sorted(out) == sorted(expected),
                 f"ptxas report of {stem} lacks an instance: {sorted(out)}")
        report[stem] = out
    return report


def sass_hgmma(lib_path: Path) -> dict:
    """``HGMMA`` instructions (the warpgroup products on the tensor cores)
    in each 16-bit instance of B2, from ``cuobjdump -sass`` of the built
    library: {"bf16": n, "f16": n}; none in either fails.  Run after the
    timed phases: the dump keeps host cores busy for a while."""
    exe = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).with_name("cuobjdump"))
    proc = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=600)
    _require(proc.returncode == 0, f"cuobjdump -sass failed:\n"
             f"{(proc.stdout + proc.stderr)[-2000:]}")
    counts, label = {"bf16": 0, "f16": 0}, None
    for line in proc.stdout.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            label = _tc_instance(fn.group(1))
        elif label and re.search(r"\bHGMMA\b", line):
            counts[label] += 1
    _require(min(counts.values()) > 0, f"B2's 16-bit instances lack HGMMA "
             f"in the SASS: {counts}")
    return counts


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


def coeff_chunks(cohort, device, nw=NW):
    """The main path's two first B3 chunks at ``nw``: WINDOW_CHUNK
    windows each of the bench cohort's first subject, weighted by the
    disjoint subset (half of them 0), 13-100 Hz (nF = 175), 64×64."""
    ws = int(WINDOW_SEC * FS)
    tapers = torch.as_tensor(filtered_tapers(ws, nw, 0.9),
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
                             ws, lo, hi).contiguous() for x in cohort)
        chunks.append((e, m, w))
    return chunks


def coeff_work(wc, K, nF, E, M, accumulate=False) -> tuple[float, float]:
    """(flops, bytes) of one B3 chunk: per (window, f, e, m) the
    denominator and its scale (4), per taper the cross term, its scaling
    and |y|² into the diagonal (12), per pair k < l the complex product
    into the sums (8); spectra read once, the 1 + 2·P2 sums written
    once and, in the accumulate form (``out=``), the old sums read once
    too."""
    P2 = K * (K - 1) // 2
    flops = wc * nF * E * M * (4 + 12 * K + 8 * P2)
    sums = 4 * (1 + 2 * P2) * nF * E * M
    nbytes = (8 * wc * K * nF * (E + M) + 4 * wc
              + sums * (2 if accumulate else 1))
    return float(flops), float(nbytes)


def check_coeff_kernel(cohort, device, reps=10) -> dict:
    """B3 against its plain version at the main path's chunk
    (:func:`coeff_chunks`, K = 5).  The sums over the chunk's weight sum
    within COEFF_RTOL / COEFF_ATOL.  Then the accumulate form, as
    ``rotation_coeffs_subject`` runs it: the next WINDOW_CHUNK windows
    added by the kernel into the first chunk's sums (``out=``), against
    the plain version's ``add_``, over both chunks' weight sum."""
    (e, m, w), second = coeff_chunks(cohort, device)
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
    wc, K, nF, E = e.shape
    M = m.shape[-1]
    acc = roofline(ms_acc, *coeff_work(wc, K, nF, E, M, accumulate=True))
    out = {"max_abs_err": max(errs.values()) * wsum,
           "accumulate_max_abs_err": max(errs2.values()) * wsum2,
           "ms": ms, "accumulate_ms": ms_acc, "plain_ms": plain_ms,
           **roofline(ms, *coeff_work(wc, K, nF, E, M)),
           "accumulate_bound_ms": acc["bound_ms"],
           "accumulate_bound_by": acc["bound_by"],
           "accumulate_share_of_bound": acc["share_of_bound"],
           "library_ms": None, "shape": [wc, K, nF, E, M]}
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
            "quantize_sec": t["quantize_sec"],
            "upload_bytes": t["upload_bytes"],
            "coeff_engine": t["coeff_engine"],
            "compute_dtype": res["metadata"]["compute_dtype"],
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
    eeg, emg = config4_pair()
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
        if name == "uncoupled":
            observed = res["observed"]
        out[name] = {"wall_sec": wall, "n_surrogates": n_surr,
                     "p_fwe": res["p_fwe"],
                     "observed_max": res["observed_max"],
                     "null_q95_max": float(res["null_quantiles"][0.95]
                                           .max()),
                     "timings": res["timings"],
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out, observed


def config4_pair() -> tuple:
    """bench.py config 4's uncoupled pair (bench.py:209-212)."""
    rng = np.random.default_rng(3)
    n = int(FS * SECONDS)
    return (rng.standard_normal((n, 1)).astype(np.float32),
            rng.standard_normal((n, 1)).astype(np.float32))


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


def synth_pipeline_subject(plan, fs, seed=0):
    """The pipeline's recording, as tools/bench_pipeline.py:100-148 makes
    it over the port's ``tools.synth_study`` plan (sample 0 at the log's
    measurement start): mV-scale EEG (10 µV noise) with blinks, an ECG
    train, a 50-Hz line and a PIPE_BETA drive under signed per-channel
    gains, gated per trial (music 1.0, silence SILENCE_GAIN, rest 0); two
    EMG grids in mV sharing the drive.  Returns (eeg, flexor, extensor),
    float32 (samples, 64)."""
    rng = np.random.default_rng(seed)
    n = plan.n_samples
    t = np.arange(n) / fs
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1 / fs)
    spec[(f < PIPE_BETA[0]) | (f > PIPE_BETA[1])] = 0
    drive = np.fft.irfft(spec, n=n).astype(np.float32)
    drive /= drive.std() + 1e-12
    drive *= plan.drive_gate(rng)
    blink = np.zeros(n, np.float32)
    w = int(0.3 * fs)
    for onset in rng.integers(0, n - int(fs), 150):
        blink[onset:onset + w] += np.hanning(w)[:len(blink[onset:onset + w])]
    ecg = np.zeros(n, np.float32)
    w = int(0.05 * fs)
    for beat in np.arange(0, n, int(0.85 * fs)):
        ecg[beat:beat + w] += np.hanning(w)[:len(ecg[beat:beat + w])] * 3
    line = np.sin(2 * np.pi * 50.0 * t).astype(np.float32)
    eeg = rng.standard_normal((n, N_EEG), dtype=np.float32) * 1e-2
    gains = rng.uniform(0.3, 1.0, N_EEG) * rng.choice([-1.0, 1.0], N_EEG)
    eeg += 5e-3 * drive[:, None] * gains[None, :].astype(np.float32)
    front = np.zeros(N_EEG, np.float32)
    front[:4] = [5e-2, 5e-2, 3e-2, 3e-2]
    eeg += blink[:, None] * front[None, :]
    eeg += ecg[:, None] * rng.uniform(1e-3, 4e-3, N_EEG)[None, :]
    eeg += 2e-3 * line[:, None] * rng.uniform(0.5, 1.5, N_EEG)[None, :]

    def emg_like(gain):
        x = rng.standard_normal((n, N_EMG), dtype=np.float32) * 0.05
        x += gain * drive[:, None] * rng.uniform(0.3, 1.0, N_EMG)[None, :]
        x += 0.01 * line[:, None]
        return x
    return eeg, emg_like(0.03), emg_like(0.008)


def write_replica_artifacts(feat_root, subject, psd_aggs, cmc_aggs,
                            channel_suffix) -> None:
    """tools/bench_pipeline.py:236-260: subject ``subject``'s lean
    artifacts as a jittered copy of subject 0's band aggregates, CMC ×
    a subject gain + noise (clipped to [0, 1]), log10 PSD + a subject
    offset + noise."""
    rng = np.random.default_rng(5000 + subject)
    sub_dir = feat_root / f"subject_{subject:02}"
    sub_dir.mkdir(parents=True, exist_ok=True)
    for modality, (payload, tc, names, edges) in psd_aggs.items():
        jit = payload + rng.normal(0, 0.10) \
            + rng.normal(0, 0.03, payload.shape).astype(np.float32)
        TF.save_band_aggregates(jit, tc, names, edges, "PSD", sub_dir,
                                identifier_suffix=modality)
    for muscle, (payload, tc, names, edges) in cmc_aggs.items():
        a_s = rng.normal(1.0, 0.08)
        jit = np.clip(payload * a_s + rng.normal(0, 0.01, payload.shape)
                      .astype(np.float32), 0.0, 1.0)
        TF.save_band_aggregates(
            jit, tc, names, edges, "CMC", sub_dir,
            identifier_suffix=f"{muscle} Trial-wise {channel_suffix}")


class _StageClock:
    """Wraps module functions so each call is timed on the host clock,
    closed by ``torch.cuda.synchronize()``; ``restore`` puts them back.
    Records seconds per name, one entry per call."""

    def __init__(self):
        self.sec: dict[str, list[float]] = {}
        self._saved = []

    def wrap(self, module, name, label=None):
        fn = getattr(module, name)
        label = label or name

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.sec.setdefault(label, []).append(time.perf_counter() - t0)
            return out
        self._saved.append((module, name, fn))
        setattr(module, name, timed)

    def restore(self):
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved.clear()


def pipeline_cmc_gates(feat0, plan, fs) -> dict:
    """G1 and G2 of tools/bench_pipeline.py:522-580 on subject 0's stored
    task-wise flexor CMC: per window in each trial's derived task span
    (half a window in from each end), the channel mean of the beta-band
    peak; G1: its music mean above the Beta(K−2, K−2) independence
    threshold; G2: music over silence on the Fisher-z scale by more than
    PIPE_Z_GAP with a one-sided Welch p below PIPE_WELCH_P."""
    from scipy import stats
    coh, tc, fr = TF.fetch_stored_spectrograms(
        feat0, "CMC", ["Flexor", "Channels_" + "_".join(
            CMC_EEG_CHANNEL_SUBSET)], expected_n_channels=len(
            CMC_EEG_CHANNEL_SUBSET))
    K = filtered_tapers(int(WINDOW_SEC * fs), NW, 0.9).shape[0]
    beta = (fr >= PIPE_BETA[0]) & (fr <= PIPE_BETA[1])

    def peak_per_window(spans):
        sel = np.zeros(len(tc), bool)
        for t_s, t_e in spans:
            sel |= (tc >= t_s + WINDOW_SEC / 2) & (tc <= t_e - WINDOW_SEC / 2)
        peak = coh[np.ix_(sel, beta)].max(axis=1)
        peak = peak.reshape(peak.shape[0], -1).mean(axis=1)
        z = np.arctanh(np.sqrt(np.clip(peak, 0.0, 1.0 - 1e-7)))
        return float(np.nanmean(peak)), z, int(sel.sum())

    music, z_music, n_music = peak_per_window(
        plan.signal_relative_spans("music"))
    silence, z_sil, n_sil = peak_per_window(
        plan.signal_relative_spans("silence"))
    gap = float(np.nanmean(z_music) - np.nanmean(z_sil))
    t_stat, p_one = stats.ttest_ind(z_music[~np.isnan(z_music)],
                                    z_sil[~np.isnan(z_sil)],
                                    equal_var=False, alternative="greater")
    thresh = float(TC.cmc_independence_threshold(int(K)))
    gates = {"g1_music_cmc_beta": music, "g1_beta_threshold_K": int(K),
             "g1_beta_threshold": thresh, "g2_silence_cmc_beta": silence,
             "g2_fisher_z_gap": gap, "g2_welch_t": float(t_stat),
             "g2_welch_p_one_sided": float(p_one),
             "g2_n_windows": [n_music, n_sil]}
    _require(music > thresh, f"G1: music-trial beta CMC {music:.4f} is not "
             f"above the Beta(K-2, K-2) threshold {thresh:.4f} (K={K})")
    _require(gap > PIPE_Z_GAP and p_one < PIPE_WELCH_P,
             f"G2: Fisher-z gap {gap:.4f}, Welch p {p_one:.3g} "
             f"(n={n_music}/{n_sil})")
    return gates


def run_pipeline(device, null_metadata) -> dict:
    """The study pipeline of tools/bench_pipeline.py through the port's
    entry points: s1-s3 on one subject at study scale, s4-s5 on a
    12-subject tree (module docstring, phase 10), then the time-alignment
    validation on its subject 0.  Each stage is timed on the host clock
    after ``torch.cuda.synchronize()``; G1-G4 must hold.  The report's
    methods section reads ``null_metadata``."""
    import shutil
    import pandas as pd
    from mba_tpu_torch.io.otb4 import read_otb4, write_otb4
    from mba_tpu_torch.pipeline import cbpa as TCB
    from mba_tpu_torch.pipeline import statistical_modelling as TStat
    from mba_tpu_torch.tools import synth_study as S
    from mba_tpu_torch.utils import file_management as filemgmt
    from mba_tpu_torch.workflows import \
        statistics_data_preparation_workflow as TSD
    from mba_tpu_torch.workflows import \
        statistics_RQ_A_omnibus_testing_workflow as TA
    from mba_tpu_torch.workflows import statistics_report_workflow as TRW
    from mba_tpu_torch.workflows import \
        subject_feature_extraction_workflow as TSF
    from mba_tpu_torch.workflows.paths import StudyPaths

    stages, detail = {}, {}

    def tick():
        torch.cuda.synchronize()
        return time.perf_counter()

    t0 = tick()
    plan = S.TrialPlan()
    fs = S.FS
    eeg, emg1, emg2 = synth_pipeline_subject(plan, fs)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_pipeline_"))
    paths = StudyPaths(work)
    exp_root, feat_root = paths.experiment_data, paths.feature_data
    feat0 = paths.subject_feature_dir(0)
    feat0.mkdir(parents=True)
    for subject in range(PIPE_SUBJECTS):
        S.write_subject_tree(exp_root, subject, plan,
                             write_raw_serial=(subject == 0))
    lookup = S.write_music_lookup(paths.song_characteristics, plan)
    stages["synthesis_sec"] = tick() - t0
    detail["recording_sec"] = plan.rec_sec
    detail["samples"] = plan.n_samples
    clock = _StageClock()
    try:
        # s1: the EMG grids through an OTB4 archive (:312-323)
        grids = {}
        for key, emg in (("emg_1_flexor", emg1), ("emg_2_extensor", emg2)):
            write_otb4(work / f"{key}.otb4", emg.T, fs)
        del emg1, emg2
        t0 = tick()
        for key in ("emg_1_flexor", "emg_2_extensor"):
            parsed = read_otb4(work / f"{key}.otb4", raw_counts=True)
            grids[key] = (parsed["signals"][0][1].T,
                          parsed["mv_per_count"][0])
        stages["s1_otb4_import_sec"] = tick() - t0
        _require(all(c.dtype == np.int16 and c.shape == (plan.n_samples,
                                                         N_EMG)
                     for c, _ in grids.values()), "s1: OTB4 counts")

        # s2: the preprocessing workflow on the EEG and both grids, in mV
        # (tools/bench_pipeline.py:335-417: 3-mV amplitude rule, ICA 25
        # on the EEG, no Laplacian on the grids), every stage on the card
        t0 = tick()
        np.save(feat0 / filemgmt.file_title(f"Raw eeg {N_EEG}ch", ".npy"),
                eeg)
        for key, (counts, mv) in grids.items():
            np.save(feat0 / filemgmt.file_title(f"Raw {key} {N_EMG}ch",
                                                ".npy"),
                    counts.astype(np.float32) * mv[None, :])
        del eeg, grids
        stages["s2_raw_save_sec"] = tick() - t0
        t0 = tick()
        prep = TPW.preprocess_subject_modality(
            0, "eeg", feat0, sampling_freq=int(fs), device=device,
            device_resident=True, amplitude_rejection_threshold=3.0)
        ica = prep.ica_result
        detail["s2_ica"] = {"n_iter": ica.n_iter_, "max_iter": ica.max_iter,
                            "excluded": list(ica.exclude),
                            "epochs_sec": ica.timings_.get("epochs_sec"),
                            "bad_channels": prep.bad_channels}
        del prep, ica
        torch.cuda.empty_cache()
        stages["s2_eeg_sec"] = tick() - t0
        t0 = tick()
        for key in ("emg_1_flexor", "emg_2_extensor"):
            prep = TPW.preprocess_subject_modality(
                0, key, feat0, sampling_freq=int(fs), device=device,
                device_resident=True, amplitude_rejection_threshold=3.0,
                laplacian_filter_neighbor_radius=None)
            detail[f"s2_{key}_bad_channels"] = prep.bad_channels
            del prep
        torch.cuda.empty_cache()
        stages["s2_emg_sec"] = tick() - t0

        # s3: run_subject (PSD, task-wise CMC through B1, serial frame),
        # then subject 0's band aggregates on the card
        for name in ("extract_psd_features", "extract_cmc_features",
                     "build_enriched_serial_frame"):
            clock.wrap(TSF, name)
        t0 = tick()
        TSF.run_subject(0, paths, sampling_freq=fs, device=device)
        stages["s3_run_subject_sec"] = tick() - t0
        clock.restore()
        detail["s3_split_sec"] = {k: v[0] for k, v in clock.sec.items()}
        t0 = tick()
        psd_aggs, cmc_aggs = {}, {}
        for modality in ("eeg", "emg_1_flexor", "emg_2_extensor"):
            spec, tc, fr = TF.fetch_stored_spectrograms(feat0, "PSD",
                                                        modality)
            payload, names, edges = TF.band_aggregate_spectrogram(
                torch.from_numpy(spec).to(device), fr)
            payload = payload.cpu().numpy()
            TF.save_band_aggregates(payload, tc, names, edges, "PSD", feat0,
                                    identifier_suffix=modality)
            psd_aggs[modality] = (payload, tc, names, edges)
            detail[f"s3_psd_{modality}_shape"] = list(spec.shape)
            del spec
        suffix = "Channels_" + "_".join(CMC_EEG_CHANNEL_SUBSET)
        for muscle in ("Flexor", "Extensor"):
            coh, tc, fr = TF.fetch_stored_spectrograms(feat0, "CMC",
                                                       [muscle, suffix])
            payload, names, edges = TF.band_aggregate_spectrogram(
                torch.from_numpy(coh).to(device), fr)
            payload = payload.cpu().numpy()
            TF.save_band_aggregates(
                payload, tc, names, edges, "CMC", feat0,
                identifier_suffix=f"{muscle} Trial-wise {suffix}")
            cmc_aggs[muscle] = (payload, tc, names, edges)
            detail[f"s3_cmc_{muscle}_shape"] = list(coh.shape)
        stages["s3_band_aggregates_sec"] = tick() - t0
        gates = pipeline_cmc_gates(feat0, plan, fs)

        # subjects 1-11: jittered copies of subject 0's artifacts and
        # serial frame (tools/bench_pipeline.py:584-597)
        t0 = tick()
        serial0 = filemgmt.most_recent_file(
            paths.subject_experiment_dir(0) / "serial_measurements", ".csv",
            ["Enriched Serial Frame"])
        serial0 = pd.read_csv(serial0, index_col=0)
        for subject in range(1, PIPE_SUBJECTS):
            write_replica_artifacts(feat_root, subject, psd_aggs, cmc_aggs,
                                    suffix)
            rng = np.random.default_rng(6000 + subject)
            rep = serial0.copy()
            rep["bpm"] = rep["bpm"] * rng.normal(1.0, 0.05)
            rep["hrv"] = rep["hrv"] * rng.normal(1.0, 0.1)
            rep["gsr"] = rep["gsr"] + rng.normal(0, 0.2)
            rep.to_csv(paths.subject_experiment_dir(subject)
                       / "serial_measurements"
                       / filemgmt.file_title("Enriched Serial Frame", ".csv"))
        del serial0, rep, psd_aggs, cmc_aggs
        stages["synthesis_replicas_sec"] = tick() - t0

        # s4: the Combined Statistics frames at four resolutions, one
        # input cache (:598-613)
        t0 = tick()
        cache: dict = {}
        frames = {n: TSD.build_combined_statistics_frame(
            list(range(PIPE_SUBJECTS)), exp_root, feat_root, n,
            music_lookup_table_path=lookup, input_cache=cache)
            for n in PIPE_SEGMENTS}
        del cache
        stages["s4_frames_sec"] = tick() - t0
        n_trials = len(plan.trials)
        for n, frame in frames.items():
            dvs = [c for c in frame.columns if c.startswith(("CMC_", "PSD_"))]
            _require(len(frame) == PIPE_SUBJECTS * n_trials * n
                     and len(dvs) == 14
                     and bool(np.isfinite(frame[dvs].to_numpy(float)).all()),
                     f"s4: {n}seg frame {frame.shape}, {len(dvs)} DVs")
            _require(frame["Median_Heart_Rate"].notna().all()
                     and frame["RMS_Accuracy"].notna().any(),
                     f"s4: {n}seg serial/accuracy columns empty")
        detail["s4_rows"] = {str(n): len(f) for n, f in frames.items()}

        # s5: the omnibus at the reference's breadth (:634-638)
        out_dir = work / "stats_out"
        t0 = tick()
        combined = TA.run_omnibus(feat_root, out_dir,
                                  n_within_trial_segments_list=list(
                                      PIPE_SEGMENTS),
                                  hypotheses=TA.RQA_HYPOTHESES,
                                  fdr_levels=(2, 3),
                                  make_forest_mosaics=False)
        stages["s5_omnibus_sec"] = tick() - t0
        detail["s5_omnibus_models"] = int(combined[
            ["Hypothesis", "Comparison_Level", "N. Segments",
             "Model_Type"]].drop_duplicates().shape[0])
        detail["s5_omnibus_rows"] = len(combined)
        lvl0 = combined[
            (combined["Hypothesis"] == "H1: Flexor Beta Peak CMC")
            & combined["Comparison_Level"].astype(str).str.startswith(
                "Level 0")
            & (combined["N. Segments"] == 1)
            & (combined["Model_Type"] == "LME")
            & combined["Parameter"].astype(str).str.contains(
                "Music Listening")
            & ~combined["Parameter"].astype(str).str.contains(":")]
        _require(len(lvl0) == 1, f"G3: {len(lvl0)} Level-0 rows")
        beta_hat = float(lvl0["Coefficient"].iloc[0])
        p_val = float(lvl0["p_value"].iloc[0])
        gates["g3_music_effect_beta"] = beta_hat
        gates["g3_music_effect_p"] = p_val
        _require(beta_hat > 0 and p_val < 0.05,
                 f"G3: Level-0 music effect beta {beta_hat}, p {p_val}")

        # s5: CBPA from the stored artifacts, nulls on the card (:675-711)
        cfgs = [TCB.CBPAConfig(
            modality="CMC", modality_file_id="Flexor", freq_band="beta",
            condition_A="Happy", condition_B="Silence",
            n_permutations=CBPA_PERMUTATIONS, tail=1, data_root=work,
            cmc_time_window_sec=WINDOW_SEC, output_dir=out_dir / "cbpa",
            hypothesis_label="cbpa_cmc_happy_vs_silence", save_plots=False,
            device=device), TCB.CBPAConfig(
            modality="PSD", modality_file_id="eeg", freq_band="alpha",
            condition_A="Happy", condition_B="Silence",
            n_permutations=CBPA_PERMUTATIONS, tail=0, data_root=work,
            psd_time_window_sec=PSD_WINDOW_SEC, output_dir=out_dir / "cbpa",
            hypothesis_label="cbpa_psd_happy_vs_silence", save_plots=False,
            device=device)]
        clock.wrap(TCB, "cluster_permutation_1samp_test", "null")
        clock.wrap(TCB, "build_contrast_array", "contrast")
        t0 = tick()
        results, _ = TCB.run_batch(cfgs)
        stages["s5_cbpa_sec"] = tick() - t0
        clock.restore()
        detail["s5_cbpa"] = [
            {"label": c.hypothesis_label, "shape": list(r["t_obs"].shape),
             "nodes": int(r["t_obs"].size), "tail": c.tail,
             "contrast_sec": clock.sec["contrast"][i],
             "null_sec": clock.sec["null"][i],
             "clusters": len(r["clusters"]),
             "min_p": float(np.min(r["cluster_pv"]))
             if len(r["cluster_pv"]) else 1.0}
            for i, (c, r) in enumerate(zip(cfgs, results))]
        res = results[0]
        gates["g4_cbpa_sig_clusters"] = int(len(res["good_cluster_inds"]))
        gates["g4_cbpa_min_p"] = detail["s5_cbpa"][0]["min_p"]
        _require(len(res["good_cluster_inds"]) >= 1,
                 f"G4: no cluster at p < 0.05 ({res['cluster_pv']})")
        for r in results:
            _require(len(r["H0"]) == CBPA_PERMUTATIONS + 1
                     and bool(np.isfinite(r["H0"]).all()),
                     f"CBPA H0 {np.shape(r['H0'])}")

        # s5: LOSO influence and the power grid (:722-735)
        t0 = tick()
        TStat.run_influence_analysis(
            [("CMC_Flexor_max_beta", 1, 1),
             ("CMC_Extensor_max_beta", 1, 1)],
            combined, feat_root, out_dir, TA.fetch_level_definitions)
        stages["s5_loso_sec"] = tick() - t0
        diag: dict = {}
        t0 = tick()
        power = TStat.run_power_analysis(
            [TStat.PowerConfig(dependent_var="CMC_Flexor_max_beta",
                               comp_lvl=1, n_segments=1,
                               target_parameters=[],
                               n_simulations=POWER_SIMULATIONS)],
            combined, feat_root, out_dir, TA.fetch_level_definitions,
            device=device, diagnostics=diag)
        stages["s5_power_sec"] = tick() - t0
        detail["s5_power"] = {k: v for k, v in diag.items()
                              if isinstance(v, (int, float))}
        _require(power is not None and len(power) > 0,
                 "s5: the power analysis returned nothing")

        # s5: the Markdown report on the phase's results (:736-740)
        t0 = tick()
        report = TRW.build_report(
            out_dir, out_dir, work / "reports", "pipeline",
            level_definitions=TA.fetch_level_definitions(False),
            fdr_levels_to_correct=[2, 3],
            surrogate_null_metadata=null_metadata)
        stages["s5_report_sec"] = tick() - t0
        detail["s5_report"] = check_report(report, combined)

        # the time-alignment validation on subject 0
        detail["alignment"] = run_alignment(paths, plan, fs, device)
    finally:
        clock.restore()
        shutil.rmtree(work, ignore_errors=True)
    stages["pipeline_sec"] = sum(v for k, v in stages.items()
                                 if k[:2] in ("s1", "s2", "s3", "s4", "s5"))
    return {"stages": stages, "gates": gates, "detail": detail}


def report_null_metadata(device) -> list:
    """The metadata of one small ``cohort_msc_null`` call on the card, for
    the report's methods section: the rotation engine (the default CUDA
    budget's choice at REPORT_NULL_SURROGATES) with its sensitivity note."""
    ce, cm = make_cohort(2, 12.0, 8, 8)
    res = TN.cohort_msc_null(ce, cm, FS, n_surrogates=REPORT_NULL_SURROGATES,
                             device=device, nw=NW, window_length_sec=WINDOW_SEC,
                             overlap_frac=OVERLAP, band=BAND,
                             surrogate_chunk=SURROGATE_CHUNK)
    choice = res["metadata"]["engine_choice"]
    _require(choice["method_run"] == "rotation"
             and choice["fft_flop_budget"] == TN.FFT_FLOP_BUDGET["cuda"]
             and res["metadata"]["sensitivity_note"] == TN.SENSITIVITY_NOTE,
             f"report null: engine choice {choice}")
    _require(bool(np.isfinite(res["max_stat"]).all()),
             "report null: bad max_stat")
    return [dict(res["metadata"], label="cohort null 2 × 12 s × 8×8")]


def check_report(path, combined) -> dict:
    """The report exists, holds one section per (Hypothesis, DV) pair of
    the omnibus frame and the null-engine methods note, and its frame
    warnings name only REPORT_EMPTY_FRAMES."""
    _require(path.exists(), f"s5: no report at {path}")
    lines = path.read_text(encoding="utf-8").splitlines()
    sections = [(lines[i][3:], lines[i + 1])
                for i in range(len(lines) - 1)
                if lines[i].startswith("## ")
                and lines[i + 1].startswith("**Dependent variable:** ")]
    pairs = combined[["Hypothesis", "Dependent_Variable"]].drop_duplicates()
    want = sorted((h, f"**Dependent variable:** `{dv}`")
                  for h, dv in pairs.itertuples(index=False))
    _require(sorted(sections) == want,
             f"s5 report: {len(sections)} sections for {len(want)} pairs")
    warned = sorted(re.findall(r"^- `(\w+)` ", "\n".join(lines), re.M))
    _require(set(warned) <= set(REPORT_EMPTY_FRAMES),
             f"s5 report: frame warnings {warned}")
    _require("## Surrogate-Null Engine (Methods)" in lines
             and f"> {TN.SENSITIVITY_NOTE}" in lines,
             "s5 report: no null-engine section")
    return {"sections": len(sections), "lines": len(lines),
            "bytes": path.stat().st_size, "frame_warnings": warned}


def _require_alignment_close(what, got, ref) -> dict:
    """Card against CPU: floats within ALIGN_RTOL, the rest equal."""
    errs = {}
    for key, value in ref.items():
        if isinstance(value, float) and np.isfinite(value):
            errs[key] = abs(got[key] - value) / max(abs(value), 1e-12)
            _require(errs[key] <= ALIGN_RTOL,
                     f"{what} {key}: card {got[key]} vs cpu {value}")
        else:
            _require(got[key] == value or (value != value and
                                           got[key] != got[key]),
                     f"{what} {key}: card {got[key]!r} vs cpu {value!r}")
    return errs


def run_alignment(paths, plan, fs, device) -> dict:
    """The time-alignment validation workflow on subject 0 of the
    pipeline's tree: the EMG band power and force from s3's artifacts,
    the flexor/extensor power ratio of the preprocessed grids on the card
    (and of their first ALIGN_HEAD_SEC on the card and on the CPU, held to
    ALIGN_RTOL), the envelope-force identity check on both (held to
    ALIGN_RTOL), the alignment of each music trial, the sampling-rate
    sweep.  Seconds per call, host clock closed by a synchronise."""
    import pandas as pd
    from mba_tpu_torch.utils import file_management as filemgmt
    from mba_tpu_torch.workflows import \
        time_alignment_validation_workflow as TT

    sec, out = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        sec[name] = time.perf_counter() - t0
        return res

    load = timed("load_emg_psd_both_muscles",
                 lambda: TT.load_emg_psd_both_muscles(
                     0, paths.feature_data, paths.experiment_data))
    _require(load["flexor"] is not None and load["extensor"] is not None,
             "alignment: no EMG PSD artifacts of s3")
    power, times = load["flexor"]
    force = load["force_series"]
    feat0 = paths.subject_feature_dir(0)
    grids = [np.load(filemgmt.most_recent_file(
        feat0, ".npy", ["Preprocessed", key]), mmap_mode="r")
        for key in ("emg_1_flexor", "emg_2_extensor")]
    out["power_ratio"] = timed("emg_power_ratio", lambda: TT.emg_power_ratio(
        *grids, fs, device=device))
    head = [g[:int(ALIGN_HEAD_SEC * fs)] for g in grids]
    ratio = {dev: timed(f"emg_power_ratio_head_{dev}",
                        lambda dev=dev: TT.emg_power_ratio(
                            *head, fs, device=dev))
             for dev in (device, "cpu")}
    out["power_ratio_head_rel_err"] = _require_alignment_close(
        "emg_power_ratio", {"r": ratio[device]}, {"r": ratio["cpu"]})["r"]
    fs_emg = 1e9 / float(np.median(np.diff(times.asi8)))
    fs_force = 1e9 / float(np.median(np.diff(force.index.asi8)))
    n = int(len(power) * fs_force / fs_emg)
    ident = {dev: timed(f"validate_muscle_identity_{dev}",
                        lambda dev=dev: TT.validate_muscle_identity(
                            power, force.to_numpy(float)[:n], fs_emg,
                            fs_force, device=dev))
             for dev in (device, "cpu")}
    out["identity"] = ident[device]
    out["identity_rel_err"] = _require_alignment_close(
        "validate_muscle_identity", ident[device], ident["cpu"])
    start = times[0] - pd.Timedelta(seconds=PSD_WINDOW_SEC / 2)
    tasks = timed("analyze_task_alignment", lambda: [
        TT.analyze_task_alignment(
            power, times, force, start + pd.Timedelta(seconds=t_s),
            start + pd.Timedelta(seconds=t_e), f"music_{i}")
        for i, (t_s, t_e) in enumerate(plan.signal_relative_spans("music"))])
    _require(all(t["error"] is None for t in tasks),
             f"alignment: {[t['error'] for t in tasks if t['error']]}")
    out["tasks"] = len(tasks)
    out["median_match_rate"] = float(np.median([t["match_rate"]
                                                for t in tasks]))
    sweep = timed("cohort_sampling_rate_sweep",
                  lambda: TT.cohort_sampling_rate_sweep(
                      range(PIPE_SUBJECTS), paths.experiment_data,
                      paths.feature_data, nominal_fs=fs))
    _require(0 in set(sweep["Subject ID"]), "alignment: sweep lacks subject 0")
    out["sweep_subjects"] = len(sweep)
    out["drift_ppm_subject0"] = float(sweep["drift_ppm"].iloc[0])
    out["sec"] = sec
    return out


def write_click_track(path) -> None:
    """MUSIC_SECONDS of 16-bit mono PCM at MUSIC_SR (module constants):
    a 30-ms 1-kHz click on each beat at MUSIC_BPM and a softer 1.5-kHz
    one MUSIC_SYNCOPATION into it, over faint noise."""
    import wave
    rng = np.random.default_rng(7)
    y = 0.002 * rng.standard_normal(int(MUSIC_SR * MUSIC_SECONDS))
    period = 60.0 / MUSIC_BPM
    dur = int(0.03 * MUSIC_SR)
    t = np.arange(dur) / MUSIC_SR
    on = np.hanning(dur) * np.sin(2 * np.pi * 1000.0 * t)
    off = 0.6 * np.hanning(dur) * np.sin(2 * np.pi * 1500.0 * t)
    for beat in np.arange(0.1, MUSIC_SECONDS - 0.5, period):
        i = int(beat * MUSIC_SR)
        j = int((beat + MUSIC_SYNCOPATION * period) * MUSIC_SR)
        y[i:i + dur] += on
        y[j:j + dur] += off
    pcm = (np.clip(y, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(MUSIC_SR)
        w.writeframes(pcm.tobytes())


def run_music(device) -> dict:
    """The music features of a synthetic click track on the card against
    the CPU (module docstring, phase 11).  The STFT is timed warm on the
    host clock (upload, framing, rFFT and download), median of 3."""
    import shutil
    from mba_tpu_torch.pipeline import music_control as TM

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_music_"))
    try:
        path = work / "click_track.wav"
        write_click_track(path)
        y, sr = TM.load_audio_file(path, duration=None)
        spec = {}
        stft_sec = {}
        for dev in (device, "cpu"):
            TM.compute_stft(y, device=dev)
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                spec[dev] = TM.compute_stft(y, device=dev)
                runs.append(time.perf_counter() - t0)
            stft_sec[str(dev)] = float(np.median(runs))
        S, ref = spec[device], spec["cpu"]
        err = float(np.abs(S - ref).max())
        bound = STFT_ATOL * float(ref.max()) + STFT_RTOL * np.abs(ref)
        _require(S.shape == ref.shape and bool((np.abs(S - ref)
                                                <= bound).all()),
                 f"music: STFT card vs cpu, max abs err {err}")
        feats, feat_sec = {}, {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            feats[dev] = (TM.compute_all_musical_features(path, device=dev),
                          TM.compute_onset_times(y, sr, device=dev))
            feat_sec[str(dev)] = time.perf_counter() - t0
        (bpm, flux, centroid, ioi_cv, sync_deg, sync_ratio), onsets = \
            feats[device]
        (bpm_cpu, *rest_cpu), onsets_cpu = feats["cpu"]
        _require(bpm == bpm_cpu and len(onsets) == len(onsets_cpu),
                 f"music: card BPM {bpm}, {len(onsets)} onsets; cpu "
                 f"{bpm_cpu}, {len(onsets_cpu)}")
        _require(abs(bpm - MUSIC_BPM) <= MUSIC_BPM_TOL,
                 f"music: BPM {bpm}, planted {MUSIC_BPM}")
        return {"samples": len(y), "sr": sr, "stft_shape": list(S.shape),
                "stft_sec": stft_sec, "stft_max_abs_err": err,
                "stft_max": float(ref.max()),
                "features_sec": feat_sec, "bpm": bpm,
                "onsets": len(onsets),
                "onset_times_equal": bool(np.array_equal(onsets,
                                                         onsets_cpu)),
                "ioi_cv": ioi_cv, "syncopation_degree": sync_deg,
                "syncopation_ratio": sync_ratio,
                "cpu_equal": {"ioi_cv": ioi_cv == rest_cpu[2],
                              "syncopation": (sync_deg, sync_ratio)
                              == tuple(rest_cpu[3:])},
                "flux_max_abs_err": float(np.abs(flux - rest_cpu[0]).max()),
                "centroid_max_rel_err": float(
                    (np.abs(centroid - rest_cpu[1])
                     / np.maximum(np.abs(rest_cpu[1]), 1e-12)).max())}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _timed(fn, *args, **kw):
    """(result, seconds, launches during the call) on the host clock,
    the card synchronized on both sides."""
    torch.cuda.synchronize()
    before = launches()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    after = launches()
    return out, sec, {k: after[k] - before[k] for k in after}


def mesh_calls(mesh, cohort, n_surrogates, phase_pair=None) -> dict:
    """The mesh paths on ``mesh`` with the main path's settings: the
    cohort CMC (jackknife, EMG max-pool), the rotation null with
    ``coeff_engine='pallas'``, the time-sharded CMC of subject 0 and, if
    given, the phase null of ``phase_pair`` (config 4's chunking).
    Returns each result with its seconds and launches."""
    from mba_tpu_torch.parallel import (cohort_multitaper_msc,
                                        time_sharded_msc)
    eeg, emg = cohort
    cmc_kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
                  use_jackknife=True, aggregate_emg_max=True)
    calls = {}
    calls["cohort_cmc"] = _timed(cohort_multitaper_msc, mesh, eeg, emg, FS,
                                 **cmc_kw)
    calls["rotation_null"] = _timed(
        TN.cohort_msc_rotation_null, eeg, emg, FS, mesh=mesh,
        coeff_engine="pallas", n_surrogates=n_surrogates, nw=NW,
        window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP, band=BAND,
        surrogate_chunk=SURROGATE_CHUNK)
    calls["time_sharded_cmc"] = _timed(time_sharded_msc, mesh, eeg[0], emg[0],
                                       FS, **cmc_kw)
    if phase_pair is not None:
        calls["phase_null"] = _timed(
            TSu.msc_phase_randomized_null, *phase_pair, FS, mesh=mesh,
            n_surrogates=PHASE_SURROGATES, window_length_sec=WINDOW_SEC,
            surrogate_chunk=PHASE_CHUNK)
    return calls


def _mesh_summary(calls) -> dict:
    out = {}
    for name, (res, sec, n) in calls.items():
        out[name] = {"sec": sec, "launches": n}
        if "p_fwe" in res:
            out[name]["p_fwe"] = res["p_fwe"]
            t = res.get("metadata", res).get("timings", {})
            out[name].update({k: t[k] for k in ("precompute_sec",
                                                "null_sec", "coeffs_sec",
                                                "upload_sec") if k in t})
    return out


def run_mesh_world1(cohort, observed_pallas, phase_observed) -> dict:
    """(a): one NCCL rank on the card, the main path's cohort at full
    width (module docstring, phase 12)."""
    import datetime as _dt
    import torch.distributed as dist
    from mba_tpu_torch.parallel import make_mesh

    import shutil

    store_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1,
            timeout=_dt.timedelta(seconds=MESH_PG_TIMEOUT_SEC))
        try:
            mesh = make_mesh()
            _require(tuple(mesh.mesh.shape) == (1, 1),
                     f"world-1 mesh {tuple(mesh.mesh.shape)}")
            reset_launches()
            calls = mesh_calls(mesh, cohort, N_SURROGATES, config4_pair())
            counts = launches()
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    for k in ("msc_jackknife", "null_tile", "coeff_pairs", "threefry"):
        _require(counts[k] > 0, f"the world-1 mesh path did not launch "
                 f"{k}: {counts}")
    cmc, rot, ts, ph = (calls[k][0] for k in (
        "cohort_cmc", "rotation_null", "time_sharded_cmc", "phase_null"))
    kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
              use_jackknife=True, aggregate_emg_max=True,
              apply_independence_threshold=False, device="cuda")
    err = {"cohort_cmc": 0.0, "time_sharded_cmc": 0.0}
    for j in range(cohort[0].shape[0]):
        ref = TC.multitaper_msc(cohort[0][j], cohort[1][j], FS, **kw)
        for key in ("coherence_raw", "coherence_ci_lower",
                    "coherence_ci_upper"):
            d = float(np.abs(cmc[key][j] - ref[key]).max())
            err["cohort_cmc"] = max(err["cohort_cmc"], d)
            if j == 0:
                err["time_sharded_cmc"] = max(
                    err["time_sharded_cmc"],
                    float(np.abs(ts[key] - ref[key]).max()))
    for name, e in err.items():
        _require(e <= MSC_ATOL, f"mesh {name} against multitaper_msc: {e}")
    _require_close_observed(rot["observed"], observed_pallas,
                            "mesh rotation null observed vs unsharded")
    _require(rot["p_fwe"] < 0.01, f"mesh rotation null p_fwe "
             f"{rot['p_fwe']}: the planted coupling was not detected")
    _require(rot["max_stat"].shape == (N_SURROGATES,), "mesh null shape")
    _require(bool(np.array_equal(ph["observed"], phase_observed)),
             "mesh phase null observed differs from the unsharded one")
    _require(ph["p_fwe"] >= 0.01, f"mesh phase null (config 4, uncoupled) "
             f"p_fwe {ph['p_fwe']} < 0.01")
    return {"calls": _mesh_summary(calls), "launches": counts,
            "max_abs_err": err,
            "rotation_observed_max_abs_err": float(
                np.abs(rot["observed"] - observed_pallas).max())}


def _small_mesh_results(mesh) -> dict:
    """The four mesh calls at MESH_SMALL on ``mesh``'s device."""
    from mba_tpu_torch.parallel import (cohort_multitaper_msc,
                                        time_sharded_msc)
    J, sec, ch = MESH_SMALL
    eeg, emg = make_cohort(J, sec, ch, ch, seed=21)
    cmc_kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
                  use_jackknife=True)
    return {
        "cohort_cmc": cohort_multitaper_msc(mesh, eeg, emg, FS, **cmc_kw),
        "time_sharded_cmc": time_sharded_msc(mesh, eeg[0], emg[0], FS,
                                             **cmc_kw),
        "rotation_null": TN.cohort_msc_rotation_null(
            eeg, emg, FS, mesh=mesh, coeff_engine="pallas",
            n_surrogates=MESH_SMALL_SURROGATES, nw=NW,
            window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP, band=BAND,
            surrogate_chunk=MESH_SMALL_CHUNK),
        "phase_null": TSu.msc_phase_randomized_null(
            eeg[0][:, :1], emg[0][:, :1], FS, mesh=mesh,
            n_surrogates=MESH_SMALL_SURROGATES, window_length_sec=WINDOW_SEC,
            surrogate_chunk=MESH_SMALL_CHUNK),
    }


def cpu_info() -> dict:
    """What sets this process's CPU rounding: its thread count, the
    cores, the CPU and the instruction set torch and MKL dispatch to."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), None)
    except OSError:
        pass
    lines = torch.__config__.parallel_info().splitlines()
    return {"threads": torch.get_num_threads(), "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "parallel_info": " ".join(x.strip() for x in lines[:2]),
            "cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "model": model, "mkl_cbwr": os.environ.get("MKL_CBWR")}


def _mesh_rank(rank: int, n_ranks: int, work: str) -> None:
    """One of (b)'s gloo ranks on the card (spawned).  Its host seconds
    go into ``step_sec``: from its start to a built mesh, the cohort's
    synthesis, the timed calls, and the small calls on the card and on
    the CPU, the latter at MESH_CPU_THREADS CPU threads."""
    import datetime as _dt
    import pickle
    import torch.distributed as dist
    from mba_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    step = {}

    def lap(name):
        nonlocal t0
        step[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    torch.set_num_threads(MESH_CPU_THREADS)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), n_ranks),
        rank=rank, world_size=n_ranks,
        timeout=_dt.timedelta(seconds=MESH_PG_TIMEOUT_SEC))
    try:
        _build.load_library()
        mesh = make_mesh()
        cpu_mesh = make_mesh(device_type="cpu")
        lap("start_to_mesh")
        out = {"device": f"cuda:{torch.cuda.current_device()}",
               "cpu_info": cpu_info()}
        cohort = make_cohort(MESH_SUBJECTS, MESH_SECONDS, N_EEG, N_EMG)
        lap("cohort")
        calls = mesh_calls(mesh, cohort, MESH_SURROGATES)
        lap("timed_calls")
        out["calls"] = _mesh_summary(calls)
        out["rotation_max_stat"] = calls["rotation_null"][0]["max_stat"]
        out["card"] = _small_mesh_results(mesh)
        torch.cuda.synchronize()
        lap("small_card")
        out["cpu"] = _small_mesh_results(cpu_mesh)
        lap("small_cpu")
        out["step_sec"] = step
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def small_mesh_close(card, cpu, what) -> dict:
    """(b)'s card results against the CPU ranks' (docstring, phase 12);
    raises on the first disagreement, else returns the largest errors."""
    errs = {}
    eeg, emg = make_cohort(*MESH_SMALL[:2], MESH_SMALL[2], MESH_SMALL[2],
                           seed=21)
    ws = int(WINDOW_SEC * FS)
    starts, _ = window_grid(eeg.shape[1], ws, int(ws * (1 - OVERLAP)), FS)
    tap = torch.as_tensor(filtered_tapers(ws, NW, 0.9), dtype=torch.float32)
    for name, subjects in (("cohort_cmc", range(eeg.shape[0])),
                           ("time_sharded_cmc", [0])):
        g, r = card[name], cpu[name]
        for j in subjects:
            e, m = (TC.tapered_rfft(frame_signal(torch.from_numpy(x[j]),
                                                 starts, ws), tap)
                    for x in (eeg, emg))
            tol = cuda_msc.ci_tolerance(
                cuda_msc.loo_coherence_max(e, m).numpy(), MSC_ATOL)
            for key in ("coherence_raw", "coherence_ci_lower",
                        "coherence_ci_upper"):
                gj = g[key][j] if name == "cohort_cmc" else g[key]
                rj = r[key][j] if name == "cohort_cmc" else r[key]
                d = np.abs(gj - rj)
                bound = MSC_ATOL if key == "coherence_raw" else tol
                errs[f"{name}:{key}"] = max(errs.get(f"{name}:{key}", 0.0),
                                            float(d.max()))
                _require(bool((d <= bound).all()),
                         f"{what} {name} {key}: card vs cpu {float(d.max())}")
    rot_g, rot_c = card["rotation_null"], cpu["rotation_null"]
    _require_close_observed(rot_g["observed"], rot_c["observed"],
                            f"{what} rotation null observed")
    _require_close_observed(rot_g["max_stat"], rot_c["max_stat"],
                            f"{what} rotation null max_stat")
    _require(rot_g["p_fwe"] == rot_c["p_fwe"],
             f"{what} rotation null p_fwe {rot_g['p_fwe']} vs "
             f"{rot_c['p_fwe']}")
    ph_g, ph_c = card["phase_null"], cpu["phase_null"]
    _require_close(f"{what} phase null max_stat", ph_g["max_stat"],
                   ph_c["max_stat"], PHASE_MAX_RTOL, PHASE_MAX_ATOL)
    _require(ph_g["p_fwe"] == ph_c["p_fwe"],
             f"{what} phase null p_fwe {ph_g['p_fwe']} vs {ph_c['p_fwe']}")
    errs["rotation_max_stat"] = float(np.abs(rot_g["max_stat"]
                                             - rot_c["max_stat"]).max())
    errs["phase_max_stat"] = float(np.abs(ph_g["max_stat"]
                                          - ph_c["max_stat"]).max())
    return errs


def small_mesh_arrays(ranks) -> dict:
    """Every array and number of the ranks' small results, flat:
    ``rank{r}/{card|cpu}/{call}/{key}``."""
    flat = {}
    for r, res in enumerate(ranks):
        for side in ("card", "cpu"):
            for call, d in res[side].items():
                for key, v in d.items():
                    if isinstance(v, (np.ndarray, float, int, np.generic)):
                        flat[f"rank{r}/{side}/{call}/{key}"] = np.asarray(v)
    return flat


def _require_small_mesh_close(ranks, what) -> dict:
    """:func:`small_mesh_close` on rank 0's results; on a failure both
    ranks' card and CPU arrays go into an ``.npz`` under
    ``chip_smoke_out/`` of this checkout, which the error names."""
    try:
        return small_mesh_close(ranks[0]["card"], ranks[0]["cpu"], what)
    except AssertionError as exc:
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        out_dir = REPO / "chip_smoke_out" / f"mesh_small_failure_{stamp}"
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savez(out_dir / "ranks.npz", **small_mesh_arrays(ranks))
        (out_dir / "cpu_info.json").write_text(json.dumps(
            [res["cpu_info"] for res in ranks]))
        raise AssertionError(f"{exc} (both ranks' card and cpu arrays: "
                             f"{out_dir / 'ranks.npz'})") from None


def spawn_mesh_ranks(fn=_mesh_rank, args=(), env: dict | None = None):
    """MESH_RANKS gloo ranks spawned on the one card, each running
    ``fn(rank, MESH_RANKS, work, *args)`` with ``env`` (by default
    MESH_RANK_ENV) added to its environment and pickling its results to
    ``work/rank{rank}.pkl``: (seconds from spawn to join, each rank's
    results).  Any rank's failure, or a join past MESH_JOIN_SEC, raises;
    no rank outlives the call."""
    import pickle
    import torch.multiprocessing as mp

    env = MESH_RANK_ENV if env is None else env
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh2_")
    saved = {k: os.environ.get(k) for k in env}
    try:
        t0 = time.perf_counter()
        os.environ.update(env)
        try:
            ctx = mp.start_processes(
                fn, args=(MESH_RANKS, work, *args),
                nprocs=MESH_RANKS, join=False, start_method="spawn")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        try:
            while not ctx.join(timeout=5.0):
                _require(time.perf_counter() - t0 < MESH_JOIN_SEC,
                         f"mesh ranks did not finish in {MESH_JOIN_SEC} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=10)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return wall, ranks


def run_mesh_two_ranks() -> dict:
    """(b): MESH_RANKS gloo ranks spawned on the one card (docstring,
    phase 12), their CPU reference at MESH_CPU_THREADS threads each and
    MESH_RANK_ENV."""
    wall, ranks = spawn_mesh_ranks()
    log(json.dumps({"check": "mesh 2 ranks: CPU reference",
                    "cpu_info": [res["cpu_info"] for res in ranks]}))
    for r, res in enumerate(ranks):
        _require(res["device"] == "cuda:0", f"rank {r} ran on "
                 f"{res['device']}")
        n = {k: sum(c["launches"][k] for c in res["calls"].values())
             for k in ("msc_jackknife", "null_tile", "coeff_pairs",
                       "threefry")}
        _require(all(v > 0 for v in n.values()),
                 f"rank {r} did not launch every kernel: {n}")
        _require(bool(np.array_equal(res["rotation_max_stat"],
                                     ranks[0]["rotation_max_stat"])),
                 f"rank {r}'s rotation null differs from rank 0's")
        _require(res["calls"]["rotation_null"]["p_fwe"] < 0.01,
                 f"rank {r}: 2-rank rotation null p_fwe "
                 f"{res['calls']['rotation_null']['p_fwe']}")
    errs = _require_small_mesh_close(ranks, "2 ranks small")
    launches_sum = {k: sum(c["launches"][k] for res in ranks
                           for c in res["calls"].values())
                    for k in ranks[0]["calls"]["cohort_cmc"]["launches"]}
    return {"wall_sec": wall, "ranks": [res["calls"] for res in ranks],
            "step_sec": [res["step_sec"] for res in ranks],
            "cpu_info": [res["cpu_info"] for res in ranks],
            "launches": launches_sum, "small_card_vs_cpu_max_abs_err": errs}


# ---- the options phase ---------------------------------------------------

def _half_steps(ref: np.ndarray) -> np.ndarray:
    """Half an int8 step of each lane ``multitaper_msc`` quantizes
    ``ref`` (W, F, E) in: per (freq, EEG) where the sidecars stay under a
    tenth of the payload (0.1·W ≥ 8, as at the main path's 119 windows),
    else per EEG channel; a step is the lane's span over 255."""
    axes = (0,) if 8.0 <= 0.1 * len(ref) else (0, 1)
    return 0.5 * (ref.max(axis=axes) - ref.min(axis=axes)) / 255.0


def run_cmc_transfers(eeg, emg, device) -> dict:
    """The CMC leg at bench.py:146-149's settings (int8 download, int16
    upload) beside the float32 leg and an int16-upload leg with a
    float32 download, on the same signals: the bytes each way; the
    download's quantization alone, the int8 leg within half a step
    (+ 1e-6 of float32 rounding) of the int16-upload leg's own values in
    every cell of the coherence and both CIs; the upload's, the int16-
    upload leg's coherence within OPT_CMC_SLACK of the float32 leg's in
    every cell; both, the int8 leg within half a step of the float32
    leg's per-lane spans plus OPT_CMC_SLACK, the coherence in every cell
    and the CIs in all but OPT_CI_MOVED of them; the peak in the planted
    band; upload, compute and download seconds."""
    kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
              use_jackknife=True, aggregate_emg_max=True,
              apply_independence_threshold=False, collect_timings=True)
    f32 = TC.multitaper_msc(eeg, emg, FS, device=device, **kw)
    up16 = TC.multitaper_msc(eeg, emg, FS, device=device,
                             input_transfer="int16", **kw)
    t0 = time.perf_counter()
    q = TC.multitaper_msc(eeg, emg, FS, device=device, transfer_dtype=np.int8,
                          input_transfer="int16", **kw)
    wall = time.perf_counter() - t0
    tf, tq = f32["timings"], q["timings"]
    _require(tq["download_bytes"] <= OPT_DOWNLOAD_SHARE
             * tf["download_bytes"], f"int8 CMC downloads "
             f"{tq['download_bytes']} of the float32 leg's "
             f"{tf['download_bytes']} bytes")
    _require(2 * tq["upload_bytes"] == tf["upload_bytes"],
             f"int16 CMC uploads {tq['upload_bytes']} of the float32 leg's "
             f"{tf['upload_bytes']} bytes")
    errs, excess, moved, dl_excess, upload_err = {}, {}, {}, {}, {}
    for key in ("coherence_raw", "coherence_ci_lower", "coherence_ci_upper"):
        ref, got = f32[key], q[key]
        _require(got.shape == ref.shape and bool(np.isfinite(got).all()),
                 f"int8 CMC {key}: {got.shape}, non-finite values")
        dl_excess[key] = float((np.abs(got - up16[key])
                                / (_half_steps(up16[key]) + 1e-6)).max())
        upload_err[key] = float(np.abs(up16[key] - ref).max())
        d = np.abs(got - ref)
        over = d > _half_steps(ref) + OPT_CMC_SLACK
        errs[key] = float(d.max())
        moved[key] = float(over.mean())
        excess[key] = float((d / (_half_steps(ref) + OPT_CMC_SLACK)).max())
    log(json.dumps({"check": "cmc int8 download, int16 upload",
                    "download_over_half_step_of_own_values": dl_excess,
                    "int16_upload_max_abs_err": upload_err,
                    "max_abs_err": errs, "max_err_over_bound": excess,
                    "cells_over_bound": moved}))
    _require(max(dl_excess.values()) <= 1.0,
             f"int8 CMC: the download off its own float32 values by more "
             f"than half a step: {dl_excess}")
    _require(upload_err["coherence_raw"] <= OPT_CMC_SLACK,
             f"int16-upload CMC off the float32 leg's coherence by "
             f"{upload_err['coherence_raw']}")
    _require(excess["coherence_raw"] <= 1.0,
             f"int8 CMC coherence off the float32 leg by more than half a "
             f"step: {excess}")
    _require(max(moved.values()) <= OPT_CI_MOVED,
             f"int8 CMC CIs off the float32 leg in {moved} of the cells")
    spectrum = q["coherence_raw"].mean(axis=(0, 2))
    f_peak = float(q["freqs"][int(np.argmax(spectrum[1:])) + 1])
    _require(15.0 <= f_peak <= 30.0, f"int8 CMC peaks at {f_peak} Hz")
    return {"wall_sec": wall, "peak_hz": f_peak, "timings_int8": tq,
            "timings_float32": tf,
            "download_share": tq["download_bytes"] / tf["download_bytes"],
            "upload_share": tq["upload_bytes"] / tf["upload_bytes"],
            "max_abs_err": errs, "max_err_over_half_step": excess,
            "cells_over_half_step": moved}


def check_null_kernel_16bit(device, dtype, reps=10) -> dict:
    """B2's 16-bit instance (``dtype`` bfloat16 or float16: the tensor
    cores) against its plain version (``bmm`` of the rounded operands,
    widened to float32) on one 500-surrogate chunk at the main path's
    shapes: maxima within rtol NULL_TOL, counts equal but in cells whose
    statistic lies within NULL_TOL of the observed one (the float32 sums
    run in another order), none above S.  Its bound: the tensor cores'
    989 TFLOP/s against the bytes at 3.35 TB/s; library_ms is
    ``torch.bmm`` of the 16-bit operands (the product alone, 16-bit
    out)."""
    name = str(dtype).removeprefix("torch.").replace("float16", "f16") \
        .replace("bfloat16", "bf16")
    state, key, K = null_check_state(device, dtype=dtype, seed=1)
    J, S = state.n_subjects, SURROGATE_CHUNK
    nF, JP, N = *state.coefT.shape[:2], state.base_flat.shape[1]
    key, sub = prng.split(key)
    G = cuda_null.null_features(TN.phase_features(
        TN.draw_phases(sub, J, S, K, nF, device)), dtype)
    args = (G, state.coefT, state.base_flat, state.observed_flat, J, S)
    ms, cnt = cuda_null.null_tile(*args)
    ms_p, cnt_p = cuda_null.null_tile_plain(*args)
    _require(bool(torch.isfinite(ms).all()),
             f"B2 {name}: non-finite max_stat")
    err = float((ms - ms_p).abs().max())
    _require(bool(((ms - ms_p).abs() <= NULL_TOL * ms_p.abs()).all()),
             f"B2 {name} max_stat disagrees: {err}")
    rows = G[..., :S].transpose(1, 2).float()
    stat = state.base_flat[:, None] + torch.bmm(
        rows, state.coefT[..., :N].float()) / J
    ties = ((stat - state.observed_flat[:, None]).abs() <= NULL_TOL).any(1)
    del stat, rows
    differ = cnt != cnt_p
    n_off = int((differ & ~ties).sum())
    log(json.dumps({"check": f"null_tile {name}", "shape": [nF, S, JP, N],
                    "max_stat_abs_err": err,
                    "count_cells_differ": float(differ.float().mean()),
                    "count_cells_differ_off_ties": n_off,
                    "tie_cells": float(ties.float().mean())}))
    _require(n_off == 0, f"B2 {name} counts differ in {n_off} cells whose "
             "statistic is not within 1e-5 of the observed one")
    _require(int(cnt.max()) <= S, f"B2 {name} counted more than S")
    out = {"max_abs_err": err,
           "ms": cuda_ms(lambda: cuda_null.null_tile(*args), reps),
           "plain_ms": cuda_ms(lambda: cuda_null.null_tile_plain(*args),
                               reps)}
    nbytes = 2 * (G.numel() + state.coefT.numel()) + 4 * (3 * nF * N + S)
    out.update(roofline(out["ms"], 2.0 * nF * S * JP * N, nbytes,
                        PEAK_BF16_FLOPS))
    a = G[..., :S].transpose(1, 2).contiguous()
    out["library_ms"] = cuda_ms(lambda: torch.bmm(a, state.coefT), reps)
    out["shape"] = [nF, S, JP, N]
    out["peak"] = f"{name} tensor cores, 989 TFLOP/s dense"
    del a
    torch.cuda.empty_cache()
    return out


def check_msc_many_tapers(eeg, emg, device, nw, reps=5) -> dict:
    """B1 at ``nw``'s taper count: the full grid of the main path's first
    B1_CMP_WINDOWS windows against the plain version (coherence within
    MSC_ATOL, CIs within ``ci_tolerance``), the EMG-max mode bit for bit
    the full grid at its pick; then its time at the main path's chunk
    (``multitaper_msc``'s chunk for this K) and the bound."""
    e, m, t_crit = main_path_msc_chunk(eeg, emg, device, nw)
    ec, mc = (x[:B1_CMP_WINDOWS].contiguous() for x in (e, m))
    kf = _np(cuda_msc.msc_jackknife(ec, mc, t_crit, emg_max=False))
    km = _np(cuda_msc.msc_jackknife(ec, mc, t_crit, emg_max=True))
    pf = _np(cuda_msc.msc_jackknife_plain(ec, mc, t_crit, emg_max=False))
    tol = cuda_msc.ci_tolerance(
        cuda_msc.loo_coherence_max(ec, mc).cpu().numpy(), MSC_ATOL)
    errs, excess = {}, {}
    for key in ("coherence", "ci_lower", "ci_upper"):
        _require(bool(np.isfinite(kf[key]).all()),
                 f"B1 nw={nw} {key}: non-finite values")
        d = np.abs(kf[key] - pf[key])
        bound = MSC_ATOL if key == "coherence" else tol
        errs[key] = float(d.max())
        excess[key] = float((d / bound).max())
    _require(max(excess.values()) <= 1.0,
             f"B1 nw={nw} disagrees with its plain version: {excess}")
    first = np.argmax(kf["coherence"], axis=-1)[..., None]
    for key in ("coherence", "ci_lower", "ci_upper"):
        _require(np.array_equal(
            km[key], np.take_along_axis(kf[key], first, -1)[..., 0]),
            f"B1 nw={nw} EMG-max {key} is not the full grid's at its pick")
    del kf, km, pf, tol
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: cuda_msc.msc_jackknife(e, m, t_crit), reps)
    W, K, F, E = e.shape
    M = m.shape[-1]
    return {"K": K, "max_abs_err": max(errs.values()),
            "max_err_over_tolerance": excess,
            "compared_windows": B1_CMP_WINDOWS, "ms": ms,
            **roofline(ms, *msc_emg_max_work(W, K, F, E, M)),
            "shape": [W, K, F, E, M]}


def check_coeff_many_tapers(cohort, device, nw, reps=5) -> dict:
    """B3 at ``nw``'s taper count on the main path's first chunk against
    its plain version (COEFF_RTOL / COEFF_ATOL over the weight sum), then
    the accumulate form (the second chunk added into the first's sums by
    ``out=``) against the plain ``add_``; both forms' times there and
    their bounds (the accumulate form's with the old sums read)."""
    (e, m, w), second = coeff_chunks(cohort, device, nw)
    got = cuda_coeffs.coeff_pairs(e, m, w)
    ref = cuda_coeffs.coeff_pairs_plain(e, m, w)
    wsum = float(w.sum())
    errs, excess = _coeff_excess(got, ref, wsum, f"B3 nw={nw}")
    _require(max(excess.values()) <= 1.0,
             f"B3 nw={nw} disagrees with its plain version: {excess}")
    cuda_coeffs.coeff_pairs(*second, out=got)
    cuda_coeffs.coeff_pairs_plain(*second, out=ref)
    wsum2 = wsum + float(second[2].sum())
    errs2, excess2 = _coeff_excess(got, ref, wsum2, f"B3 nw={nw} accumulate")
    _require(max(excess2.values()) <= 1.0,
             f"B3 nw={nw} accumulate form disagrees: {excess2}")
    del ref
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: cuda_coeffs.coeff_pairs(e, m, w), reps)
    ms_acc = cuda_ms(lambda: cuda_coeffs.coeff_pairs(*second, out=got), reps)
    wc, K, nF, E = e.shape
    M = m.shape[-1]
    acc = roofline(ms_acc, *coeff_work(wc, K, nF, E, M, accumulate=True))
    out = {"K": K, "max_abs_err": max(errs.values()) * wsum,
           "max_err_over_tolerance": excess,
           "accumulate_max_err_over_tolerance": excess2, "ms": ms,
           **roofline(ms, *coeff_work(wc, K, nF, E, M)),
           "accumulate_ms": ms_acc, "accumulate_bound_ms": acc["bound_ms"],
           "accumulate_bound_by": acc["bound_by"],
           "accumulate_share_of_bound": acc["share_of_bound"],
           "shape": [wc, K, nF, E, M]}
    del got
    torch.cuda.empty_cache()
    return out


def check_msc_runtime_k_bitwise(eeg, emg, device, nw) -> dict:
    """B1's runtime-K path (``cuda_msc.msc_jackknife_runtime_k``) against
    the compile-time instance of ``nw``'s K (<= 16): both EMG modes on the
    main path's first B1_CMP_WINDOWS windows at 64×64 and at the task
    CMC's 11×64 (two lanes a cell in the EMG-max scan), bit for bit, NaN
    where NaN; then both paths' times at the main path's chunk."""
    out = {}
    for name, n_eeg in (("64x64", N_EEG), ("11x64",
                                            len(CMC_EEG_CHANNEL_SUBSET))):
        e, m, t_crit = main_path_msc_chunk(eeg[:, :n_eeg], emg, device, nw)
        ec, mc = (x[:B1_CMP_WINDOWS].contiguous() for x in (e, m))
        for emg_max in (True, False):
            a = cuda_msc.msc_jackknife(ec, mc, t_crit, emg_max=emg_max)
            b = cuda_msc.msc_jackknife_runtime_k(ec, mc, t_crit,
                                                 emg_max=emg_max)
            for key in a:
                _require(bool(torch.equal(a[key].isnan(), b[key].isnan())
                              and torch.equal(a[key].nan_to_num(),
                                              b[key].nan_to_num())),
                         f"B1 runtime-K path differs from the compile-time "
                         f"instance: K={e.shape[1]} {name} emg_max={emg_max} "
                         f"{key}")
        if name == "64x64":
            out = {"K": e.shape[1], "shape": list(e.shape),
                   "bitwise_equal": True,
                   "ms": cuda_ms(lambda: cuda_msc.msc_jackknife(e, m, t_crit),
                                 5),
                   "runtime_k_ms": cuda_ms(
                       lambda: cuda_msc.msc_jackknife_runtime_k(e, m, t_crit),
                       5)}
        del e, m, ec, mc
        torch.cuda.empty_cache()
    return out


def check_ica_reference(device) -> dict:
    """``batch_layout='reference'`` small, card against CPU: the epochs'
    permutations (threefry kernel and a stable sort on the card) equal
    the CPU's bit for bit, and ICA_REF_EPOCHS epochs on the same
    whitened data give the CPU's W within rtol 1e-4
    (tests/test_torch_ica.py)."""
    rng = np.random.default_rng(12)
    xw = rng.laplace(size=ICA_REF_SHAPE).astype(np.float32)
    n = (ICA_REF_SHAPE[0] // ICA_REF_BLOCK) * ICA_REF_BLOCK
    key = prng.prng_key(42)
    perms_equal = True
    for _ in range(ICA_REF_EPOCHS):
        key, sub = prng.split(key)
        card = cuda_prng.permutation(sub, n, device)
        _require(card.device.type == "cuda", "permutation left the card")
        perms_equal &= bool(torch.equal(card.cpu(),
                                        prng.permutation(sub, n)))
    _require(perms_equal, "reference-layout permutations differ card vs CPU")
    t0 = time.perf_counter()
    w_card, n_card = TI._extended_infomax(
        prng.prng_key(42), torch.from_numpy(xw).to(device),
        ICA_REF_SHAPE[1], ICA_REF_BLOCK, ICA_REF_EPOCHS, np.float32(0.003),
        batch_layout="reference")
    torch.cuda.synchronize()
    card_sec = time.perf_counter() - t0
    w_cpu, n_cpu = TI._extended_infomax(
        prng.prng_key(42), torch.from_numpy(xw), ICA_REF_SHAPE[1],
        ICA_REF_BLOCK, ICA_REF_EPOCHS, np.float32(0.003),
        batch_layout="reference")
    d = (w_card.cpu() - w_cpu).abs()
    bound = 1e-4 * w_cpu.abs() + 1e-6 * float(w_cpu.abs().max())
    _require(n_card == n_cpu == ICA_REF_EPOCHS and bool((d <= bound).all()),
             f"reference-layout W card vs CPU: {float(d.max())}")
    return {"samples": n, "block": ICA_REF_BLOCK, "epochs": n_card,
            "permutations_bitwise_equal": perms_equal,
            "w_max_abs_err": float(d.max()), "card_sec": card_sec}


def check_device_trace(eeg, emg, device) -> dict:
    """``utils.profiling`` on the card: one B1 launch on the main path's
    first chunk under ``device_trace`` and ``annotate``; the trace file
    must hold the annotation and B1's kernel as a device event."""
    e, m, t_crit = main_path_msc_chunk(eeg, emg, device)
    with tempfile.TemporaryDirectory() as d:
        with device_trace(d):
            with annotate("b1 chunk"):
                cuda_msc.msc_jackknife(e, m, t_crit)
        files = list(Path(d).glob("*.json"))
        _require(len(files) == 1, f"device_trace wrote {len(files)} files")
        events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"
               and "msc_jackknife_kernel" in ev.get("name", "")]
    _require(len(kernels) == 1 and any(ev.get("name") == "b1 chunk"
                                       for ev in events),
             "device_trace lacks B1's kernel or the annotation")
    return {"events": len(events), "b1_kernel_us": kernels[0].get("dur")}


def run_options(eeg, emg, cohort, observed_gram, device, card) -> dict:
    """The options phase: bench.py's own transfer settings, the null in
    bf16 and f16, B1 and B3 at more tapers and the reference-layout ICA, each
    section timed by ``utils.profiling.StageTimer``; every path's launch
    counts set to 0 just before it and read just after."""
    timer = StageTimer("options")
    out = {"card": card}
    reset_launches()
    with timer.stage("cmc_int8_int16"):
        out["cmc"] = run_cmc_transfers(eeg, emg, device)
    out["cmc"]["launches"] = launches()
    _require(out["cmc"]["launches"]["msc_jackknife"] > 0,
             "the int8 CMC leg did not launch B1")
    reset_launches()
    with timer.stage("null_int16_upload"):
        out["null_int16"], observed = run_null(
            *cohort, device, transfer_dtype=np.int16)
    out["null_int16"]["launches"] = launches()
    d = float(np.abs(observed - observed_gram).max())
    out["null_int16"]["observed_max_abs_err"] = d
    log(json.dumps({"check": "null int16 upload: observed map",
                    "max_abs_err": d, "atol": OPT_NULL_OBS_ATOL}))
    _require(d <= OPT_NULL_OBS_ATOL, f"int16-upload null: observed map off "
             f"the float32 leg's by {d}")
    _require(out["null_int16"]["launches"]["null_tile"] > 0,
             "the int16-upload null did not launch B2")
    for name, dtype in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        reset_launches()
        with timer.stage(f"null_{name}"):
            out[f"null_{name}"], _ = run_null(*cohort, device,
                                              compute_dtype=dtype)
        out[f"null_{name}"]["launches"] = launches()
        _require(out[f"null_{name}"]["launches"]["null_tile"] > 0
                 and out[f"null_{name}"]["launches"]["threefry"] > 0,
                 f"the {name} null did not launch B2 and threefry")
        torch.cuda.empty_cache()
    with timer.stage("b2_16bit_check"):
        out["b2_bf16"] = check_null_kernel_16bit(device, torch.bfloat16)
        out["b2_f16"] = check_null_kernel_16bit(device, torch.float16)
    with timer.stage("b1_b3_many_tapers"):
        nws = (*OPT_NWS, OPT_NW_LARGE)
        out["b1"] = {f"nw={nw}": check_msc_many_tapers(eeg, emg, device, nw)
                     for nw in nws}
        out["b1_runtime_k_bitwise"] = {
            f"nw={nw}": check_msc_runtime_k_bitwise(eeg, emg, device, nw)
            for nw in OPT_B1_BITWISE_NWS}
        out["b3"] = {f"nw={nw}": check_coeff_many_tapers(cohort, device, nw)
                     for nw in nws}
    reset_launches()
    with timer.stage("ica_reference"):
        out["ica_reference"] = check_ica_reference(device)
    out["ica_reference"]["launches"] = launches()
    _require(out["ica_reference"]["launches"]["threefry"] > 0,
             "the reference-layout ICA did not draw with threefry")
    with timer.stage("device_trace"):
        out["device_trace"] = check_device_trace(eeg, emg, device)
    out["stages"] = dict(timer.stages)
    out["sec"] = timer.total
    timer.report(printer=log)
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
    import pandas
    import scipy
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "numpy": np.__version__, "scipy": scipy.__version__,
                    "pandas": pandas.__version__,
                    "mba_tpu_torch": mba_tpu_torch.__version__,
                    "device": torch.cuda.get_device_name(0),
                    "tf32_matmul": torch.backends.cuda.matmul.allow_tf32}))

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(json.dumps({"phase": "build", "sec": time.perf_counter() - t0,
                    "library": lib_path.name,
                    "sources": [p.name for p in _build.sources()]}))
    ptxas = ptxas_start()             # registers and spills, meanwhile

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
    options = run_options(eeg, emg, cohort, observed_gram, device, card)
    log(json.dumps({"phase": "options", **options}))
    del eeg, emg
    torch.cuda.empty_cache()

    pw_cohort = tuple(np.ascontiguousarray(x[..., :PW_CHANNELS])
                      for x in cohort)
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
    phase, phase_observed = run_phase_null(device)
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
    del frame
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    null_metadata = report_null_metadata(device)
    report_null_sec = time.perf_counter() - t0
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    pipe = run_pipeline(device, null_metadata)
    n_pipe = launches()
    _require(n_pipe["msc_jackknife"] > 0 and n_pipe["threefry"] > 0,
             f"the pipeline did not launch B1 and threefry: {n_pipe}")
    log(json.dumps({"phase": "pipeline", "card": card,
                    "sec": time.perf_counter() - t0, **pipe,
                    "report_null_sec": report_null_sec,
                    "launches": n_pipe}))
    torch.cuda.empty_cache()

    reset_launches()
    t0 = time.perf_counter()
    music = run_music(device)
    n_music = launches()
    log(json.dumps({"phase": "music", "card": card,
                    "sec": time.perf_counter() - t0, **music,
                    "launches": n_music}))

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh1 = run_mesh_world1(cohort, observed_pallas, phase_observed)
    mesh1["sec"] = time.perf_counter() - t0
    del cohort
    torch.cuda.empty_cache()
    mesh2 = run_mesh_two_ranks()
    log(json.dumps({"phase": "mesh", "card": card,
                    "sec": time.perf_counter() - t0, "world_1_nccl": mesh1,
                    "two_gloo_ranks_one_card": mesh2}))

    report = ptxas_report(ptxas)
    hgmma = sass_hgmma(lib_path)
    paths = {"cmc": n_cmc, "null_gram": n_gram, "null_pallas": n_pallas,
             "null_per_window": n_pw, "fft_null": n_fft,
             "feature_extraction": n_feat, "preprocessing": n_pre,
             "phase_null": n_phase, "statistics": n_stat,
             "pipeline": n_pipe, "music": n_music,
             "mesh": mesh1["launches"], "mesh_2_ranks": mesh2["launches"],
             "options_cmc": options["cmc"]["launches"],
             "options_null_int16": options["null_int16"]["launches"],
             "options_ica_reference": options["ica_reference"]["launches"]}
    by_path = lambda k: {p: n[k] for p, n in paths.items()}
    kernels = [
        {"name": "msc_jackknife", "route": "cuda",
         "source": "mba_tpu_torch/csrc/msc_jackknife.cu",
         "replaces": "mba_tpu/ops/pallas_msc.py:40",
         "launches": n_cmc["msc_jackknife"],
         "launches_by_path": by_path("msc_jackknife"), **msc,
         "task_cmc_11x64": narrow, "many_tapers": options["b1"],
         "runtime_k_bitwise": options["b1_runtime_k_bitwise"],
         "ptxas": report["msc_jackknife"]},
        {"name": "null_tile", "route": "cuda",
         "source": "mba_tpu_torch/csrc/null_tile.cu",
         "replaces": "mba_tpu/ops/pallas_null.py:37",
         "launches": n_gram["null_tile"],
         "launches_by_path": by_path("null_tile"), **null},
        *({"name": f"null_tile_{name}", "route": "cuda",
           "source": "mba_tpu_torch/csrc/null_tile_tc.cu",
           "replaces": "mba_tpu/ops/pallas_null.py:37",
           "note": f"B2's {name} instance (compute_dtype={dtype}): wgmma "
                   "on the tensor cores, float32 accumulators, the "
                   "count/max epilogue on the accumulator layout",
           "launches": options[f"null_{name}"]["launches"]["null_tile"],
           **options[f"b2_{name}"], "ptxas": report["null_tile_tc"][name],
           "sass_hgmma": hgmma[name]}
          for name, dtype in (("bf16", "torch.bfloat16"),
                              ("f16", "torch.float16"))),
        {"name": "coeff_pairs", "route": "cuda",
         "source": "mba_tpu_torch/csrc/coeff_pairs.cu",
         "replaces": "mba_tpu/ops/pallas_coeffs.py:83",
         "launches": n_pallas["coeff_pairs"],
         "launches_by_path": by_path("coeff_pairs"), **coeff,
         "many_tapers": options["b3"],
         "ptxas": report["coeff_pairs"]},
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
