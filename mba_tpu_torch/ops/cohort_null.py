"""Cohort 10k-surrogate MSC null by exact algebraic taper rotation.

Port of ``mba_tpu/ops/cohort_null.py`` (:103-125, :332-664, :716-736,
:801-1532) on one device.  The surrogate operation
rotates each taper's EMG spectrum by a phase φ_k(f) drawn per (subject,
taper, frequency, surrogate) and shared across windows and channels;
with C_kl the window-mean products of the normalised taper spectra,

    stat(φ) = Σ_k C_kk + Σ_{k<l} [cosΔ_kl · 2Re C_kl − sinΔ_kl · 2Im C_kl],

so each surrogate is a dot product of length K(K−1) against trig
features of the phases.  The pipeline:

1. per subject, the coefficient pass (by default the gram matmuls of
   ``gram_coeffs.py``, float32) → base (F, E, M) and coef (F, E, M, P);
2. the cohort epilogue: subject-mean base, stacked coefficients
   (J, F, N, P) and the observed statistic (φ = 0);
3. the relayout for the kernel, ``cuda_null.prepare_null_coeffs``;
4. per chunk of surrogates: φ drawn as the JAX package draws it
   (``jax.random``'s threefry, ``ops/prng.py``; on the card the kernel of
   ``ops/cuda_prng.py``), trig features, and the surrogate tile
   ``cuda_null.null_tile`` (kernel B2 on a CUDA tensor, its plain version
   on a CPU tensor) → per-surrogate max and per-cell exceedance counts.

The inference runs on a maximal disjoint window subset by default
(``p_value_windows='disjoint'``): the shared rotation is distribution-
preserving only for non-overlapping windows.

The coefficient pass has three engines (``coeff_engine``): the gram
matmuls (``'auto'``/``'gram'``), and the chunked window pass of
``rotation_coeffs.py`` whose pair products run through kernel B3
(``'pallas'``) or its plain version (``'xla'``).
``rotation_mode='per_window'`` draws an independent rotation per window
(:func:`null_chunk_pw`).  ``compute_dtype`` bfloat16 or float16 rounds
the contraction's operands once, with float32 products and sums (B2's
16-bit instance); ``transfer_dtype`` int16/int8/float16 converts a float
cohort on the host before its upload (:func:`upload_quantizer`).
:func:`cohort_msc_fft_null` is the classic full-FFT phase-randomisation
engine, and :func:`cohort_msc_null` picks between it and the rotation
engine by an estimate of the full-FFT engine's flops.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from mba_tpu_torch import _dist
from mba_tpu_torch._device import (Upload, dtype_name, entry_device,
                                   synchronize, to_device, upload,
                                   wait_stream)
from mba_tpu_torch._dist import check_mesh, flat_index, mesh_entry_device
from mba_tpu_torch.native.quantize import (quantize_int8_per_channel,
                                           quantize_int16_per_channel)
from mba_tpu_torch.ops import cuda_prng, prng
from mba_tpu_torch.ops.cuda_coeffs import _F32_TINY
from mba_tpu_torch.ops.cuda_null import (feature_rows, null_epilogue,
                                         null_features, null_tile,
                                         null_tile_plain,
                                         prepare_null_coeffs)
from mba_tpu_torch.ops.dpss import filtered_tapers
from mba_tpu_torch.ops.framing import window_grid
from mba_tpu_torch.ops.gram_coeffs import _pair_indices, gram_coeffs_subject
from mba_tpu_torch.ops.rotation_coeffs import (band_spectra, pad_windows,
                                               rotation_coeffs_subject)
from mba_tpu_torch.utils.profiling import count, recording, span

# cohort_msc_null's default flop budget for the full-FFT engine, by
# device type: the CPU value is the JAX package's (cohort_null.py:1501);
# the CUDA value is what chip_smoke.py's full-FFT phase (2 subjects ×
# 12 s × 8×8, 200 surrogates) runs in about 3 s at its median warm rate
# of 0.98e12 flop/s on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
FFT_FLOP_BUDGET = {"cpu": 2e11, "cuda": 3e12}


def compute_dtype_of(compute_dtype) -> torch.dtype:
    """The contraction's operand type: None and float32 → float32;
    bfloat16 and float16 by a torch, numpy or JAX type or by name."""
    name = "float32" if compute_dtype is None else dtype_name(compute_dtype)
    if name not in ("float32", "bfloat16", "float16"):
        raise ValueError("compute_dtype must be float32, bfloat16 or "
                         f"float16, got {compute_dtype!r}")
    return getattr(torch, name)


def upload_quantizer(transfer_dtype, eeg_cohort, emg_cohort):
    """The host conversion of a float cohort for ``transfer_dtype``
    (``cohort_null.py:1034-1056``) into a CPU tensor, or None where the
    cohort travels as it is: no ``transfer_dtype`` or float32, tensors
    (their caller owns placement and precision), or integer ADC counts
    already of the integer ``transfer_dtype`` (the passthrough).
    int16/int8 quantize per (subject, channel) peak, float16/bfloat16
    cast."""
    name = "float32" if transfer_dtype is None else dtype_name(transfer_dtype)
    if name == "float32" or any(
            isinstance(x, torch.Tensor) for x in (eeg_cohort, emg_cohort)):
        return None
    if name in ("int16", "int8"):
        if {np.asarray(x).dtype for x in (eeg_cohort, emg_cohort)} \
                == {np.dtype(name)}:
            return None
        quant = (quantize_int16_per_channel if name == "int16"
                 else quantize_int8_per_channel)
        return lambda x: torch.from_numpy(quant(np.asarray(x, np.float32)))
    if name not in ("float16", "bfloat16"):
        raise ValueError("transfer_dtype must be float16, bfloat16, int16, "
                         f"int8, float32 or None, got {transfer_dtype!r}")
    return lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, name))


def phase_features(phi: torch.Tensor) -> torch.Tensor:
    """Rotation-phase trig features.

    phi: (..., K, F) → (..., F, P) with P = K(K−1):
    ``[cos(φ_k−φ_l)]_{k<l} ++ [sin(φ_k−φ_l)]_{k<l}`` — the observed
    statistic corresponds to φ = 0, i.e. features ``[1…1, 0…0]``.
    """
    K = phi.shape[-2]
    ks, ls = (torch.as_tensor(i, device=phi.device)
              for i in _pair_indices(K))
    c, s = torch.cos(phi), torch.sin(phi)
    # cos(a−b) = ca·cb + sa·sb ; sin(a−b) = sa·cb − ca·sb
    cos_d = c[..., ks, :] * c[..., ls, :] + s[..., ks, :] * s[..., ls, :]
    sin_d = s[..., ks, :] * c[..., ls, :] - c[..., ks, :] * s[..., ls, :]
    feats = torch.cat([cos_d, sin_d], dim=-2)          # (..., P, F)
    return feats.movedim(-2, -1)                        # (..., F, P)


def cohort_epilogue(bases, coefs):
    """Stack per-subject coefficients (``_pipelined_epilogue``).

    bases: J × (F, E, M); coefs: J × (F, E, M, P) → (base_cohort
    (F, E, M), coef_all (J, F, N, P), observed_flat (F, N)).
    """
    base_cohort = torch.stack(bases).mean(dim=0)
    coef_all = torch.stack([c.reshape(c.shape[0], -1, c.shape[-1])
                            for c in coefs])
    P = coef_all.shape[-1]
    base_flat = base_cohort.reshape(base_cohort.shape[0], -1)
    # observed = stat at φ = 0: cos features 1, sin features 0
    observed_flat = base_flat + coef_all[..., :P // 2].sum(dim=-1).mean(0)
    return base_cohort, coef_all, observed_flat


def cohort_epilogue_pw(bases, coefws):
    """Per-window counterpart (``_cohort_rotation_coeffs_pw``'s tail).

    bases: J × (F, E, M); coefws: J × (Wp, F, N, P) → (base_cohort
    (F, E, M), coefw_all (Wp, J, F, N, P), observed_flat (F, N)).
    """
    base_cohort = torch.stack(bases).mean(dim=0)
    coefw_all = torch.stack(coefws, dim=1)
    P = coefw_all.shape[-1]
    base_flat = base_cohort.reshape(base_cohort.shape[0], -1)
    # the pad windows' coefficients are exactly zero
    observed_flat = base_flat + coefw_all[..., :P // 2].sum(
        dim=(0, -1)).mean(0)
    return base_cohort, coefw_all, observed_flat


@dataclass
class NullState:
    """What the surrogate loop needs, resident on the device.

    base_flat / observed_flat: (F, N) float32; coefT: (F, J·P, ldc)
    (``prepare_null_coeffs`` layout), or (Wp, F, J·P, ldc) in the
    per-window mode, in the contraction's operand type (float32, or
    bfloat16/float16 rounded once; ldc is N, rounded up to a multiple of 8
    in 16 bits); n_subjects J; n_feats P = K(K−1).
    """
    base_flat: torch.Tensor
    observed_flat: torch.Tensor
    coefT: torch.Tensor
    n_subjects: int
    n_feats: int


def null_state(base_cohort: torch.Tensor, coef_all: torch.Tensor,
               observed_flat: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32) -> NullState:
    """coef_all (J, F, N, P), or (Wp, J, F, N, P) per window."""
    *_, J, nF, N, P = coef_all.shape
    return NullState(
        base_flat=base_cohort.reshape(nF, N).to(torch.float32).contiguous(),
        observed_flat=observed_flat.to(torch.float32).contiguous(),
        coefT=prepare_null_coeffs(coef_all, compute_dtype), n_subjects=J,
        n_feats=P)


def draw_phases(key, J: int, n_chunk: int, K: int, nF: int, device
                ) -> torch.Tensor:
    """φ = ``jax.random.uniform(key, (J, n_chunk, K, nF), minval=0,
    maxval=2π)``, float32 on ``device`` (``cohort_null.py:724``)."""
    return cuda_prng.uniform(key, (J, n_chunk, K, nF), 0.0, 2.0 * np.pi,
                             device)


def null_chunk(phi: torch.Tensor, state: NullState):
    """One chunk of surrogates through the surrogate tile.

    phi: (J, S, K, F).  Returns (max_stat (S,), counts increment (F, N)).
    The features are rounded once to the state's operand type.
    """
    G = null_features(phase_features(phi), state.coefT.dtype)  # (F, J·P, S)
    return null_tile(G, state.coefT, state.base_flat, state.observed_flat,
                     state.n_subjects, phi.shape[1])


def window_phases(key, Wp: int, J: int, n_chunk: int, K: int, nF: int,
                  device):
    """φ for each of the Wp windows of one per-window surrogate chunk,
    (J, n_chunk, K, nF) each: window w draws from ``fold_in(key, w)``,
    as ``cohort_null.py:441-443`` does."""
    for w in range(Wp):
        yield draw_phases(prng.fold_in(key, w), J, n_chunk, K, nF, device)


def null_chunk_pw(phases, state: NullState):
    """One surrogate chunk with independent rotations per window
    (``_null_chunk_jit_pw``, ``cohort_null.py:428-457``).

    phases: one (J, S, K, F) tensor per window, Wp in all (an iterable,
    so only one window's features are alive at a time); state.coefT
    (Wp, F, J·P, N).  The window contributions are summed with ``bmm``
    in window order, then the plain surrogate tile's epilogue; 16-bit
    operands are rounded and widened to float32 for the product, as the
    JAX ``dot_general`` takes them (``cohort_null.py:446-449``).  Returns
    (max_stat (S,), counts increment (F, N)).
    """
    dtype = state.coefT.dtype
    N = state.base_flat.shape[1]
    acc = None
    for w, phi in enumerate(phases):
        rows = feature_rows(phase_features(phi))
        coef_w = state.coefT[w][..., :N]
        if dtype != torch.float32:
            rows, coef_w = rows.to(dtype).float(), coef_w.float()
        inc = torch.bmm(rows, coef_w)
        acc = inc if acc is None else acc.add_(inc)
    stat = state.base_flat[:, None, :] + acc / state.n_subjects
    return null_epilogue(stat, state.observed_flat)


def _null_chunk_core(phi, coef_all, base_cohort, observed, counts,
                     compute_dtype: torch.dtype = torch.float32):
    """One surrogate chunk in the JAX package's layout
    (``cohort_null.py:716-736``), φ given explicitly, through the plain
    surrogate tile: the kernel's layout and arithmetic, without it.  A
    16-bit ``compute_dtype`` rounds both operands once, with float32
    products and sums (``:729-732``).

    coef_all: (J, F, N, P); base_cohort/observed: (F, N); phi:
    (J, S, K, F).  Returns (max_stat (S,), counts + exceedances).
    """
    G = null_features(phase_features(phi), compute_dtype)
    max_stat, inc = null_tile_plain(
        G, prepare_null_coeffs(coef_all, compute_dtype), base_cohort,
        observed, coef_all.shape[0], phi.shape[1])
    return max_stat, counts + inc


def disjoint_window_weights(window_starts: np.ndarray,
                            window_weights: np.ndarray,
                            window_samples: int) -> np.ndarray:
    """Greedy maximal non-overlapping subset per subject (zero-weight
    windows never block an active one); returns the masked weights."""
    keep = np.zeros(window_starts.shape, np.float32)
    for j in range(window_starts.shape[0]):
        order = np.argsort(window_starts[j], kind="stable")
        last = -(1 << 62)
        for idx in order:
            if window_weights[j, idx] == 0.0:
                continue
            s = int(window_starts[j, idx])
            if s >= last + window_samples:
                keep[j, idx] = 1.0
                last = s
    weights = window_weights * keep
    if not weights.any():
        raise ValueError("p_value_windows='disjoint' left no active "
                         "windows — check window_starts/weights")
    return weights


def _band_bins(window_samples: int, sampling_freq: float, band):
    """The band's rFFT bins, never DC nor Nyquist: (freqs, lo, hi)."""
    freqs_all = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)
    lo = max(int(np.searchsorted(freqs_all, band[0], side="left")), 1)
    hi = min(int(np.searchsorted(freqs_all, band[1], side="right")),
             len(freqs_all) - (1 if window_samples % 2 == 0 else 0))
    if hi <= lo:
        raise ValueError(f"band {band} selects no frequency bins")
    return freqs_all[lo:hi], lo, hi


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _quantized(quantize, x) -> torch.Tensor:
    """``quantize(x)``, spanned as ``null.quantize``."""
    with span("null.quantize"):
        return quantize(x)


def _window_set(window_starts, window_weights, J: int, n_samples: int,
                window_samples: int, hop: int, sampling_freq: float):
    """(J, W) int64 starts and float32 weights; by default the full
    "cmc" grid for every subject, all weight 1."""
    if window_starts is None:
        starts, _ = window_grid(n_samples, window_samples, hop,
                                sampling_freq, convention="cmc")
        window_starts = np.tile(starts[None], (J, 1))
    window_starts = np.asarray(window_starts, np.int64)
    if window_weights is None:
        window_weights = np.ones(window_starts.shape, np.float32)
    return window_starts, np.asarray(window_weights, np.float32)


def cohort_msc_rotation_null(
        eeg_cohort,
        emg_cohort,
        sampling_freq: float,
        n_surrogates: int = 10_000,
        nw: float = 3,
        window_length_sec: float = 2.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        band: tuple[float, float] = (13.0, 100.0),
        quantiles=(0.95, 0.99),
        surrogate_chunk: int = 256,
        window_chunk: int = 32,
        seed: int = 0,
        compute_dtype=None,
        transfer_dtype=None,
        mesh=None,
        window_starts=None,
        window_weights=None,
        p_value_windows: str = "disjoint",
        rotation_mode: str = "shared",
        per_window_max_coef_bytes: int = 2 * 1024 ** 3,
        overlap_upload: bool = True,
        precompute_only: bool = False,
        coeff_engine: str = "auto",
        verbose: bool = False,
        device=None,
) -> dict:
    """Cohort-level FWE-corrected MSC surrogate null (module docstring).

    Same arguments and result dictionary as
    ``mba_tpu.ops.cohort_null.cohort_msc_rotation_null``; arrays come back
    as numpy.  ``device`` as in ``coherence.multitaper_msc``.  Surrogate
    phases follow the JAX package's keys (``cohort_null.py:1243-1256``):
    ``key = PRNGKey(seed)``, per chunk ``key, sub = split(key)``, then
    :func:`draw_phases` of ``sub`` (of ``fold_in(sub, w)`` per window in
    the per-window mode, :func:`window_phases`), so at equal
    ``surrogate_chunk`` a seed gives the JAX package's phases on either
    device.  The contraction runs in ``compute_dtype`` (default float32,
    as the JAX package off a TPU; bfloat16 or float16 round G and the
    coefficients once, and the products and sums stay float32).

    ``transfer_dtype`` on a float host cohort: int16/int8 quantize each
    (subject, channel) to its peak on the host
    (``native.quantize_int16_per_channel``; the scale cancels in MSC), a
    float type casts; the converted arrays upload and every engine casts
    them to float32 on the device.  Integer ADC counts of the named
    integer type pass as they are; tensors are never converted.
    ``timings['quantize_sec']`` is the host conversion's seconds and
    ``upload_bytes`` the bytes that crossed.

    Every call is recorded (``utils.profiling.recording``):
    ``timings['spans']`` holds the records of the root ``null``,
    ``null.plan``, one ``null.upload`` (with ``null.quantize`` inside
    where the host converts) and one ``null.coeffs`` a subject (one of
    each for the whole cohort where ``overlap_upload`` is False),
    ``null.gather`` under a mesh, ``null.epilogue``, and
    ``null.surrogates`` with one ``null.chunk`` a surrogate chunk;
    ``timings['counters']`` the windows the coefficient pass frames,
    padding included (``coeffs.windows_framed``), and those of nonzero
    weight (``coeffs.windows_weighted``).  The ``*_sec`` times come from
    these spans: ``upload_sec`` is the sum of ``null.upload``,
    ``quantize_sec`` of ``null.quantize``, ``coeffs_sec`` of
    ``null.coeffs`` and ``null.gather``, ``null_sec`` of
    ``null.surrogates``; ``precompute_sec`` runs from the end of
    ``null.plan`` (the window set's upload follows it) to the end of
    ``null.epilogue``.

    ``coeff_engine``: ``'auto'`` and ``'gram'`` run the gram matmuls;
    ``'pallas'`` the chunked window pass through kernel B3 (its plain
    version on the CPU); ``'xla'`` that pass through B3's plain version
    on any device.  ``window_chunk`` sets the windows per chunk of the
    latter two.  ``rotation_mode='per_window'`` always runs the plain
    chunked pass, with the window axis kept (metadata ``'xla'``), and
    needs ``p_value_windows='disjoint'`` and at most
    ``per_window_max_coef_bytes`` of coefficients.
    ``overlap_upload=True`` uploads and processes one subject at a time;
    ``False`` uploads the whole cohort first, then runs the passes.

    ``mesh``: a ``DeviceMesh`` of ``parallel.make_mesh`` (anything else
    raises ``TypeError``); every rank calls with the same arguments and
    gets the whole result.  The coefficient pass is sharded by subject
    over the mesh's flat ranks (the cohort padded by repeating its last
    subject; each rank uploads and runs only its own subjects, one at a
    time, whatever ``overlap_upload`` says), then all-gathered.  Each
    round of the surrogate loop, flat rank r draws its chunk from
    ``split(sub, n_ranks)[r]`` as the JAX mesh does, runs the surrogate
    tile, and the ranks all-reduce their count increments and all-gather
    their maxima: ``n_ranks · surrogate_chunk`` surrogates a round.  The
    mesh decides the device (a ``device`` naming another raises), and
    the per-window mode refuses a mesh, as in the JAX package.
    """
    with recording() as rec, span("null"):
        with span("null.plan"):
            if rotation_mode not in ("shared", "per_window"):
                raise ValueError("rotation_mode must be 'shared' or "
                                 f"'per_window', got {rotation_mode!r}")
            per_window = rotation_mode == "per_window"
            if mesh is not None:
                check_mesh(mesh)
                if per_window:
                    raise ValueError("rotation_mode='per_window' does not "
                                     "support mesh sharding; use the shared "
                                     "mode or run single-device")
            if coeff_engine not in ("auto", "gram", "pallas", "xla"):
                raise ValueError("coeff_engine must be 'auto', 'gram', "
                                 f"'pallas' or 'xla', got {coeff_engine!r}")
            cdtype = compute_dtype_of(compute_dtype)
            quantize = upload_quantizer(transfer_dtype, eeg_cohort,
                                        emg_cohort)
            if mesh is None:
                device = entry_device(device, eeg_cohort, emg_cohort)
            else:
                device = mesh_entry_device(mesh, device)

            eeg_shape = tuple(np.shape(eeg_cohort))
            emg_shape = tuple(np.shape(emg_cohort))
            if len(eeg_shape) != 3 or len(emg_shape) != 3:
                raise ValueError(
                    "cohort arrays must be (J, n_samples, n_channels)")
            if eeg_shape[:2] != emg_shape[:2]:
                raise ValueError("EEG/EMG cohorts must share (J, n_samples)")
            J, n_samples, nE = eeg_shape
            nM = emg_shape[2]

            window_samples = int(window_length_sec * sampling_freq)
            hop = int(window_samples * (1 - overlap_frac))
            tapers = filtered_tapers(window_samples, nw,
                                     taper_eigenvalue_threshold)
            K = int(tapers.shape[0])
            if K < 2:
                raise ValueError("rotation null requires at least 2 tapers")
            freqs, lo, hi = _band_bins(window_samples, sampling_freq, band)
            nF = hi - lo

            window_starts, window_weights = _window_set(
                window_starts, window_weights, J, n_samples, window_samples,
                hop, sampling_freq)
            if p_value_windows == "disjoint":
                window_weights = disjoint_window_weights(
                    window_starts, window_weights, window_samples)
            elif p_value_windows != "all":
                raise ValueError("p_value_windows must be 'disjoint' or "
                                 f"'all', got {p_value_windows!r}")
            W = window_starts.shape[1]
            wc = int(min(window_chunk, W))
            Wp = -(-W // wc) * wc
            if per_window:
                if p_value_windows != "disjoint":
                    raise ValueError(
                        "rotation_mode='per_window' requires "
                        "p_value_windows='disjoint': independent per-window "
                        "rotations are only distribution-preserving for "
                        "non-overlapping windows")
                pw_bytes = Wp * J * nF * nE * nM * K * (K - 1) * 4
                if pw_bytes > per_window_max_coef_bytes:
                    raise ValueError(
                        f"per-window coefficients need {pw_bytes / 1e9:.1f} "
                        f"GB (> {per_window_max_coef_bytes / 1e9:.1f} GB "
                        "budget) — the per-window mode is for small window "
                        "counts / channel subsets; use rotation_mode="
                        "'shared' (window-summed coefficients, "
                        "W-independent memory) at this scale")
            engine = "gram" if coeff_engine == "auto" else coeff_engine
            if per_window:
                engine = "xla"            # per-window keeps the scan engine

        # ---- all-subject rotation coefficients (device-resident) ----
        tapers_t = torch.as_tensor(tapers, dtype=torch.float32,
                                   device=device)
        starts_all = torch.as_tensor(window_starts, device=device)
        weights_all = torch.as_tensor(window_weights, device=device)

        def subject_coeffs(eeg_j, emg_j, j):
            # integer ADC counts travel as they are; every engine casts
            # them to float32 per window chunk.  The engine counts the
            # windows it frames; the weighted ones are counted here, from
            # the host's copy of the weights
            count("coeffs.windows_weighted",
                  np.count_nonzero(window_weights[j]))
            if engine == "gram":
                return gram_coeffs_subject(eeg_j, emg_j, starts_all[j],
                                           weights_all[j], tapers_t,
                                           window_samples, lo, hi)
            return rotation_coeffs_subject(
                eeg_j, emg_j, starts_all[j], weights_all[j], tapers_t,
                window_samples, lo, hi, wc, engine=engine,
                per_window=per_window)

        def link(*xs) -> Upload:
            """``xs`` on their way to the device, converted on the host
            first where ``transfer_dtype`` asks for it (spanned apart:
            null.quantize)."""
            if quantize is not None:
                xs = [_quantized(quantize, x) for x in xs]
            return upload(xs, device)

        def subject_upload(j) -> Upload:
            """Subject j's signals on the device: the ``null.upload``
            span closes when their bytes are there (at the copy's event,
            not a device-wide synchronise)."""
            with span("null.upload"):
                up = link(eeg_cohort[j], emg_cohort[j])
                up.wait()
            return up

        upload_bytes = 0
        bases, coefs = [], []
        if mesh is not None or (overlap_upload and not per_window):
            # one subject at a time: subject j's pass is queued, then
            # subject j + 1 goes up on the copy stream under it (its
            # null.upload span nested in pass j's null.coeffs), then the
            # host waits for pass j.  Under a mesh (cohort_null.py:667-713,
            # :1115-1155) flat rank r takes subjects r·jl … (r+1)·jl − 1
            # of the cohort padded to n_ranks·jl by repeating the last
            # subject; the passes are gathered and the pad rows dropped
            # before the epilogue
            if mesh is None:
                subjects = range(J)
            else:
                jl = -(-J // mesh.size())
                r = flat_index(mesh)
                subjects = [min(j, J - 1)
                            for j in range(r * jl, (r + 1) * jl)]
            up = subject_upload(subjects[0])
            for i, j in enumerate(subjects):
                eeg_j, emg_j = up.take()
                upload_bytes += _nbytes(eeg_j) + _nbytes(emg_j)
                with span("null.coeffs"):
                    b, c = subject_coeffs(eeg_j, emg_j, j)
                    bases.append(b)
                    coefs.append(c)
                    del eeg_j, emg_j
                    if i + 1 < len(subjects):
                        up = subject_upload(subjects[i + 1])
                    wait_stream(device)
            synchronize(device)
            if mesh is not None:
                with span("null.gather"):
                    bases = list(torch.cat(_dist.gather(torch.stack(bases),
                                                        mesh))[:J])
                    coefs = list(torch.cat(_dist.gather(torch.stack(coefs),
                                                        mesh))[:J])
                    synchronize(device)
        else:
            # fused (cohort_null.py:1059-1080): the whole cohort first
            with span("null.upload"):
                eeg_d, emg_d = link(eeg_cohort, emg_cohort).take()
                synchronize(device)
            upload_bytes = _nbytes(eeg_d) + _nbytes(emg_d)
            with span("null.coeffs"):
                for j in range(J):
                    b, c = subject_coeffs(eeg_d[j], emg_d[j], j)
                    bases.append(b)
                    coefs.append(c)
                del eeg_d, emg_d
                synchronize(device)
        with span("null.epilogue"):
            epilogue = cohort_epilogue_pw if per_window else cohort_epilogue
            base_cohort, coef_all, observed_flat = epilogue(bases, coefs)
            del bases, coefs
            observed = observed_flat.reshape(nF, nE, nM).cpu().numpy()
        P_feats = int(coef_all.shape[-1])
        # each time is the sum of its spans; upload_sec includes the host
        # conversion, quantize_sec is it alone
        t_stage = dict(
            precompute_sec=rec.end("null.epilogue") - rec.end("null.plan"),
            quantize_sec=rec.seconds("null.quantize"),
            upload_sec=rec.seconds("null.upload"),
            coeffs_sec=rec.seconds("null.coeffs", "null.gather"),
            upload_bytes=int(upload_bytes), coeff_engine=engine)
        if mesh is not None:
            t_stage["coeffs_shard_devices"] = mesh.size()

        if precompute_only:
            return {
                "observed": observed,
                "freqs": freqs,
                "metadata": {
                    "method": "taper_rotation",
                    "rotation_mode": rotation_mode,
                    "K_tapers": K,
                    "n_subjects": J,
                    "band": tuple(band),
                    "band_bins": (lo, hi),
                    "timings": {**t_stage, **rec.timings()},
                },
            }

        if verbose:
            gB = coef_all.numel() * 4 / 1e9
            print(f"[rotation-null] J={J} K={K} F={nF} pairs={nE}x{nM} "
                  f"P={P_feats} coef tensor {gB:.2f} GB, "
                  f"{n_surrogates} surrogates in chunks of {surrogate_chunk}")

        # ---- surrogate chunks --------------------------------------------
        with span("null.surrogates"):
            state = null_state(base_cohort, coef_all, observed_flat, cdtype)
            del coef_all
            counts = torch.zeros((nF, nE * nM), dtype=torch.int32,
                                 device=device)
            chunk = int(min(surrogate_chunk, n_surrogates))
            key = prng.prng_key(seed)
            max_stats = []
            n_total = 0
            while n_total < n_surrogates:
                with span("null.chunk"):
                    key, sub = prng.split(key)
                    if per_window:
                        ms, inc = null_chunk_pw(
                            window_phases(sub, Wp, J, chunk, K, nF, device),
                            state)
                    elif mesh is not None:
                        # cohort_null.py:748-800, :1257-1313: this rank's
                        # chunk, then the count increments summed and the
                        # maxima gathered
                        rank_key = prng.split(sub, mesh.size())[
                            flat_index(mesh)]
                        ms, inc = null_chunk(
                            draw_phases(rank_key, J, chunk, K, nF, device),
                            state)
                        _dist.psum_(inc)
                        ms = torch.cat(_dist.gather(ms, mesh))
                    else:
                        ms, inc = null_chunk(
                            draw_phases(sub, J, chunk, K, nF, device), state)
                    counts += inc
                    max_stats.append(ms)
                n_total += ms.shape[0]
            # surplus draws in the last chunk are equally valid null
            # samples; the per-cell counts are normalised by the true total
            max_stat = torch.cat(max_stats).cpu().numpy()[:n_surrogates]
            counts_np = counts.cpu().numpy().reshape(nF, nE, nM)
        p_unc = (1.0 + counts_np) / (1.0 + n_total)
        p_fwe = float((1.0 + (max_stat >= observed.max()).sum())
                      / (1.0 + len(max_stat)))

        return {
            "observed": observed,
            "freqs": freqs,
            "max_stat": max_stat,
            "null_quantiles": {q: float(np.quantile(max_stat, q))
                               for q in quantiles},
            "p_uncorrected": p_unc.astype(np.float32),
            "p_fwe": p_fwe,
            "metadata": {
                "method": "taper_rotation",
                "K_tapers": K,
                "n_surrogates_drawn": int(n_total),
                "n_surrogates": int(n_surrogates),
                "band": tuple(band),
                "band_bins": (lo, hi),
                "n_subjects": J,
                "rotation_mode": rotation_mode,
                "compute_dtype": str(cdtype).removeprefix("torch."),
                "contraction_flops": float(2 * n_total * nF * nE * nM * J
                                           * P_feats * (Wp if per_window
                                                        else 1)),
                "timings": {**t_stage,
                            "null_sec": rec.seconds("null.surrogates"),
                            **rec.timings()},
            },
        }


# ---- the full-FFT phase-randomisation engine -----------------------------

def _msc_map_subject(eeg, emg, starts, weights, tapers, window_samples: int,
                     band_lo: int, band_hi: int, window_chunk: int):
    """One subject's weighted window-mean MSC map (F, E, M): the chunked
    loop of ``_cohort_msc_map`` (``cohort_null.py:475-506``)."""
    starts, weights = pad_windows(starts, weights, window_chunk)
    acc = None
    for c0 in range(0, starts.shape[0], window_chunk):
        cs = starts[c0:c0 + window_chunk]
        wts = weights[c0:c0 + window_chunk]
        Es = band_spectra(eeg, cs, tapers, window_samples, band_lo, band_hi)
        Ms = band_spectra(emg, cs, tapers, window_samples, band_lo, band_hi)
        Er, Ei = Es.real[..., :, None], Es.imag[..., :, None]
        Mr, Mi = Ms.real[..., None, :], Ms.imag[..., None, :]
        csd_r = (Er * Mr + Ei * Mi).sum(dim=1)          # (wc, F, E, M)
        csd_i = (Er * Mi - Ei * Mr).sum(dim=1)
        pe = (Es.real ** 2 + Es.imag ** 2).sum(dim=1)
        pm = (Ms.real ** 2 + Ms.imag ** 2).sum(dim=1)
        den = torch.clamp_min(pe[..., :, None] * pm[..., None, :], _F32_TINY)
        msc = (csd_r ** 2 + csd_i ** 2) / den
        part = (wts[:, None, None, None] * msc).sum(dim=0)
        acc = part if acc is None else acc.add_(part)
    return acc / torch.clamp_min(weights.sum(), _F32_TINY)


def cohort_msc_map(eeg, emg, starts, weights, tapers, window_samples: int,
                   band_lo: int, band_hi: int, window_chunk: int):
    """Cohort-mean weighted window-mean MSC map (F, E, M)
    (``_cohort_msc_map``).

    eeg (J, n, E) / emg (J, n, M) float32; starts (J, W) int; weights
    (J, W) float32; tapers (K, S); all on one device.
    """
    return torch.stack([
        _msc_map_subject(eeg[j], emg[j], starts[j], weights[j], tapers,
                         window_samples, band_lo, band_hi, window_chunk)
        for j in range(eeg.shape[0])]).mean(dim=0)


def fft_surrogate_maps(phases, eeg, emg_spec, starts, weights, tapers,
                       window_samples: int, band_lo: int, band_hi: int,
                       window_chunk: int, n_samples: int) -> torch.Tensor:
    """Cohort maps of S full-FFT surrogates (``cohort_null.py:606-617``).

    phases (S, J, n_f) float32, one phase per (surrogate, subject, signal
    bin) shared by the EMG channels; emg_spec (J, n_f, M) the rFFT of the
    EMG signals.  The surrogate signals are ``irfft(spec·e^{iφ})``; the S
    surrogates ride the EMG channel axis of one map evaluation (the map of
    pair (e, (s, m)) is surrogate s's map of (e, m)).  Returns (S, F, E·M).
    """
    S, J, _ = phases.shape
    nM = emg_spec.shape[-1]
    rot = torch.polar(torch.ones_like(phases), phases)
    surr = torch.fft.irfft(emg_spec[None] * rot[..., None], n=n_samples,
                           dim=2)                       # (S, J, n, M)
    emg_s = surr.permute(1, 2, 0, 3).reshape(J, n_samples, S * nM)
    maps = cohort_msc_map(eeg, emg_s, starts, weights, tapers,
                          window_samples, band_lo, band_hi, window_chunk)
    nF, nE = maps.shape[:2]
    return maps.reshape(nF, nE, S, nM).permute(2, 0, 1, 3).reshape(
        S, nF, nE * nM)


def cohort_msc_fft_null(
        eeg_cohort,
        emg_cohort,
        sampling_freq: float,
        n_surrogates: int = 1000,
        nw: float = 3,
        window_length_sec: float = 2.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        band: tuple[float, float] = (13.0, 100.0),
        quantiles=(0.95, 0.99),
        surrogate_chunk: int = 8,
        window_chunk: int = 32,
        seed: int = 0,
        window_starts=None,
        window_weights=None,
        verbose: bool = False,
        device=None,
) -> dict:
    """Classic full-FFT phase-randomisation cohort null (small scale).

    Port of ``mba_tpu.ops.cohort_null.cohort_msc_fft_null`` (:511-664),
    plain PyTorch: each surrogate draws fresh uniform phases on every
    subject's EMG signal spectrum (one per bin, shared across the EMG
    channels; DC and Nyquist stay real), resynthesises the EMG with
    ``torch.fft.irfft`` and re-evaluates the cohort MSC map over ALL
    windows.  Same arguments and result dictionary as the JAX function,
    plus ``device``; arrays come back as numpy.  Phases follow the JAX
    package's keys (``cohort_null.py:604-631``): per chunk ``key, sub =
    split(key)``, ``split(sub, chunk)``, one ``uniform`` of (J, n_f) per
    surrogate, so a seed gives its phases on either device.  A chunk of S
    surrogates holds S·J·n_samples·M float32 resynthesised samples.
    """
    device = entry_device(device, eeg_cohort, emg_cohort)
    if len(np.shape(eeg_cohort)) != 3 or len(np.shape(emg_cohort)) != 3:
        raise ValueError("cohort arrays must be (J, n_samples, n_channels)")
    if tuple(np.shape(eeg_cohort))[:2] != tuple(np.shape(emg_cohort))[:2]:
        raise ValueError("EEG/EMG cohorts must share (J, n_samples)")
    J, n_samples, nE = np.shape(eeg_cohort)
    nM = np.shape(emg_cohort)[2]

    window_samples = int(window_length_sec * sampling_freq)
    hop = int(window_samples * (1 - overlap_frac))
    tapers = filtered_tapers(window_samples, nw, taper_eigenvalue_threshold)
    K = int(tapers.shape[0])
    freqs, lo, hi = _band_bins(window_samples, sampling_freq, band)
    nF = hi - lo
    window_starts, window_weights = _window_set(
        window_starts, window_weights, J, n_samples, window_samples, hop,
        sampling_freq)
    W = window_starts.shape[1]
    wc = int(min(window_chunk, W))

    t_pre0 = time.perf_counter()
    eeg_d = to_device(eeg_cohort, device).to(torch.float32)
    emg_d = to_device(emg_cohort, device).to(torch.float32)
    starts_d = torch.as_tensor(window_starts, device=device)
    weights_d = torch.as_tensor(window_weights, device=device)
    tapers_t = torch.as_tensor(tapers, dtype=torch.float32, device=device)
    args = (starts_d, weights_d, tapers_t, window_samples, lo, hi, wc)
    observed_d = cohort_msc_map(eeg_d, emg_d, *args)
    spec = torch.fft.rfft(emg_d, dim=1)                  # (J, n_f, M)
    del emg_d
    observed = observed_d.cpu().numpy()
    observed_flat = observed_d.reshape(nF, nE * nM)
    t_precompute = time.perf_counter() - t_pre0

    t_null0 = time.perf_counter()
    counts = torch.zeros((nF, nE * nM), dtype=torch.int32, device=device)
    chunk = int(min(surrogate_chunk, n_surrogates))
    key = prng.prng_key(seed)
    max_stats = []
    n_total = 0
    while n_total < n_surrogates:
        key, sub = prng.split(key)
        phases = cuda_prng.uniform_keys(prng.split(sub, chunk),
                                        (J, spec.shape[1]), 0.0,
                                        2.0 * np.pi, device)
        phases[..., 0] = 0.0
        if n_samples % 2 == 0:
            phases[..., -1] = 0.0
        maps = fft_surrogate_maps(phases, eeg_d, spec, *args, n_samples)
        max_stats.append(maps.amax(dim=(1, 2)))
        counts += (maps >= observed_flat[None]).sum(dim=0, dtype=torch.int32)
        n_total += chunk
    max_stat = torch.cat(max_stats).cpu().numpy()[:n_surrogates]
    counts_np = counts.cpu().numpy().reshape(nF, nE, nM)
    t_null = time.perf_counter() - t_null0
    p_unc = (1.0 + counts_np) / (1.0 + n_total)
    p_fwe = float((1.0 + (max_stat >= observed.max()).sum())
                  / (1.0 + len(max_stat)))
    if verbose:
        print(f"[fft-null] J={J} K={K} F={nF} pairs={nE}x{nM} W={W}: "
              f"{n_total} surrogates in {t_null:.1f}s")

    return {
        "observed": observed,
        "freqs": freqs,
        "max_stat": max_stat,
        "null_quantiles": {q: float(np.quantile(max_stat, q))
                           for q in quantiles},
        "p_uncorrected": p_unc.astype(np.float32),
        "p_fwe": p_fwe,
        "metadata": {
            "method": "full_fft_phase_randomization",
            "K_tapers": K,
            "n_surrogates_drawn": int(n_total),
            "n_surrogates": int(n_surrogates),
            "band": tuple(band),
            "band_bins": (lo, hi),
            "n_subjects": J,
            "timings": {"precompute_sec": round(t_precompute, 3),
                        "null_sec": round(t_null, 3)},
        },
    }


def fft_null_flops(J: int, n_samples: int, nE: int, nM: int, W: int,
                   K: int, window_samples: int, nF: int,
                   n_surrogates: int) -> float:
    """Device-flop estimate of one full-FFT cohort null
    (``_fft_null_flops``, ``cohort_null.py:1400-1414``).

    Per surrogate: EMG signal resynthesis (irfft per subject×channel),
    EMG window taper FFTs, and the cohort MSC map re-evaluation (the EEG
    window spectra are surrogate-invariant and amortize to zero).
    """
    lg = float(np.log2(max(n_samples, 2)))
    lw = float(np.log2(max(window_samples, 2)))
    per_surr = J * (5.0 * n_samples * lg * nM                # resynthesis
                    + 5.0 * window_samples * lw * W * K * nM  # window FFTs
                    + 8.0 * K * W * nF * nE * nM)             # MSC map
    return per_surr * n_surrogates


SENSITIVITY_NOTE = (
    "rotation engine (calibrated disjoint inference): measured "
    "80%-power detectable-coupling floor at most 11% above the "
    "exact full-FFT engine at every window count in 8..1320 "
    "(BENCH_NULL_POWER.json detection_limit, cost ratio "
    "1.08-1.11); near-threshold rejection-rate gap up to 0.45 "
    "does not vanish with W.")


def cohort_msc_null(eeg_cohort, emg_cohort, sampling_freq: float,
                    n_surrogates: int = 10_000, method: str = "auto",
                    fft_flop_budget: float | None = None, **kw) -> dict:
    """Cohort FWE null with automatic engine selection.

    Port of ``mba_tpu.ops.cohort_null.cohort_msc_null`` (:1417-1532).
    ``'fft'`` (:func:`cohort_msc_fft_null`) lets every window, overlapping
    ones included, enter the inference exactly, at O(n_surrogates) cohort
    passes; ``'rotation'`` (:func:`cohort_msc_rotation_null`) precomputes
    once and draws surrogates as matmuls, on a disjoint window subset.
    ``method='auto'`` runs the fft engine when :func:`fft_null_flops`
    fits ``fft_flop_budget`` and the rotation engine otherwise; the
    default budget is :data:`FFT_FLOP_BUDGET` for the device the call
    runs on (``kw['device']``, else that of a tensor input, else the
    card).

    ``**kw`` go to the chosen engine; rotation-only options are dropped
    with a note (``metadata['dropped_rotation_kwargs']``) when the fft
    engine runs, and the rotation engine's result carries the measured
    sensitivity cost (``metadata['sensitivity_note']``).
    ``metadata['engine_choice']`` records what was asked, what ran and
    why.
    """
    if method not in ("auto", "fft", "rotation"):
        raise ValueError("method must be 'auto', 'fft' or 'rotation', "
                         f"got {method!r}")
    if len(np.shape(eeg_cohort)) != 3 or len(np.shape(emg_cohort)) != 3:
        raise ValueError("cohort arrays must be (J, n_samples, n_channels)")
    J, n_samples, nE = np.shape(eeg_cohort)
    nM = np.shape(emg_cohort)[2]

    window_length_sec = kw.get("window_length_sec", 2.0)
    overlap_frac = kw.get("overlap_frac", 0.5)
    nw = kw.get("nw", 3)
    band = kw.get("band", (13.0, 100.0))
    window_samples = int(window_length_sec * sampling_freq)
    hop = max(int(window_samples * (1 - overlap_frac)), 1)
    if kw.get("window_starts") is not None:
        W = int(np.asarray(kw["window_starts"]).shape[-1])
    else:
        W = max((n_samples - window_samples) // hop + 1, 1)
    nF = max(int((band[1] - band[0]) * window_length_sec), 1)
    K = max(int(2 * nw - 1), 2)

    choice = method
    est = fft_null_flops(J, n_samples, nE, nM, W, K, window_samples, nF,
                         n_surrogates)
    if method == "auto":
        if fft_flop_budget is None:
            device = entry_device(kw.get("device"), eeg_cohort,
                                  emg_cohort)
            if device.type not in FFT_FLOP_BUDGET:
                raise ValueError(f"no default fft_flop_budget for {device}")
            fft_flop_budget = FFT_FLOP_BUDGET[device.type]
        choice = "fft" if est <= fft_flop_budget else "rotation"

    if choice == "fft":
        fft_kw = dict(kw)
        dropped = [k for k in ("rotation_mode", "p_value_windows",
                               "compute_dtype", "transfer_dtype",
                               "overlap_upload", "precompute_only",
                               "coeff_engine", "per_window_max_coef_bytes")
                   if fft_kw.pop(k, None) is not None]
        fft_kw.setdefault("surrogate_chunk", 8)
        res = cohort_msc_fft_null(eeg_cohort, emg_cohort, sampling_freq,
                                  n_surrogates=n_surrogates, **fft_kw)
        if dropped:
            res["metadata"]["dropped_rotation_kwargs"] = dropped
    else:
        res = cohort_msc_rotation_null(eeg_cohort, emg_cohort,
                                       sampling_freq,
                                       n_surrogates=n_surrogates, **kw)
        res["metadata"]["sensitivity_note"] = SENSITIVITY_NOTE
    res["metadata"]["engine_choice"] = {
        "method_requested": method, "method_run": choice,
        "estimated_fft_flops": est,
        "fft_flop_budget": fft_flop_budget,
    }
    return res
