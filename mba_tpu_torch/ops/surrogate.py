"""Surrogate data and the phase-randomised coherence null (port of
``mba_tpu/ops/surrogate.py``).

- :func:`insert_bad_channels`, :func:`generate_noise`,
  :func:`add_noise_to_channels`: host fault injection, copied (numpy);
- :func:`phase_randomize`: FFT phase-randomised surrogates on an explicit
  ``torch.Generator``; :func:`rotate_phases` is its core on given phases
  and :func:`draw_chunk_phases` draws them;
- :func:`msc_phase_randomized_null`: the surrogate null of the
  window-averaged MSC spectrum, with the exact per-cell histogram and
  the in-band max statistic.

The JAX package draws its phases with ``jax.random``, so the two
packages' surrogates differ by design; the parity tests hand the port
the JAX draws through :func:`draw_chunk_phases`.  The JAX kernels are
plain XLA (no Pallas), so this module is plain PyTorch: cuFFT through
``torch.fft`` on the card.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from mba_tpu_torch._device import resolve_device, synchronize, to_device
from mba_tpu_torch.ops.dpss import filtered_tapers
from mba_tpu_torch.ops.framing import window_grid

_F32_TINY = torch.finfo(torch.float32).tiny
N_BINS = 1024        # histogram bins of the null's per-cell quantiles


# --------------------------------------------------------------------------
# Reference-parity fault injection (host-side, numpy)
# --------------------------------------------------------------------------
def insert_bad_channels(input_array: np.ndarray, axis=None,
                        n_channels: int = 5,
                        scale_range: tuple[float, float] = (10.0, 15.0),
                        rng: np.random.Generator | None = None,
                        ) -> tuple[np.ndarray, list[int]]:
    """Scale random channels to simulate bad channels.

    Parity: reference data_surrogation.py:19-65 — channels are drawn from
    index range [1, n_channels_total), scaled by a uniform factor, and the
    returned indices are 1-based.
    """
    if input_array.ndim == 1:
        input_array = input_array[:, None]
        axis = 0
    elif axis is None:
        raise AttributeError("For 2D signal arrays, axis needs to be defined!")
    rng = rng or np.random.default_rng()
    channel_axis = (axis + 1) % 2
    output = input_array.copy()
    picked = rng.choice(np.arange(1, input_array.shape[channel_axis]),
                        size=n_channels, replace=False)
    amended = []
    for ch in picked:
        factor = scale_range[0] + rng.random() * (scale_range[1]
                                                  - scale_range[0])
        output[:, ch] = input_array[:, ch] * factor
        amended.append(int(ch) + 1)
    return output, amended


def generate_noise(shape: tuple, noise_type: str, amplitude: float,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """White or pink (1/f) noise at a target RMS amplitude.

    Parity: reference data_surrogation.py:151-198 (pink noise via 1/sqrt(f)
    rFFT shaping, identical across channels).
    """
    rng = rng or np.random.default_rng()
    if noise_type == "white":
        noise = rng.normal(0, 1, shape)
    elif noise_type == "pink":
        white_fft = np.fft.rfft(rng.normal(0, 1, shape[0]))
        freqs = np.fft.rfftfreq(shape[0])
        freqs[0] = 1
        noise = np.fft.irfft(white_fft / np.sqrt(freqs), n=shape[0])
        if len(shape) > 1:
            noise = np.tile(noise[:, None], (1, shape[1]))
    else:
        raise ValueError(f"Unknown noise_type: {noise_type}")
    return noise * (amplitude / np.sqrt(np.mean(noise ** 2)))


def add_noise_to_channels(input_array: np.ndarray, noise_db: float,
                          channels: list[int], axis: int = 0,
                          noise_type: str = "white",
                          random_seed: int | None = None) -> np.ndarray:
    """Add noise at a target SNR (dB) to selected channels.

    Parity: reference data_surrogation.py:69-148.
    """
    rng = np.random.default_rng(random_seed)
    arr = input_array.copy()
    if arr.ndim == 1:
        arr = arr[:, None]
    n_ch = arr.shape[1 - axis]
    if not all(0 <= ch < n_ch for ch in channels):
        raise ValueError(f"Channel indices must be in range [0, {n_ch - 1}]")
    for ch in channels:
        sig = arr[:, ch] if axis == 0 else arr[ch, :]
        signal_power = np.mean(sig ** 2)
        noise_rms = np.sqrt(signal_power / 10 ** (noise_db / 10))
        noise = generate_noise(sig.shape, noise_type, noise_rms, rng)
        if axis == 0:
            arr[:, ch] = sig + noise
        else:
            arr[ch, :] = sig + noise
    return arr


# --------------------------------------------------------------------------
# FFT phase-randomised surrogates
# --------------------------------------------------------------------------
def draw_chunk_phases(generator: torch.Generator, n_surrogates: int,
                      n_freqs: int, n_channels: int, device
                      ) -> torch.Tensor:
    """(n_surrogates, n_freqs, n_channels) phases, uniform on [0, 2π),
    drawn on ``device`` from ``generator`` (which must live there)."""
    u = torch.rand((n_surrogates, n_freqs, n_channels), generator=generator,
                   dtype=torch.float32, device=device)
    return u * (2 * np.pi)


def rotate_phases(xf: torch.Tensor, n: int, phases: torch.Tensor
                  ) -> torch.Tensor:
    """Surrogates from the rFFT ``xf`` (F, C) of a length-``n`` signal and
    ``phases`` (S, F, C) → (S, n, C).  DC, and Nyquist when ``n`` is even,
    stay unrotated so each surrogate is real."""
    n_freqs = xf.shape[0]
    mask = torch.ones(n_freqs, dtype=torch.bool, device=xf.device)
    mask[0] = False
    if n % 2 == 0:
        mask[-1] = False
    mask = mask[None, :, None]
    rot = torch.complex(torch.where(mask, torch.cos(phases), 1.0),
                        torch.where(mask, torch.sin(phases), 0.0))
    return torch.fft.irfft(xf[None] * rot, n=n, dim=1)


def phase_randomize(generator: torch.Generator, x: torch.Tensor,
                    n_surrogates: int) -> torch.Tensor:
    """FFT phase-randomised surrogates of ``x`` (n_samples, n_channels).

    Preserves the amplitude spectrum (hence PSD and autocorrelation)
    while destroying cross-signal phase relationships; each channel gets
    independent phases.  Returns (n_surrogates, n_samples, n_channels).
    """
    xf = torch.fft.rfft(x, dim=0)
    phases = draw_chunk_phases(generator, n_surrogates, xf.shape[0],
                               x.shape[1], x.device)
    return rotate_phases(xf, x.shape[0], phases)


# --------------------------------------------------------------------------
# the null of the window-averaged MSC spectrum
# --------------------------------------------------------------------------
def _tapered_spectra(frames: torch.Tensor, tapers: torch.Tensor
                     ) -> torch.Tensor:
    """(..., W, S, C) frames × (K, S) tapers → (..., W, K, F, C)."""
    return torch.fft.rfft(frames[..., None, :, :] * tapers[:, :, None],
                          dim=-2)


def _msc_from_spectra(E: torch.Tensor, M: torch.Tensor, inv_fs_n: float
                      ) -> torch.Tensor:
    """Window-averaged MSC from tapered spectra: E (W, K, F, E) and M
    (..., W, K, F, M) → (..., F, E, M), as ``surrogate.py:243-255``."""
    K = E.shape[-3]
    pe = ((E.real ** 2 + E.imag ** 2) * inv_fs_n).sum(dim=-3) / K
    pm = ((M.real ** 2 + M.imag ** 2) * inv_fs_n).sum(dim=-3) / K
    cs = (torch.conj(E)[..., :, None] * M[..., None, :] * inv_fs_n
          ).sum(dim=-4) / K
    num = cs.real ** 2 + cs.imag ** 2
    den = torch.clamp_min(pe[..., :, None] * pm[..., None, :], _F32_TINY)
    coh = torch.clamp(num / den, 0.0, 1.0)           # (..., W, F, E, M)
    return coh.mean(dim=-4)


def _msc_spectrum_mean(eeg_frames: torch.Tensor, emg_frames: torch.Tensor,
                       tapers: torch.Tensor, inv_fs_n: float
                       ) -> torch.Tensor:
    """Window-averaged MSC spectrum: (W,S,E),(W,S,M) → (F, E, M)."""
    return _msc_from_spectra(_tapered_spectra(eeg_frames, tapers),
                             _tapered_spectra(emg_frames, tapers), inv_fs_n)


def _hist_accumulate(spectra: torch.Tensor, hist: torch.Tensor,
                     n_bins: int = N_BINS) -> torch.Tensor:
    """Add (S, F, E, M) coherences to the int32 per-cell histogram
    ``hist`` (F·E·M·n_bins), in place: bin ``clip(int(c·n_bins), 0,
    n_bins − 1)`` of cell (f, e, m).  Inputs are finite (coherence is
    clipped to [0, 1])."""
    idx = torch.clamp((spectra * n_bins).to(torch.int32), 0, n_bins - 1)
    n_cells = spectra[0].numel()
    cell = torch.arange(n_cells, dtype=torch.int64, device=spectra.device)
    flat = (cell.reshape(spectra.shape[1:])[None] * n_bins + idx).reshape(-1)
    ones = torch.ones(flat.shape, dtype=torch.int32, device=hist.device)
    return hist.scatter_add_(0, flat, ones)


def _auto_vmap_width(n_windows: int, window_samples: int, K: int,
                     n_eeg: int, n_emg: int, chunk: int,
                     budget_bytes: float = 2.5e9) -> int:
    """Surrogates per batch, bounding the transient device memory of
    the framed EMG, its taper spectra and the MSC grid of each."""
    n_freqs = window_samples // 2 + 1
    per_surr = n_windows * (window_samples * n_emg * 4
                            + K * n_freqs * (n_eeg + n_emg) * 8
                            + n_freqs * n_eeg * n_emg * 4)
    return int(max(1, min(chunk, budget_bytes // max(per_surr, 1))))


def _null_freq_mask(freqs: np.ndarray, window_samples: int,
                    band: tuple[float, float] | None) -> np.ndarray:
    """Frequency mask for the null max statistic.

    DC — and Nyquist when the window length is even — are ALWAYS
    excluded BY INDEX, matching :func:`rotate_phases`'s unrotated bins:
    a float comparison against fs/2 misses the Nyquist bin for many
    sampling rates (rfftfreq rounding puts it strictly below fs/2, e.g.
    fs=93 with a 0.5-s window).  ``band`` optionally restricts further.
    """
    mask = np.ones(len(freqs), dtype=bool)
    mask[0] = False
    if window_samples % 2 == 0:
        mask[-1] = False
    if band is not None:
        mask &= (freqs >= band[0]) & (freqs <= band[1])
    if not mask.any():
        raise ValueError(f"band {band} selects no valid frequencies")
    return mask


def _surrogate_chunk(phases, emg_f, eeg_spec, frame_idx, tapers, inv_fs_n,
                     n_samples, width) -> torch.Tensor:
    """One chunk of surrogates → (chunk, F, E, M) window-averaged MSC,
    ``width`` surrogates at a time.  ``frame_idx`` (W, S) indexes each
    window's samples."""
    out = []
    for s0 in range(0, phases.shape[0], width):
        surr = rotate_phases(emg_f, n_samples, phases[s0:s0 + width])
        out.append(_msc_from_spectra(
            eeg_spec, _tapered_spectra(surr[:, frame_idx], tapers),
            inv_fs_n))
    return torch.cat(out)


def msc_phase_randomized_null(
        eeg,
        emg,
        sampling_freq: float,
        n_surrogates: int = 10_000,
        nw: float = 3,
        window_length_sec: float = 1.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        band: tuple[float, float] | None = None,
        quantiles=(0.95, 0.99),
        surrogate_chunk: int = 64,
        seed: int = 0,
        max_stat_only: bool = False,
        mesh=None,
        device=None,
) -> dict:
    """Phase-randomised coherence null thresholds.

    Same arguments (plus ``device``), chunking and result dictionary as
    ``mba_tpu.ops.surrogate.msc_phase_randomized_null``; arrays come
    back as numpy.  For each surrogate the EMG signals' Fourier phases
    are randomised (EEG kept fixed), the window-averaged MSC spectrum is
    computed, and per-cell and in-band-max null statistics accumulate:

    - every chunk is full size; the surplus surrogates of the last chunk
      enter the histogram, whose CDF divides by the true total;
    - the max statistic is taken over ``band`` and never over DC or
      Nyquist (:func:`_null_freq_mask`);
    - ``null_quantiles[q]`` is ``(first bin with cdf ≥ q + 1) / 1024``
      per (F, E, M) cell, or the max statistic's quantile with
      ``max_stat_only``;
    - ``p_fwe = (1 + #{max_stat ≥ observed_max}) / (1 + n_surrogates)``.

    Each chunk's phases come from :func:`draw_chunk_phases` on a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  The EEG
    spectra do not change between surrogates and are computed once.
    ``device``: default the device of a tensor input, else the CPU.
    ``mesh`` (surrogates sharded over cards) is not ported: ROADMAP A10.
    """
    if mesh is not None:
        raise NotImplementedError(
            "msc_phase_randomized_null(mesh=...) (surrogates sharded over "
            "cards) is not ported; see ROADMAP A10")
    device = resolve_device(device, eeg, emg)
    t_up0 = time.perf_counter()
    eeg_t = to_device(eeg, device).to(torch.float32)
    emg_t = to_device(emg, device).to(torch.float32)
    if eeg_t.ndim == 1:          # promote single channels like multitaper_psd
        eeg_t = eeg_t[:, None]
    if emg_t.ndim == 1:
        emg_t = emg_t[:, None]
    synchronize(device)
    t_upload = time.perf_counter() - t_up0
    n_samples, n_eeg = eeg_t.shape
    n_emg = emg_t.shape[1]
    window_samples = int(window_length_sec * sampling_freq)
    hop = int(window_samples * (1 - overlap_frac))
    tapers_np = filtered_tapers(window_samples, nw,
                                taper_eigenvalue_threshold)
    tapers = torch.as_tensor(tapers_np, dtype=torch.float32, device=device)
    starts, _ = window_grid(n_samples, window_samples, hop, sampling_freq,
                            convention="cmc")
    inv_fs_n = float(np.float32(1.0 / (sampling_freq * window_samples)))
    freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)
    fmask_np = _null_freq_mask(freqs, window_samples, band)
    fmask = torch.as_tensor(fmask_np, dtype=torch.float32, device=device)

    t_ob0 = time.perf_counter()
    frame_idx = (torch.as_tensor(starts, device=device)[:, None]
                 + torch.arange(window_samples, device=device))
    eeg_spec = _tapered_spectra(eeg_t[frame_idx], tapers)
    observed = _msc_from_spectra(
        eeg_spec, _tapered_spectra(emg_t[frame_idx], tapers),
        inv_fs_n).cpu().numpy()
    t_observed = time.perf_counter() - t_ob0

    t_null0 = time.perf_counter()
    generator = torch.Generator(device).manual_seed(seed)
    emg_f = torch.fft.rfft(emg_t, dim=0)
    n_freqs = len(freqs)
    n_cells = n_freqs * n_eeg * n_emg
    hist = None if max_stat_only else torch.zeros(
        n_cells * N_BINS, dtype=torch.int32, device=device)
    chunk = int(min(surrogate_chunk, n_surrogates))
    width = _auto_vmap_width(len(starts), window_samples, tapers.shape[0],
                             n_eeg, n_emg, chunk)
    max_stats = []
    n_hist_total = 0
    done = 0
    while done < n_surrogates:
        phases = draw_chunk_phases(generator, chunk, emg_f.shape[0], n_emg,
                                   device)
        spectra = _surrogate_chunk(phases, emg_f, eeg_spec, frame_idx,
                                   tapers, inv_fs_n, n_samples, width)
        take = min(chunk, n_surrogates - done)
        ms = (spectra * fmask[None, :, None, None]).amax(dim=(1, 2, 3))
        max_stats.append(ms[:take])
        if hist is not None:
            _hist_accumulate(spectra, hist)
            n_hist_total += chunk
        done += take

    max_stat = torch.cat(max_stats).cpu().numpy()
    t_null = time.perf_counter() - t_null0
    observed_max = float(observed[fmask_np].max())
    p_fwe = float((1.0 + (max_stat >= observed_max).sum())
                  / (1.0 + len(max_stat)))
    result = {"max_stat": max_stat, "observed": observed, "freqs": freqs,
              "observed_max": observed_max, "p_fwe": p_fwe,
              "timings": {"upload_sec": round(t_upload, 3),
                          "observed_sec": round(t_observed, 3),
                          "null_sec": round(t_null, 3),
                          "upload_bytes": int(n_samples * (n_eeg + n_emg)
                                              * 4)},
              "null_quantiles": {}}
    if hist is not None:
        hist = hist.reshape(n_freqs, n_eeg, n_emg, N_BINS)
        cdf = (hist.cumsum(dim=-1).to(torch.float32)
               / torch.tensor(n_hist_total, dtype=torch.float32,
                              device=device))
    for q in quantiles:
        if max_stat_only:
            result["null_quantiles"][q] = float(np.quantile(max_stat, q))
        else:
            qidx = (cdf < torch.tensor(q, dtype=torch.float32,
                                       device=device)).sum(dim=-1)
            result["null_quantiles"][q] = ((qidx + 1).to(torch.float32)
                                           / N_BINS).cpu().numpy()
    return result
