"""Multitaper and Welch spectral estimation (port of
``mba_tpu/ops/spectral.py``).

The conventions are the JAX package's, which copies the reference
(signal_features.py:80-454, 2069-2185):

- ``multitaper_psd``: k = 2·nw − 1 DPSS tapers (no eigenvalue filter),
  the ``"psd"`` window grid (exclusive stop), per taper a constant
  detrend, |rfft|²/(fs·N) with scipy's one-sided doubling, the mean over
  tapers, optional ``log10(|p| + 1e-10)``; (windows, freqs, channels);
- ``welch_psd``: scipy's defaults (periodic Hann, 50 % overlap,
  constant detrend);
- ``spectral_snr`` and ``amplitude_spectrum``.

Windows are processed in chunks of ``window_chunk``; each chunk is one
gather, a taper broadcast and one ``torch.fft.rfft`` (cuFFT on the
card).  The JAX package's matmul rFFT (``fftmm.rfft_prod``) is a TPU
workaround and is not ported.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from mba_tpu_torch._device import resolve_device, to_device
from mba_tpu_torch.ops.dpss import dpss_windows
from mba_tpu_torch.ops.framing import frame_signal, window_grid


def _onesided_scale(n_freqs: int, window_samples: int) -> np.ndarray:
    """Periodogram one-sided doubling: x2 everywhere except DC (and Nyquist
    when the window length is even), matching scipy.signal.periodogram."""
    scale = np.full(n_freqs, 2.0, dtype=np.float32)
    scale[0] = 1.0
    if window_samples % 2 == 0:
        scale[-1] = 1.0
    return scale


def _mt_psd_kernel(frames: torch.Tensor, tapers: torch.Tensor,
                   onesided: torch.Tensor, inv_fs_n: float,
                   apply_log_scale: bool) -> torch.Tensor:
    """(chunk, S, C) frames → (chunk, F, C) taper-averaged PSD."""
    tapered = frames[:, None, :, :] * tapers[None, :, :, None]
    # scipy.signal.periodogram detrends (constant) by default and the
    # reference does not override it (signal_features.py:419)
    tapered = tapered - tapered.mean(dim=2, keepdim=True)
    fft = torch.fft.rfft(tapered, dim=2)
    pxx = (fft.real ** 2 + fft.imag ** 2) * inv_fs_n
    pxx = pxx * onesided[None, None, :, None]
    pxx = pxx.mean(dim=1)
    if apply_log_scale:
        pxx = torch.log10(torch.abs(pxx) + 1e-10)
    return pxx


def _signal_columns(input_array, axis, device) -> torch.Tensor:
    """Signal → float32 (n_samples, n_channels) tensor on ``device``.
    1-D input becomes one column; 2-D input needs ``axis``.  Integer ADC
    counts travel as they are and are cast on the device."""
    x = to_device(input_array, device).to(torch.float32)
    if x.ndim == 1:
        return x[:, None]
    if axis is None:
        raise AttributeError("For 2D signal arrays, axis needs to be defined!")
    return x.T if axis == 1 else x


def multitaper_psd(input_array,
                   sampling_freq: float,
                   nw: float = 3,
                   window_length_sec: float = 1.0,
                   overlap_frac: float = 0.5,
                   axis: Literal[0, 1] | None = None,
                   apply_log_scale: bool = True,
                   window_chunk: int = 128,
                   device_output: bool = False,
                   device=None):
    """Sliding-window DPSS multitaper PSD.

    Returns ``(spectrograms, time_centers, freqs)`` with
    ``spectrograms.shape == (n_windows, n_freqs, n_channels)``, as
    ``mba_tpu.ops.spectral.multitaper_psd``.

    ``device``: where to compute; default the device of a tensor input,
    else the CPU.  ``device_output=True`` returns the spectrogram as a
    float32 tensor on that device (time_centers and freqs stay numpy),
    for consumers that reduce it there (:func:`~mba_tpu_torch.pipeline.
    signal_features.band_aggregate_spectrogram`).
    """
    device = resolve_device(device, input_array)
    x = _signal_columns(input_array, axis, device)
    n_samples = x.shape[0]
    window_samples = int(window_length_sec * sampling_freq)
    hop_samples = int(window_samples * (1 - overlap_frac))
    k = int(2 * nw - 1)

    tapers = torch.as_tensor(
        np.ascontiguousarray(dpss_windows(window_samples, nw, k)),
        dtype=torch.float32, device=device)
    starts, time_centers = window_grid(n_samples, window_samples, hop_samples,
                                       sampling_freq, convention="psd")
    freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)
    onesided = torch.as_tensor(_onesided_scale(len(freqs), window_samples),
                               device=device)
    inv_fs_n = float(np.float32(1.0 / (sampling_freq * window_samples)))

    spectrograms = torch.empty((len(starts), len(freqs), x.shape[1]),
                               dtype=torch.float32, device=device)
    chunk = max(1, int(window_chunk))
    for c0 in range(0, len(starts), chunk):
        frames = frame_signal(x, starts[c0:c0 + chunk], window_samples)
        spectrograms[c0:c0 + chunk] = _mt_psd_kernel(
            frames, tapers, onesided, inv_fs_n, apply_log_scale)
    if device_output:
        return spectrograms, time_centers, freqs
    return spectrograms.cpu().numpy(), time_centers, freqs


def _welch_kernel(x: torch.Tensor, win: torch.Tensor, nperseg: int,
                  noverlap: int, inv_fs_wsq: float,
                  onesided: torch.Tensor) -> torch.Tensor:
    hop = nperseg - noverlap
    n_seg = (x.shape[0] - nperseg) // hop + 1
    starts = np.arange(n_seg, dtype=np.int64) * hop
    segs = frame_signal(x, starts, nperseg)          # (n_seg, nperseg, C)
    segs = segs - segs.mean(dim=1, keepdim=True)     # detrend='constant'
    fft = torch.fft.rfft(segs * win[None, :, None], dim=1)
    pxx = (fft.real ** 2 + fft.imag ** 2) * inv_fs_wsq
    pxx = pxx * onesided[None, :, None]
    return pxx.mean(dim=0)                           # (F, C)


def welch_psd(input_array, sampling_freq: float, nperseg: int,
              axis: Literal[0, 1] = 0, device=None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Welch PSD with scipy defaults (hann, 50 % overlap, constant detrend).

    Returns (freqs, psd) with psd shaped (n_freqs, n_channels), numpy.
    """
    device = resolve_device(device, input_array)
    x = _signal_columns(input_array, axis, device)
    nperseg = int(min(nperseg, x.shape[0]))
    noverlap = nperseg // 2

    # periodic hann window, as scipy.signal.get_window('hann', n)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nperseg) / nperseg)
    win = win.astype(np.float32)
    inv_fs_wsq = float(np.float32(1.0 / (sampling_freq * (win ** 2).sum())))
    onesided = torch.as_tensor(_onesided_scale(nperseg // 2 + 1, nperseg),
                               device=device)
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / sampling_freq)

    psd = _welch_kernel(x, torch.as_tensor(win, device=device), nperseg,
                        noverlap, inv_fs_wsq, onesided)
    return freqs, psd.cpu().numpy()


def spectral_snr(input_array, sampling_freq: float,
                 target_freq: float = 21.5, freq_window: float = 8.5,
                 target_band_ratio: float = 0.5,
                 axis: Literal[0, 1] = 0,
                 return_psd: bool = False, device=None):
    """Spectral SNR (dB) at a target frequency using Welch 4-s segments.

    Parity: reference signal_features.py:2069-2130 (target band = mean power
    in ±freq_window·ratio around target; noise band = ±freq_window).
    """
    freqs, psd = welch_psd(input_array, sampling_freq,
                           nperseg=int(sampling_freq * 4), axis=axis,
                           device=device)
    target_freq_window = freq_window * target_band_ratio
    target_band = ((freqs < target_freq + target_freq_window)
                   & (freqs > target_freq - target_freq_window))
    noise_band = ((freqs >= target_freq - freq_window)
                  & (freqs <= target_freq + freq_window))
    snr_linear = psd[target_band].mean() / psd[noise_band].mean()
    snr_db = float(10 * np.log10(snr_linear))
    return snr_db if not return_psd else (snr_db, freqs, psd)


def amplitude_spectrum(input_array, sampling_freq: float,
                       axis: Literal[0, 1] = 0, device=None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Positive-frequency DFT amplitude, normalised by 2/n.

    Parity: reference signal_features.py:2133-2185.
    """
    device = resolve_device(device, input_array)
    x = to_device(input_array, device).to(torch.float32)
    if x.ndim == 1:
        x = x[:, None]
        axis = 0
    n_samples = x.shape[axis]
    fft = torch.fft.fft(x, dim=axis)
    freqs = np.fft.fftfreq(n_samples, d=1.0 / sampling_freq)
    pos = torch.as_tensor(np.flatnonzero(freqs >= 0), device=device)
    fft_pos = fft.index_select(axis, pos)
    amp = (torch.abs(fft_pos) * (2.0 / n_samples)).cpu().numpy()
    return amp, freqs[freqs >= 0]
