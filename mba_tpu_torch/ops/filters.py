"""Zero-phase FIR band-pass and notch filtering (port of
``mba_tpu/ops/filters.py``).

The FIR design is the JAX package's, copied: MNE's 'firwin' rules (auto
transition bandwidths, hamming length 3.3/trans·fs forced odd, −6 dB
points at the transition midpoints) and the harmonic notch bank, in
float64 numpy with scipy.  Application is FFT overlap-save along axis 0
on ``torch.fft`` (cuFFT on the card) with the same FFT size rule (a
power of two, at least ``max(4·taps, chunk)``), the same chunks and the
kernel spectrum computed in float64 and cast to float32, so the rounding
follows the JAX package's.  All chunks' overlapping segments are built at
once (``unfold``) and go through one batched rFFT: the study-scale EEG
band-pass (67 585 taps at 2048 Hz, 1 698 s × 64 channels) is 8 segments
of 524 288 points per channel, about 1 GB of float32.

The JAX kernels are plain XLA (no Pallas), so this module is plain
PyTorch.
"""
from __future__ import annotations

import numpy as np
import scipy.signal
import torch

from mba_tpu_torch._device import entry_device, to_device


# --------------------------------------------------------------------------
# Host-side FIR design (copied from the JAX package)
# --------------------------------------------------------------------------
def _auto_trans(edge_freq: float, other_limit: float) -> float:
    return min(max(edge_freq * 0.25, 2.0), other_limit)


def design_bandpass_fir(sampling_freq: float,
                        l_freq: float | None,
                        h_freq: float | None,
                        filter_length: int | None = None) -> np.ndarray:
    """Hamming-window FIR band-pass following MNE's 'firwin' auto rules."""
    nyq = sampling_freq / 2.0
    if h_freq is not None and h_freq >= nyq:
        h_freq = None  # low-pass edge at/above Nyquist → no high cut
    trans = []
    cutoffs = []
    pass_zero = True
    if l_freq is not None and l_freq > 0:
        l_trans = _auto_trans(l_freq, l_freq)
        trans.append(l_trans)
        cutoffs.append(l_freq - l_trans / 2)
        pass_zero = False
    if h_freq is not None and h_freq < nyq:
        h_trans = _auto_trans(h_freq, nyq - h_freq)
        trans.append(h_trans)
        cutoffs.append(h_freq + h_trans / 2)
    if not cutoffs:
        return np.array([1.0])
    if filter_length is None:
        filter_length = int(round(3.3 / min(trans) * sampling_freq))
    filter_length += (filter_length % 2 == 0)  # force odd (type-I FIR)
    if len(cutoffs) == 2:
        h = scipy.signal.firwin(filter_length, cutoffs, window='hamming',
                                pass_zero=False, fs=sampling_freq)
    elif pass_zero:  # lowpass
        h = scipy.signal.firwin(filter_length, cutoffs, window='hamming',
                                pass_zero=True, fs=sampling_freq)
    else:  # highpass
        h = scipy.signal.firwin(filter_length, cutoffs, window='hamming',
                                pass_zero=False, fs=sampling_freq)
    return h.astype(np.float64)


def design_notch_fir(sampling_freq: float, freqs,
                     notch_widths=None,
                     trans_bandwidth: float = 1.0) -> np.ndarray:
    """Multi-band-stop FIR (the harmonic notch bank): MNE's notch
    defaults, width freq/200 and 1 Hz transitions."""
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    nyq = sampling_freq / 2.0
    in_range = freqs < nyq - trans_bandwidth
    if not in_range.all():
        dropped = freqs[~in_range]
        print(f"[notch design] dropping frequencies at/above Nyquist "
              f"({nyq:g} Hz): {dropped.tolist()}")
    freqs = freqs[in_range]
    if freqs.size == 0:
        return np.array([1.0])
    if notch_widths is None:
        notch_widths = freqs / 200.0
    else:
        notch_widths = np.broadcast_to(
            np.atleast_1d(np.asarray(notch_widths, float)),
            freqs.shape).copy()
    filter_length = int(round(3.3 / trans_bandwidth * sampling_freq))
    filter_length += (filter_length % 2 == 0)
    cutoffs = []
    for f, w in zip(freqs, notch_widths):
        cutoffs.extend([f - w / 2 - trans_bandwidth / 2,
                        f + w / 2 + trans_bandwidth / 2])
    h = scipy.signal.firwin(filter_length, cutoffs, window='hamming',
                            pass_zero=True, fs=sampling_freq)
    return h.astype(np.float64)


# --------------------------------------------------------------------------
# Zero-phase application (overlap-save)
# --------------------------------------------------------------------------
def _reflect_limited_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """MNE 'reflect_limited' along axis 0: 2·edge − reflected interior,
    zeros beyond where ``pad`` exceeds n − 1."""
    n = x.shape[0]
    k = min(pad, n - 1)
    left = 2 * x[0:1] - x[1:k + 1].flip(0)
    right = 2 * x[-1:] - x[n - k - 1:n - 1].flip(0)
    parts = [left, x, right]
    if k < pad:
        zeros = x.new_zeros((pad - k,) + tuple(x.shape[1:]))
        parts = [zeros, left, x, right, zeros]
    return torch.cat(parts, dim=0)


def _overlap_save(x_padded: torch.Tensor, h_fft: torch.Tensor,
                  n_taps_m1: int, chunk: int, n_out: int) -> torch.Tensor:
    """FFT overlap-save convolution, valid part only.

    x_padded: (n_out + n_taps_m1, C), the signal with its left context;
    h_fft: (nfft // 2 + 1,) complex64.  Chunk i is the segment starting
    at i·chunk of length nfft = chunk + n_taps_m1; its last ``chunk``
    outputs are kept.  Returns (n_out, C).
    """
    nfft = chunk + n_taps_m1
    n_chunks = -(-n_out // chunk)
    total = n_chunks * chunk + n_taps_m1
    xt = x_padded.T                                          # (C, L)
    xt = torch.nn.functional.pad(xt, (0, total - xt.shape[1]))
    segs = xt.unfold(1, nfft, chunk)                         # (C, n_ch, nfft)
    y = torch.fft.irfft(torch.fft.rfft(segs, dim=-1) * h_fft, n=nfft,
                        dim=-1)
    y = y[..., n_taps_m1:].reshape(xt.shape[0], -1)[:, :n_out]
    return y.T.contiguous()


def _fft_size(n_taps: int, chunk: int) -> int:
    """Power-of-two FFT length, at least max(4·taps, chunk)."""
    return 1 << int(np.ceil(np.log2(max(4 * n_taps, chunk, 2))))


def fir_filter(x, h: np.ndarray, zero_phase: bool = True,
               chunk: int = 1 << 16, device=None) -> torch.Tensor:
    """Apply FIR kernel ``h`` along axis 0 of (n_samples, n_channels)
    (or (n_samples,)); float32 tensor on ``device``.

    ``zero_phase`` centres the symmetric kernel (single-pass linear-phase
    compensation, MNE phase='zero') with reflect_limited edge padding.
    ``device``: default the device of a tensor input, else the card.
    """
    device = entry_device(device, x)
    x = to_device(x, device).to(torch.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n = x.shape[0]
    n_taps = len(h)
    if n_taps == 1:
        out = x * float(h[0])
        return out[:, 0] if squeeze else out

    half = (n_taps - 1) // 2
    if zero_phase:
        xp = _reflect_limited_pad(x, half)
        if n_taps % 2 == 0:
            xp = torch.cat([xp, x.new_zeros((1,) + tuple(x.shape[1:]))])
    else:
        xp = torch.cat([x.new_zeros((n_taps - 1,) + tuple(x.shape[1:])), x])

    nfft = _fft_size(n_taps, chunk)
    chunk = nfft - (n_taps - 1)
    # overlap-save correlates with the reversed kernel: a convolution
    h_fft = np.fft.rfft(np.asarray(h)[::-1], n=nfft)
    h_fft = torch.complex(
        torch.as_tensor(h_fft.real.astype(np.float32), device=device),
        torch.as_tensor(h_fft.imag.astype(np.float32), device=device))
    out = _overlap_save(xp, h_fft, n_taps - 1, chunk, n)
    return out[:, 0] if squeeze else out


def bandpass_filter(x, sampling_freq: float, l_freq: float | None,
                    h_freq: float | None, **kwargs) -> torch.Tensor:
    """Zero-phase FIR band-pass (MNE-equivalent defaults)."""
    h = design_bandpass_fir(sampling_freq, l_freq, h_freq)
    return fir_filter(x, h, zero_phase=True, **kwargs)


def notch_filter(x, sampling_freq: float, freqs, notch_widths=None,
                 **kwargs) -> torch.Tensor:
    """Zero-phase harmonic notch bank."""
    h = design_notch_fir(sampling_freq, freqs, notch_widths)
    return fir_filter(x, h, zero_phase=True, **kwargs)
