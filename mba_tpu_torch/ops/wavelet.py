"""Discrete wavelet transform and Donoho universal-threshold denoising
(port of ``mba_tpu/ops/wavelet.py``).

``wavedec``/``waverec`` with the db4/sym5/coif1/haar filter banks and
symmetric boundary extension, σ = median|cD₁|/0.6745 over all channels,
Donoho's threshold σ·√(2·ln N), soft or hard shrinkage of every detail
level, the approximation kept.  Analysis runs along axis 0 (time) per
channel.

The decimating correlations are ``torch.nn.functional.conv1d`` (stride
2), where the JAX package uses XLA's convolution; the port's precision
policy keeps cuDNN out of TF32, so they stay float32 on the card.  The
global median averages the two middle values of an even count, as
``jnp.median`` does: ``torch.median`` would return the lower one, and
``torch.quantile`` refuses more than 2^24 values, while the finest level
of a study-scale recording (1 698 s × 64 channels at 2048 Hz) holds about
111 M.  So the median is read from a sort.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mba_tpu_torch._device import entry_device, to_device

# orthonormal decomposition low-pass filters (standard published constants)
_DEC_LO = {
    'db4': np.array([
        -0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
        -0.18703481171888114, -0.02798376941698385, 0.6308807679295904,
        0.7148465705525415, 0.23037781330885523]),
    'sym5': np.array([
        0.027333068345077982, 0.029519490925774643, -0.039134249302383094,
        0.1993975339773936, 0.7234076904024206, 0.6339789634582119,
        0.01660210576452232, -0.17532808990845047, -0.021101834024758855,
        0.019538882735286728]),
    'coif1': np.array([
        -0.01565572813546454, -0.0727326195128539, 0.38486484686420286,
        0.8525720202122554, 0.33789766245780922, -0.0727326195128539]),
    'haar': np.array([0.7071067811865476, 0.7071067811865476]),
}


def wavelet_filters(wavelet: str):
    """(dec_lo, dec_hi, rec_lo, rec_hi) for a named wavelet."""
    if wavelet not in _DEC_LO:
        raise ValueError(f"Unknown wavelet '{wavelet}'. "
                         f"Available: {sorted(_DEC_LO)}")
    dec_lo = _DEC_LO[wavelet]
    L = len(dec_lo)
    dec_hi = np.array([(-1) ** k * dec_lo[L - 1 - k] for k in range(L)])
    return dec_lo, dec_hi, dec_lo[::-1].copy(), dec_hi[::-1].copy()


def dwt_max_level(data_len: int, filter_len: int) -> int:
    """Maximum useful decomposition level (pywt semantics)."""
    if data_len < filter_len:
        return 0
    return int(math.floor(math.log2(data_len / (filter_len - 1))))


def _sympad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Symmetric (half-point) extension along axis 0."""
    n = x.shape[0]
    return torch.cat([x[:p].flip(0), x, x[max(n - p, 0):].flip(0)], dim=0)


def _filter(filt: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(filt), dtype=like.dtype,
                           device=like.device)[None, None, :]


def _conv_down2(x: torch.Tensor, filt: np.ndarray) -> torch.Tensor:
    """Symmetric-extend, correlate with ``filt``, downsample by 2: the
    valid correlation of the (L−1)-padded extension sampled at even
    indices, the first ``(n + L − 1)//2`` coefficients.
    x: (n, C) → ((n + L − 1)//2, C)"""
    n = x.shape[0]
    L = len(filt)
    xe = _sympad(x, L - 1)[1:]    # correlation phase: offsets 1, 3, 5, ...
    out_len = (n + L - 1) // 2
    # conv1d correlates (no kernel flip), as XLA's conv does
    y = F.conv1d(xe.T[:, None, :], _filter(filt, x), stride=2)[:, 0, :]
    return y[:, :out_len].T


def _upconv(c: torch.Tensor, filt: np.ndarray) -> torch.Tensor:
    """Upsample by 2 (zeros interleaved) and full-convolve with ``filt``.
    c: (m, C) → (2m − 1 + L − 1, C)"""
    m, ch = c.shape
    up = c.new_zeros((ch, 2 * m - 1))
    up[:, ::2] = c.T
    L = len(filt)
    y = F.conv1d(F.pad(up, (L - 1, L - 1))[:, None, :],
                 _filter(filt[::-1], c))[:, 0, :]   # conv = corr w/ reversed
    return y.T


def _as_signal(x, device) -> torch.Tensor:
    return to_device(x, entry_device(device, x))


def dwt(x, wavelet: str = 'db4', device=None):
    """Single-level DWT along axis 0.  x: (n,) or (n, C) → (cA, cD)."""
    x = _as_signal(x, device)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    dec_lo, dec_hi, _, _ = wavelet_filters(wavelet)
    ca = _conv_down2(x, dec_lo)
    cd = _conv_down2(x, dec_hi)
    if squeeze:
        return ca[:, 0], cd[:, 0]
    return ca, cd


def idwt(ca, cd, wavelet: str, out_len: int, device=None):
    """Inverse single-level DWT; crops to ``out_len``."""
    ca = _as_signal(ca, device)
    cd = to_device(cd, ca.device)
    squeeze = ca.ndim == 1
    if squeeze:
        ca, cd = ca[:, None], cd[:, None]
    dec_lo, _, rec_lo, rec_hi = wavelet_filters(wavelet)
    L = len(dec_lo)
    y = _upconv(ca, rec_lo[::-1]) + _upconv(cd, rec_hi[::-1])
    y = y[L - 2:L - 2 + out_len]
    return y[:, 0] if squeeze else y


def wavedec(x, wavelet: str = 'db4', level: int | None = None,
            device=None):
    """Multi-level decomposition → [cA_n, cD_n, ..., cD_1] (pywt order)."""
    x = _as_signal(x, device)
    n = x.shape[0]
    L = len(_DEC_LO[wavelet])
    if level is None:
        level = dwt_max_level(n, L)
    coeffs = []
    ca = x
    for _ in range(max(level, 0)):
        ca, cd = dwt(ca, wavelet)
        coeffs.append(cd)
    coeffs.append(ca)
    return coeffs[::-1]


def waverec(coeffs, wavelet: str = 'db4', lengths: list[int] | None = None,
            device=None):
    """Reconstruct from wavedec coefficients.

    ``lengths``: original per-level input lengths (finest last).  If omitted
    they are inferred from the detail-coefficient lengths (exact when every
    level length was even; pywt resolves the same ambiguity by trimming).
    """
    ca = _as_signal(coeffs[0], device)
    L = len(_DEC_LO[wavelet])
    for i, cd in enumerate(coeffs[1:]):
        cd = to_device(cd, ca.device)
        if lengths is not None:
            out_len = lengths[i]
        else:
            out_len = 2 * cd.shape[0] - L + 2
        if ca.shape[0] > cd.shape[0]:
            ca = ca[:cd.shape[0]]
        ca = idwt(ca, cd, wavelet, out_len)
    return ca


def wavedec_lengths(n: int, wavelet: str, level: int) -> list[int]:
    """Per-level input lengths for exact waverec (finest last)."""
    L = len(_DEC_LO[wavelet])
    lens = []
    cur = n
    for _ in range(level):
        lens.append(cur)
        cur = (cur + L - 1) // 2
    return lens[::-1]


def global_median(x: torch.Tensor) -> torch.Tensor:
    """Median of all of ``x``'s values as ``jnp.median`` takes it: the
    mean of the two middle values for an even count (0-d tensor)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return (v[(n - 1) // 2] + v[n // 2]) / 2


def wavelet_denoise(x, wavelet: str = 'db4', level: int | None = None,
                    mode: str = 'soft', device=None) -> torch.Tensor:
    """Wavelet shrinkage denoising (reference preprocessing.py:811-873).

    - σ from the finest detail level: median(|cD₁|)/0.6745 over all
      channels;
    - universal threshold σ·√(2·ln len(cD₁));
    - soft/hard thresholding of ALL detail levels, approximation kept.
    Returns a float32 tensor on the device.
    """
    if mode not in ('soft', 'hard'):
        raise ValueError(f"unknown threshold mode: {mode}")
    x = _as_signal(x, device).to(torch.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n = x.shape[0]
    L = len(_DEC_LO[wavelet])
    if level is None:
        level = dwt_max_level(n, L)
    lengths = wavedec_lengths(n, wavelet, level)

    coeffs = wavedec(x, wavelet, level)
    finest = coeffs[-1]
    sigma = global_median(finest.abs()) / np.float32(0.6745)
    log_n = np.log(np.float32(finest.shape[0]))
    uthresh = sigma * np.sqrt(np.float32(2.0) * log_n)

    def shrink(c):
        if mode == 'soft':
            return torch.sign(c) * torch.clamp_min(c.abs() - uthresh, 0.0)
        return torch.where(c.abs() > uthresh, c, torch.zeros_like(c))

    denoised = [coeffs[0]] + [shrink(c) for c in coeffs[1:]]
    out = waverec(denoised, wavelet, lengths=lengths)
    return out[:, 0] if squeeze else out
