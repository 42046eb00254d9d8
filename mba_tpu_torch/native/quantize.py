"""Per-channel peak quantizers of the host uploads (port of
``mba_tpu/native/build.py:70-108``).

The JAX package quantizes with its native SIMD shim (``quantshim.cpp``)
when ``g++`` builds it, else with a numpy form that is bit-identical
(both round half to even).  The port keeps the numpy form only: it needs
no build, and the shim's speed was bought for a one-core host.

Layout ``(..., n_samples, n_channels)``: one peak per (leading dims,
channel), over the sample axis −2; ``round(x · full / peak)`` with
``full`` 32767 (int16) or 127 (int8) and the peak floored at 1e-30.
The per-channel scale cancels in coherence, so the only error is the
rounding of the signal (≤ 2^-16 of each channel's peak at int16, 2^-8 at
int8, half a step).
"""
from __future__ import annotations

import numpy as np


def _quantize_per_channel(x, bits: int) -> np.ndarray:
    full = 32767.0 if bits == 16 else 127.0
    dtype = np.int16 if bits == 16 else np.int8
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim < 2:
        raise ValueError("expected (..., n_samples, n_channels)")
    peak = np.maximum(np.abs(x).max(axis=-2, keepdims=True),
                      np.float32(1e-30))
    return np.round(x * (full / peak)).astype(dtype)


def quantize_int16_per_channel(x) -> np.ndarray:
    """(..., n_samples, n_channels) float32 → int16, per-(leading dims,
    channel) peak scaling."""
    return _quantize_per_channel(x, 16)


def quantize_int8_per_channel(x) -> np.ndarray:
    """The int8 form: a quarter of float32's bytes, rounding error ≤ 2^-8
    of each channel's peak."""
    return _quantize_per_channel(x, 8)
