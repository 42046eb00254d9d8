"""Quantized host↔device transfers (port of ``mba_tpu/utils/transfer.py``).

:func:`download_quantized` quantizes a float tensor affinely per lane on
its device (min/max over the leading axes, one scale and offset per
trailing lane), downloads the integer payload with the two float32
sidecars, and dequantizes on the host: half (int16) or a quarter (int8)
of float32's bytes, with at most half a step of error per lane.
:func:`upload_quantized` is the upload-side mirror: per-channel peak
quantization on the host (``native/quantize.py``), the integer payload
and the scales uploaded, the dequantize multiply on the device.
:func:`upload_counts` uploads integer ADC counts as they are and scales
them on the device, exactly.

The operations and their order are the JAX package's, so the integers
equal its own but where a float32 rounding lands a value on a tie of the
half-to-even rounding.  Each function takes ``device`` by the port's
rule (``_device.entry_device``): a tensor stays where it lies; numpy
input goes to the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import numpy as np
import torch

from mba_tpu_torch._device import entry_device, to_device
from mba_tpu_torch.native.quantize import (quantize_int8_per_channel,
                                           quantize_int16_per_channel)

_INT_INFO = {
    np.dtype(np.int16): (torch.int16, 65535.0),
    np.dtype(np.int8): (torch.int8, 255.0),
}
_F32_TINY = float(np.finfo(np.float32).tiny)


def _int_info(transfer_dtype):
    td = np.dtype(transfer_dtype)
    if td not in _INT_INFO:
        raise ValueError(f"transfer_dtype must be int16/int8/None, got {td}")
    return td, *_INT_INFO[td]


def quantize_lanes(x: torch.Tensor, int_dtype: torch.dtype, levels: float,
                   lane_ndim: int = 1):
    """Affine per-lane quantization over the leading axes
    (``_quantize_on_device``): statistics over all axes but the trailing
    ``lane_ndim``; returns (q, scale, lo), q of ``int_dtype``."""
    xf = x.to(torch.float32)
    reduce_dims = tuple(range(xf.ndim - lane_ndim))
    lo = xf.amin(dim=reduce_dims)
    hi = xf.amax(dim=reduce_dims)
    span = torch.clamp_min(hi - lo, _F32_TINY)
    # span / levels as XLA computes it: a multiply by the float32
    # reciprocal of the constant
    scale = span * float(np.float32(1.0 / levels))
    half = (levels + 1.0) / 2.0           # 32768 (int16) / 128 (int8)
    q = torch.round((xf - lo) / scale - half)     # half to even
    q = torch.clamp(q, -half, half - 1.0).to(int_dtype)
    return q, scale, lo


def download_quantized(x, transfer_dtype=np.int16, lane_ndim: int = 1,
                       device=None):
    """Download a float array as per-lane-quantized integers.

    Returns ``(host_f32, n_bytes_downloaded, max_abs_err_bound)``:
    ``host_f32`` the dequantized float32 numpy array of ``x``'s shape,
    ``n_bytes_downloaded`` the integer payload plus the scale and offset
    sidecars, ``max_abs_err_bound`` half a quantization step maxed over
    lanes.  ``lane_ndim`` trailing axes form the lanes (1: one scale per
    channel; ``x.ndim − 1``: per (freq, channel), reducing over windows
    only).  ``transfer_dtype=None`` is a plain float32 download.
    """
    device = entry_device(device, x)
    if transfer_dtype is None:
        host = to_device(x, device).to(torch.float32).cpu().numpy()
        return host, host.nbytes, 0.0
    _, int_dtype, levels = _int_info(transfer_dtype)
    ndim = x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)
    if lane_ndim < 1:
        raise ValueError(f"lane_ndim must be >= 1, got {lane_ndim}")
    if lane_ndim >= ndim:
        raise ValueError(
            f"lane_ndim={lane_ndim} must be < array ndim "
            f"{ndim} (at least one axis must reduce)")
    q, scale, lo = quantize_lanes(to_device(x, device), int_dtype, levels,
                                  lane_ndim)
    # one bulk integer download and two small vectors
    q_host = q.cpu().numpy()
    scale_host = scale.cpu().numpy()
    lo_host = lo.cpu().numpy()
    n_bytes = q_host.nbytes + scale_host.nbytes + lo_host.nbytes
    half = (levels + 1.0) / 2.0
    host = (q_host.astype(np.float32) + np.float32(half)) * scale_host \
        + lo_host
    return host, n_bytes, 0.5 * float(scale_host.max())


def upload_quantized(x, transfer_dtype=np.int16, device=None):
    """Upload a host float array as per-channel peak-scaled integers.

    Returns ``(x_dev_f32, n_bytes_uploaded, max_abs_err_bound)``: the
    float32 tensor on ``device`` in the input's units (the scales upload
    too, and the dequantize multiply runs there), the integer payload
    plus the scale sidecar, and half a step maxed over channels.  Layout
    ``(..., n_samples, n_channels)``.  ``transfer_dtype=None`` uploads
    float32.
    """
    device = entry_device(device)
    x = np.asarray(x)
    if transfer_dtype is None:
        x = x.astype(np.float32, copy=False)
        return to_device(x, device), x.nbytes, 0.0
    if np.issubdtype(x.dtype, np.integer):
        raise TypeError(
            "upload_quantized expects float data; integer ADC counts "
            "should go through upload_counts (exact, no re-quantization)")
    td, _, _ = _int_info(transfer_dtype)
    full = 32767.0 if td == np.dtype(np.int16) else 127.0
    quant = (quantize_int16_per_channel if td == np.dtype(np.int16)
             else quantize_int8_per_channel)
    xf = np.ascontiguousarray(x, dtype=np.float32)
    peak = np.maximum(np.abs(xf).max(axis=-2, keepdims=True),
                      np.float32(1e-30)).astype(np.float32)
    q = quant(xf)
    scale = peak / np.float32(full)
    x_dev = to_device(q, device).to(torch.float32) * to_device(scale, device)
    # round half to even: at most half a step, a step being peak/full
    return x_dev, q.nbytes + scale.nbytes, 0.5 * float(scale.max())


def upload_counts(counts, scale, device=None):
    """Upload integer ADC counts as they are and scale them to float32 on
    the device: ``counts · scale`` in float32, exactly, with no
    quantization step.

    counts: integer array, channels on the trailing axis (``read_otb4(
    raw_counts=True)`` is channel-major: pass ``counts.T``); scale: a
    scalar or a broadcastable array, e.g. the per-channel
    ``mv_per_count``.  A 1-D per-channel ``scale`` must match
    ``counts.shape[-1]``.  Returns ``(x_dev_f32, n_bytes_uploaded)``.
    """
    device = entry_device(device)
    counts = np.asarray(counts)
    if not np.issubdtype(counts.dtype, np.integer):
        raise TypeError(f"counts must be integer, got {counts.dtype}")
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 1 and scale.shape[0] != 1 \
            and scale.shape[0] != counts.shape[-1]:
        raise ValueError(
            f"per-channel scale has {scale.shape[0]} entries but the "
            f"trailing (channel) axis of counts is {counts.shape[-1]}; "
            f"read_otb4 output is channel-major — pass counts.T")
    counts_d = torch.from_numpy(np.ascontiguousarray(counts)).to(device)
    x_dev = counts_d.to(torch.float32) * torch.from_numpy(
        np.ascontiguousarray(scale)).to(device)
    return x_dev, counts.nbytes + scale.nbytes
