"""Sliding-window framing and resampling (port of
``mba_tpu/ops/framing.py``).

``window_grid`` is the JAX package's numpy host function, copied;
``frame_signal`` is one index gather on a torch tensor;
``resample_linear`` interpolates on the tensor's device.
"""
from __future__ import annotations

import numpy as np
import torch


def window_grid(n_samples: int, window_samples: int, hop_samples: int,
                sampling_freq: float, convention: str = "cmc"):
    """Host-side global sliding-window grid.

    - ``"psd"``: ``starts = arange(0, n_samples - window_samples, hop)`` —
      exclusive stop, so a window starting exactly at
      ``n_samples - window_samples`` is NOT included.
    - ``"cmc"``: ``n_windows = (n_samples - window_samples)//hop + 1`` —
      that window IS included.

    Returns (window_starts int64 array, time_centers float64 array).
    """
    if window_samples > n_samples:
        raise ValueError("window longer than signal")
    if convention == "psd":
        starts = np.arange(0, n_samples - window_samples, hop_samples,
                           dtype=np.int64)
    elif convention == "cmc":
        n_windows = (n_samples - window_samples) // hop_samples + 1
        starts = np.arange(n_windows, dtype=np.int64) * hop_samples
    else:
        raise ValueError(f"unknown window-grid convention: {convention}")
    time_centers = (starts + window_samples / 2) / sampling_freq
    return starts, time_centers


def frame_signal(x: torch.Tensor, window_starts, window_samples: int
                 ) -> torch.Tensor:
    """Extract windows as a leading batch axis.

    x : (n_samples, n_channels)  →  (n_windows, window_samples, n_channels)
    """
    starts = torch.as_tensor(window_starts, dtype=torch.int64,
                             device=x.device)
    idx = starts[:, None] + torch.arange(window_samples, device=x.device)
    return x[idx]


def _linspace_from_zero(stop: float, num: int, device) -> torch.Tensor:
    """float32 ``linspace(0, stop, num)`` as XLA computes ``jnp.linspace``
    on the CPU: ``(stop · (1 / (num − 1))) · i``, each step rounded to
    float32 (XLA turns the division into a reciprocal and reassociates),
    with the endpoint exact.  ``torch.linspace`` forms the upper half
    from the end, which moves interior points by an ulp and the
    interpolation by ~1e-5."""
    kw = dict(dtype=torch.float32, device=device)
    if num <= 1:
        return torch.zeros(num, **kw)
    f32 = np.float32
    delta = float(f32(stop) * (f32(1.0) / f32(num - 1)))
    return torch.cat([torch.arange(num - 1, **kw) * delta,
                      torch.tensor([stop], **kw)])


def resample_linear(data: torch.Tensor, original_sampling_freq: float,
                    new_sampling_freq: float) -> torch.Tensor:
    """Linear-interpolation resampling along axis 0, on ``data``'s device.

    As ``mba_tpu/ops/framing.py:57-79``: both time grids are float32
    ``linspace(0, duration, n)``, so the endpoints coincide and no new
    time lies outside the old grid.  data may be (n_samples,) or
    (n_samples, n_channels).
    """
    n_timesteps = data.shape[0]
    original_duration = n_timesteps / original_sampling_freq
    new_n = int(round(original_duration * new_sampling_freq))

    old_t = _linspace_from_zero(original_duration, n_timesteps, data.device)
    new_t = _linspace_from_zero(original_duration, new_n, data.device)

    # fractional index of each new time on the old grid; the step is a
    # tensor on the device, so CUDA divides (a host scalar would become
    # a multiplication by its reciprocal)
    pos = new_t / (old_t[1] - old_t[0]) if n_timesteps > 1 \
        else torch.zeros_like(new_t)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n_timesteps - 2)
    frac = pos - lo
    if data.ndim == 1:
        return data[lo] * (1 - frac) + data[lo + 1] * frac
    return data[lo] * (1 - frac)[:, None] + data[lo + 1] * frac[:, None]
