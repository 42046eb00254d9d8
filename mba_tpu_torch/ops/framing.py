"""Sliding-window framing, the window spectra's front end and
resampling (port of ``mba_tpu/ops/framing.py``).

``window_grid`` is the JAX package's numpy host function, copied;
``frame_signal`` is one index gather on a torch tensor; every pass that
takes tapered window spectra starts from :func:`pad_windows`,
:func:`tapered_rfft` or :func:`band_spectra`; ``resample_linear``
interpolates on the tensor's device.
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


def pad_windows(starts: torch.Tensor, weights: torch.Tensor, chunk: int):
    """Pad (W,) starts/weights to a multiple of ``chunk``: pad windows
    repeat ``starts[0]`` with weight 0 (``cohort_null.py:165-170``)."""
    pad = (-starts.shape[0]) % chunk
    if pad:
        starts = torch.cat([starts, starts[:1].repeat(pad)])
        weights = torch.cat([weights, weights.new_zeros(pad)])
    return starts, weights


def _taper_spectra(frames: torch.Tensor, tapers: torch.Tensor
                   ) -> torch.Tensor:
    """(w, S, C) frames × (K, S) tapers → (w, K, S//2 + 1, C) complex64,
    in the layout the FFT leaves (not contiguous in general)."""
    return torch.fft.rfft(frames[:, None, :, :] * tapers[None, :, :, None],
                          dim=2)


def tapered_rfft(frames: torch.Tensor, tapers: torch.Tensor
                 ) -> torch.Tensor:
    """(w, S, C) frames × (K, S) tapers → (w, K, F, C) complex64 spectra,
    contiguous."""
    return _taper_spectra(frames, tapers).contiguous()


def band_spectra(sig: torch.Tensor, starts: torch.Tensor,
                 tapers: torch.Tensor, window_samples: int, band_lo: int,
                 band_hi: int) -> torch.Tensor:
    """(n, C) signal of any real dtype (cast to float32 after the gather)
    + (wc,) starts → (wc, K, F, C) complex64 tapered band spectra, a view
    of the FFT's output: a reduction over the tapers rounds by the layout
    it reads, so each caller keeps its own (``.contiguous()`` copies the
    band alone)."""
    fr = frame_signal(sig, starts, window_samples).to(torch.float32)
    return _taper_spectra(fr, tapers)[:, :, band_lo:band_hi]


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
