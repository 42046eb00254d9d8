"""What both references share: the taper set, the window grid and the
tapered spectra, written from the study's definitions (upstream
``signal_features.py``: k = 2·NW − 1 DPSS tapers of unit energy, kept
where their concentration exceeds the threshold; windows of
``window_sec`` at a hop of ``(1 − overlap)`` of a window, the last one
ending at or before the last sample).
"""
from __future__ import annotations

import numpy as np
import scipy.signal.windows
import torch


def tapers(window_samples: int, nw: float, threshold: float) -> np.ndarray:
    """(K, S) float64 DPSS tapers with concentration > ``threshold``."""
    k = int(2 * nw - 1)
    win, ratios = scipy.signal.windows.dpss(window_samples, nw, Kmax=k,
                                            return_ratios=True)
    kept = np.asarray(win)[np.asarray(ratios) > threshold]
    return kept / np.sqrt((kept ** 2).sum(axis=1, keepdims=True))


def window_starts(n_samples: int, window_samples: int, overlap: float
                  ) -> np.ndarray:
    hop = int(window_samples * (1 - overlap))
    return np.arange((n_samples - window_samples) // hop + 1) * hop


def tapered_spectra(x: torch.Tensor, starts, window_samples: int,
                    tapers_t: torch.Tensor) -> torch.Tensor:
    """(n, C) signal → (w, K, F, C) rFFT of each tapered window, in the
    type of ``tapers_t``."""
    idx = (torch.as_tensor(starts, device=x.device)[:, None]
           + torch.arange(window_samples, device=x.device))
    frames = x[idx].to(tapers_t.dtype)                   # (w, S, C)
    return torch.fft.rfft(frames[:, None] * tapers_t[None, :, :, None],
                          dim=2)
