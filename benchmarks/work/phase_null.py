"""The work of the phase-randomised null, from shapes alone.

The step: the observed spectrum, then for each of the n_drawn
surrogates (every chunk full, the last one's surplus included) the EMG's
spectrum turned by its phases, back to time, its W windows framed,
tapered by K tapers and transformed, the window mean of the MSC against
the EEG's window spectra (computed once), its maximum and its histogram
bins.  The count is of the step, whatever kernels or library run it.

Operations, with n samples, ws samples a window, F = n/2 + 1 and
Fw = ws/2 + 1 bins, E EEG and M EMG channels:

- each real FFT of length N (forward or inverse) at 2.5·N·log2 N: per
  surrogate M of length n and W·K·M of length ws; once, the EMG's
  spectrum (M of length n) and the observed spectrum's W·K·(E + M);
- each taper product, one per sample of a tapered window;
- the turn, a complex product (6) per (bin, EMG channel);
- the MSC per (window, bin, EEG, EMG): K complex cross products and
  their sums (8 each), |·|², the denominator product, the division, the
  clip and the window sum (8); the EMG's powers per (window, taper,
  bin, channel), 3 each (the EEG's once);
- the maximum and the histogram bin, 4 per (bin, EEG, EMG).

Bytes, each once for the whole step: the float32 signals read, the
phases (n_drawn·F·M float32), the EMG's spectrum (F·M complex64), the
EEG's window spectra (W·K·Fw·E complex64), the tapers, the n_drawn
maxima, the observed spectrum and the histogram (Fw·E·M·1024 int32);
and each surrogate's n-sample signal written and read once, since an FFT
of that length cannot stay on chip.  The surrogates' window spectra are
counted not at all: a fused pass keeps them on chip.
"""
from __future__ import annotations

import math

N_BINS = 1024


def fft_flops(N: int) -> float:
    return 2.5 * N * math.log2(N)


def step_work(n_drawn: int, n: int, ws: int, W: int, K: int, E: int,
              M: int) -> tuple[float, float]:
    F, Fw = n // 2 + 1, ws // 2 + 1
    msc = W * Fw * E * M * (8 * K + 8) + W * K * Fw * M * 3
    per_surrogate = (M * fft_flops(n) + 6 * F * M
                     + W * K * M * (fft_flops(ws) + ws) + msc
                     + 4 * Fw * E * M)
    once = (M * fft_flops(n) + W * K * (E + M) * (fft_flops(ws) + ws)
            + msc + W * K * Fw * E * 3)
    flops = n_drawn * per_surrogate + once
    nbytes = (4.0 * n * (E + M) + 4.0 * n_drawn * F * M + 8.0 * F * M
              + 8.0 * W * K * Fw * E + 4.0 * K * ws + 4.0 * n_drawn
              + 4.0 * Fw * E * M * (1 + N_BINS)
              + 2 * 4.0 * n_drawn * n * M)
    return float(flops), float(nbytes)
