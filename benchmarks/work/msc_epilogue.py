"""The work of the CMC's spectra and jackknife epilogue, from shapes.

:func:`epilogue_work` is the EMG-max jackknife alone.  Per (window w,
frequency f, EEG e, EMG m): the K cross terms (6 operations each) and
their totals (2 each), the K leave-one-out ratios (two differences,
|.|² in 3, the denominator product, the division, the running sum: 8
each) and their mean: 16K + 1, and the argmax compare; per (w, f, e)
the CIs (K Fisher transforms and the variance, about 10K + 12, each
transcendental counted as one).  Bytes: both spectra read once, three
(W, F, E) float32 results written once.

:func:`step_work` is the whole step from the signal to the results:
the tapering (K·S per window and channel) and real FFTs (2.5·S·log2 S
per window, taper and channel) added to the epilogue's operations, and
as bytes the float32 signal read once and the three results written
once.  The count is of the step, whatever kernels run it.
"""
from __future__ import annotations

import math


def epilogue_work(W: int, K: int, F: int, E: int, M: int
                  ) -> tuple[float, float]:
    flops = W * F * E * (M * (16 * K + 2) + 10 * K + 12)
    nbytes = W * K * F * (E + M) * 8 + 3 * W * F * E * 4
    return float(flops), float(nbytes)


def step_work(W: int, K: int, S: int, E: int, M: int, n_samples: int
              ) -> tuple[float, float]:
    F = S // 2 + 1
    flops, _ = epilogue_work(W, K, F, E, M)
    flops += W * K * (E + M) * (S + 2.5 * S * math.log2(S))
    nbytes = 4.0 * n_samples * (E + M) + 3 * 4.0 * W * F * E
    return float(flops), float(nbytes)
