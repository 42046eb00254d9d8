"""Rotation-null coefficient pass over chunks of windows.

Port of the non-gram branches of ``mba_tpu/ops/cohort_null.py:
_rotation_coeffs_body`` (:128-307).  Per subject, the windows are padded
to a multiple of the chunk (pad windows repeat the first start with
weight 0, :165-170); per chunk both signals go through the window front
end, ``framing.band_spectra`` (framed, cast to float32 after framing so
int16/int8 ADC counts pass through, tapered, transformed with
``torch.fft.rfft`` and cut to the band), and the band is copied out
contiguous.  The chunk's taper spectra then go to the pair pass:

- ``engine='pallas'``: the wrapper of kernel B3 (``cuda_coeffs.
  coeff_pairs``), which launches ``csrc/coeff_pairs.cu`` on a CUDA tensor
  and runs its plain version on a CPU tensor;
- ``engine='xla'``: the plain version itself (``coeff_pairs_plain``), the
  JAX package's chunked scan engine (``cw_body``, :217-233);
- ``per_window=True``: the same products with the window axis kept
  (``cw_body_per_window``, :235-256), for the per-window null.

The chunk sums add up over the chunks, in chunk order: the first chunk's
sums are allocated by the pair pass and every later chunk adds into them
in place (``out=``), with no separate ``add_`` pass.  The JAX
package's MXU rFFT (``ops/fftmm.py``) and the Pallas path's 128-lane
frequency padding and final transposes are TPU layout work: cuFFT takes
the former's place and the kernel writes frequency-major directly.
"""
from __future__ import annotations

import torch

from mba_tpu_torch.ops.cuda_coeffs import (_F32_TINY, _pair_indices,
                                           coeff_pairs, coeff_pairs_plain,
                                           taper_products)
from mba_tpu_torch.ops.framing import band_spectra, pad_windows
from mba_tpu_torch.utils.profiling import count

ENGINES = ("pallas", "xla")


def per_window_pairs(eeg_spec: torch.Tensor, emg_spec: torch.Tensor,
                     weights: torch.Tensor):
    """``cw_body_per_window`` (``cohort_null.py:235-244``): the pair
    products of each window, not summed.  Returns (diag (wc, F, N),
    pr/pi (wc, P2, F, N))."""
    yr, yi = taper_products(eeg_spec, emg_spec, weights)
    diag = (yr * yr + yi * yi).sum(dim=1)
    ks, ls = _pair_indices(yr.shape[1])
    pr = torch.stack([yr[:, k] * yr[:, l] + yi[:, k] * yi[:, l]
                      for k, l in zip(ks, ls)], dim=1)
    pi = torch.stack([yi[:, k] * yr[:, l] - yr[:, k] * yi[:, l]
                      for k, l in zip(ks, ls)], dim=1)
    return diag, pr, pi


def rotation_coeffs_subject(eeg: torch.Tensor, emg: torch.Tensor,
                            starts: torch.Tensor, weights: torch.Tensor,
                            tapers: torch.Tensor, window_samples: int,
                            band_lo: int, band_hi: int, window_chunk: int,
                            engine: str = "xla", per_window: bool = False):
    """Per-subject rotation-null coefficients over window chunks.

    eeg (n, E) / emg (n, M) in any real dtype; starts (W,) int; weights
    (W,) float32; tapers (K, S) float32; all on one device.  Returns
    ``(base (F, E, M), coef (F, E, M, P))`` with P = K(K−1) (cos pairs
    then sin pairs), the gram engine's contract; with ``per_window`` the
    coefficients keep the padded window axis: ``coef (Wp, F, E·M, P)``,
    exactly zero in the pad windows.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    nF = band_hi - band_lo
    nE, nM = eeg.shape[1], emg.shape[1]
    starts, weights = pad_windows(starts, weights.to(torch.float32),
                                  window_chunk)
    count("coeffs.windows_framed", starts.shape[0])
    pairs = coeff_pairs if engine == "pallas" else coeff_pairs_plain
    parts, total = [], None
    for c0 in range(0, starts.shape[0], window_chunk):
        cs = starts[c0:c0 + window_chunk]
        wts = weights[c0:c0 + window_chunk].contiguous()
        Es = band_spectra(eeg, cs, tapers, window_samples, band_lo,
                          band_hi).contiguous()
        Ms = band_spectra(emg, cs, tapers, window_samples, band_lo,
                          band_hi).contiguous()
        if per_window:
            parts.append(per_window_pairs(Es, Ms, wts))
            continue
        total = pairs(Es, Ms, wts, out=total)
    wsum = torch.clamp_min(weights.sum(), _F32_TINY)
    if per_window:
        diag_w, pr_w, pi_w = (torch.cat(x) for x in zip(*parts))
        base = diag_w.sum(dim=0) / wsum
        coefw = torch.cat([2.0 * pr_w, -2.0 * pi_w], dim=1) / wsum
        return base.reshape(nF, nE, nM), coefw.movedim(1, -1)
    diag, pr, pi = total
    base = diag / wsum
    coef = torch.cat([2.0 * pr, -2.0 * pi]) / wsum            # (P, F, N)
    return base.reshape(nF, nE, nM), \
        coef.movedim(0, -1).reshape(nF, nE, nM, -1)
