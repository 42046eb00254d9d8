"""Kernel B3: the rotation-null pair pass (``csrc/coeff_pairs.cu``).

Replaces the Pallas kernel ``mba_tpu/ops/pallas_coeffs.py:_coeff_tile_kernel``
(:83-122) and its caller ``coeff_chunk_pallas`` (:125-185).  From the K
tapered band spectra of one chunk of windows it forms, per window and
(frequency, EEG, EMG) cell, the power-normalised taper products

    y_k = conj(E_k)·M_k · sqrt(w / max(pe·pm, tiny)),

and sums over the chunk's windows the taper diagonal Σ_k |y_k|² and the
K(K−1)/2 upper-triangle pair products Re/Im y_k·conj(y_l).  The kernel
keeps the (wc, K, F, N) products out of device memory; the plain version
below, the chunk body of the JAX package's scan engine
(``cohort_null.py:190-233``), materialises them.

:func:`coeff_pairs` is the wrapper: CPU tensors run
:func:`coeff_pairs_plain` (any K >= 2, as the JAX package's scan engine),
CUDA tensors launch the kernel (any K >= 2: compile-time instances up to
K = 16, a runtime-K instance above, with its first pass over the chunk's
channel powers into a scratch tensor the wrapper allocates) or raise.  Given
``out=(diag, pr, pi)``, both add the chunk's sums to it in place, so a
caller sums its chunks without allocating or adding per chunk.
``coeff_pairs.launches`` counts kernel launches.

Tolerance, kernel against plain: the window sums divided by the chunk's
weight sum agree within rtol 2e-5 / atol 2e-6, the bound the JAX package
holds its Pallas and XLA engines to (``tests/test_pallas_coeffs.py:52``).
Each window's terms are at most its weight in size (Cauchy-Schwarz over
the normalised products), and the two versions round them differently
only because nvcc contracts the products into FMAs and the sums run in
another order.
"""
from __future__ import annotations

import numpy as np
import torch

from mba_tpu_torch import _build

_F32_TINY = float(np.finfo(np.float32).tiny)


def _pair_indices(K: int) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (k < l) index pairs: the order of the kernel's pair
    sums, the rotation features and every engine's coefficients."""
    ks, ls = np.triu_indices(K, k=1)
    return ks.astype(np.int64), ls.astype(np.int64)


def taper_products(eeg_spec: torch.Tensor, emg_spec: torch.Tensor,
                   weights: torch.Tensor):
    """The normalised taper products y_k (``_taper_products``,
    ``cohort_null.py:190-215``), in its formula order: ``den =
    max(pe·pm, tiny)``, then ``sqrt(w/den)``.

    eeg_spec (wc, K, F, E) / emg_spec (wc, K, F, M) complex64; weights
    (wc,) float32.  Returns Re and Im of y, each (wc, K, F, E·M).
    """
    wc, K, nF, nE = eeg_spec.shape
    nM = emg_spec.shape[-1]
    pe = (eeg_spec.real ** 2 + eeg_spec.imag ** 2).sum(dim=1)  # (wc, F, E)
    pm = (emg_spec.real ** 2 + emg_spec.imag ** 2).sum(dim=1)  # (wc, F, M)
    den = torch.clamp_min(pe[..., :, None] * pm[..., None, :], _F32_TINY)
    sc = torch.sqrt(weights[:, None, None, None] / den)[:, None]
    Er, Ei = eeg_spec.real[..., :, None], eeg_spec.imag[..., :, None]
    Mr, Mi = emg_spec.real[..., None, :], emg_spec.imag[..., None, :]
    yr = ((Er * Mr + Ei * Mi) * sc).reshape(wc, K, nF, nE * nM)
    yi = ((Er * Mi - Ei * Mr) * sc).reshape(wc, K, nF, nE * nM)
    return yr, yi


def coeff_pairs_plain(eeg_spec: torch.Tensor, emg_spec: torch.Tensor,
                      weights: torch.Tensor, out=None):
    """Plain PyTorch version: ``cw_body`` (``cohort_null.py:217-233``).

    Shapes as :func:`taper_products`.  Returns ``(diag (F, N), pr (P2,
    F, N), pi (P2, F, N))`` float32, summed over the windows; with ``out``
    (three such tensors) adds them to ``out`` in place (``add_``) and
    returns it.
    """
    yr, yi = taper_products(eeg_spec, emg_spec, weights)
    diag = (yr * yr + yi * yi).sum(dim=(0, 1))
    ks, ls = _pair_indices(yr.shape[1])
    pr = torch.stack([(yr[:, k] * yr[:, l] + yi[:, k] * yi[:, l]).sum(dim=0)
                      for k, l in zip(ks, ls)])
    pi = torch.stack([(yi[:, k] * yr[:, l] - yr[:, k] * yi[:, l]).sum(dim=0)
                      for k, l in zip(ks, ls)])
    if out is None:
        return diag, pr, pi
    for acc, x in zip(out, (diag, pr, pi)):
        acc.add_(x)
    return out


def _check(eeg_spec, emg_spec, weights) -> None:
    for name, x in (("eeg_spec", eeg_spec), ("emg_spec", emg_spec)):
        if x.dtype != torch.complex64:
            raise TypeError(f"{name} must be complex64, got {x.dtype}")
        if x.ndim != 4:
            raise ValueError(f"{name} must be (wc, K, F, C), got "
                             f"{tuple(x.shape)}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    for name, x in (("eeg_spec", eeg_spec), ("emg_spec", emg_spec),
                    ("weights", weights)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != eeg_spec.device:
            raise ValueError(f"{name} lies on {x.device}, eeg_spec on "
                             f"{eeg_spec.device}")
    if eeg_spec.shape[:3] != emg_spec.shape[:3]:
        raise ValueError(f"spectra disagree on (wc, K, F): "
                         f"{tuple(eeg_spec.shape)} vs {tuple(emg_spec.shape)}")
    if tuple(weights.shape) != (eeg_spec.shape[0],):
        raise ValueError(f"weights must be ({eeg_spec.shape[0]},), got "
                         f"{tuple(weights.shape)}")
    if eeg_spec.shape[1] < 2:
        raise ValueError(f"the pair pass needs K >= 2 tapers, got "
                         f"{eeg_spec.shape[1]}")


def _out_shapes(eeg_spec, emg_spec):
    _, K, nF, nE = eeg_spec.shape
    N = nE * emg_spec.shape[-1]
    P2 = K * (K - 1) // 2
    return (nF, N), (P2, nF, N), (P2, nF, N)


# the largest K with a compile-time instance (``csrc/coeff_pairs.cu``'s
# MBA_CASE lines); above it ``mba_coeff_pairs`` runs the runtime-K one
COMPILE_TIME_K_MAX = 16


def _check_out(out, eeg_spec, emg_spec) -> None:
    if len(out) != 3:
        raise ValueError(f"out must be (diag, pr, pi), got {len(out)} "
                         "tensors")
    for name, x, shape in zip(("diag", "pr", "pi"), out,
                              _out_shapes(eeg_spec, emg_spec)):
        if x.dtype != torch.float32:
            raise TypeError(f"out {name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"out {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if x.device != eeg_spec.device:
            raise ValueError(f"out {name} lies on {x.device}, eeg_spec on "
                             f"{eeg_spec.device}")
        if not x.is_contiguous():
            raise ValueError(f"out {name} must be contiguous")


def _launch(entry: str, eeg_spec, emg_spec, weights, out):
    """One launch of the C entry ``entry`` on CUDA spectra; counted in
    ``coeff_pairs.launches``."""
    wc, K, nF, nE = eeg_spec.shape
    nM = emg_spec.shape[-1]
    accumulate = out is not None
    if out is None:
        out = tuple(torch.empty(s, dtype=torch.float32,
                                device=eeg_spec.device)
                    for s in _out_shapes(eeg_spec, emg_spec))
    if nF * nE * nM == 0:
        return out
    diag, pr, pi = out
    # the runtime-K instance's first pass writes each window's channel
    # powers here; the compile-time instances take none
    scratch = None
    if entry == "mba_coeff_pairs_rt" or K > COMPILE_TIME_K_MAX:
        scratch = torch.empty(max(1, wc * nF * (nE + nM)),
                              dtype=torch.float32, device=eeg_spec.device)
    lib = _build.load_library()
    with torch.cuda.device(eeg_spec.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            torch.view_as_real(eeg_spec).data_ptr(),
            torch.view_as_real(emg_spec).data_ptr(), weights.data_ptr(),
            diag.data_ptr(), pr.data_ptr(), pi.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            wc, K, nF, nE, nM, int(accumulate), stream)
    _build.check_launch(lib, code, entry)
    coeff_pairs.launches += 1
    return out


def coeff_pairs(eeg_spec: torch.Tensor, emg_spec: torch.Tensor,
                weights: torch.Tensor, out=None):
    """Window sums of the normalised taper products (module docstring).

    eeg_spec (wc, K, F, E) / emg_spec (wc, K, F, M) complex64, contiguous;
    weights (wc,) float32.  Returns ``(diag (F, N), pr (P2, F, N), pi
    (P2, F, N))`` float32, N = E·M.  ``out``: three such tensors on the
    spectra's device, contiguous, to which the sums are added in place
    (each element once, ``out + sum``) and which are returned: a caller
    sums its chunks without an extra pass.  Any K >= 2.
    """
    _check(eeg_spec, emg_spec, weights)
    if out is not None:
        _check_out(out, eeg_spec, emg_spec)
    if eeg_spec.device.type == "cpu":
        return coeff_pairs_plain(eeg_spec, emg_spec, weights, out=out)
    if eeg_spec.device.type != "cuda":
        raise ValueError(f"unsupported device {eeg_spec.device}")
    return _launch("mba_coeff_pairs", eeg_spec, emg_spec, weights, out)


def coeff_pairs_runtime_k(eeg_spec: torch.Tensor, emg_spec: torch.Tensor,
                          weights: torch.Tensor, out=None):
    """The kernel's runtime-K instance at any K >= 2, also where
    :func:`coeff_pairs` takes a compile-time one: for timing the two
    against each other on the card.  CUDA tensors only; arguments and
    result as :func:`coeff_pairs`; the launch counts in
    ``coeff_pairs.launches``."""
    _check(eeg_spec, emg_spec, weights)
    if out is not None:
        _check_out(out, eeg_spec, emg_spec)
    if eeg_spec.device.type != "cuda":
        raise ValueError(f"the runtime-K instance runs on the card only, "
                         f"got {eeg_spec.device}")
    return _launch("mba_coeff_pairs_rt", eeg_spec, emg_spec, weights, out)


coeff_pairs.launches = 0
