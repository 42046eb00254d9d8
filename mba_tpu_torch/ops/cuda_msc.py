"""Kernel B1: the fused jackknife-MSC epilogue (``csrc/msc_jackknife.cu``).

Replaces the Pallas kernel ``mba_tpu/ops/pallas_msc.py:_msc_block_kernel``
(:40-123).  From the K tapered rFFT spectra of one chunk of windows it
computes, per (window, frequency, EEG, EMG) cell, the taper-summed
cross-spectrum and auto-powers, each leave-one-taper-out MSC as total
minus taper k, the Fisher-z jackknife mean and variance, the t_crit CIs
as tanh², and — with ``emg_max`` — the argmax over EMG with the CIs
taken at that index.  The (K, F, E, M) leave-one-out tensors never reach
device memory; the plain version below materialises them.

:func:`msc_jackknife` is the wrapper: for CPU tensors it runs
:func:`msc_jackknife_plain`, for CUDA tensors it launches the kernel or
raises.  The kernel takes any K >= 2: compile-time instances up to
K = 16 tapers, runtime-K instances above (taper buckets of 18, 20, 24
and 32, then one for any K).
``msc_jackknife.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from mba_tpu_torch import _build

_F32_TINY = torch.finfo(torch.float32).tiny
_FISHER_EPS = 1e-10


def fisher_atanh(coherence: torch.Tensor, eps: float = _FISHER_EPS
                 ) -> torch.Tensor:
    """Forward Fisher atanh: C² → z.  In float32 ``1 - 1e-10 == 1``, so
    ``c == 1`` gives ``+inf``, as in the JAX package."""
    c = torch.clamp(coherence, eps, 1 - eps)
    return 0.5 * torch.log((1 + c) / (1 - c))


def inverse_fisher_atanh(z: torch.Tensor) -> torch.Tensor:
    """Inverse Fisher atanh: z → C²."""
    return torch.tanh(z) ** 2


def coherence_ratio(csd, pe, pm):
    """|CSD|² / max(pe·pm, tiny), clipped to [0, 1]; pe (..., E) and pm
    (..., M) broadcast to the (..., E, M) cross-spectrum grid."""
    num = csd.real ** 2 + csd.imag ** 2
    den = torch.clamp_min(pe[..., :, None] * pm[..., None, :], _F32_TINY)
    return torch.clamp(num / den, 0.0, 1.0)


def _loo_coherence(eeg_fft: torch.Tensor, emg_fft: torch.Tensor,
                   inv_fs_n: float) -> torch.Tensor:
    """(W, K, F, E, M) leave-one-taper-out MSC replicates, algebraically
    as (total − x_k)/(K−1), in the XLA kernel's formula order."""
    K = eeg_fft.shape[1]
    psd_e_k = (eeg_fft.real ** 2 + eeg_fft.imag ** 2) * inv_fs_n
    psd_m_k = (emg_fft.real ** 2 + emg_fft.imag ** 2) * inv_fs_n
    csd_k = (torch.conj(eeg_fft)[..., :, None]
             * emg_fft[..., None, :]) * inv_fs_n            # (W,K,F,E,M)
    inv_km1 = 1.0 / (K - 1)
    loo_c = (csd_k.sum(dim=1, keepdim=True) - csd_k) * inv_km1
    del csd_k
    loo_e = (psd_e_k.sum(dim=1, keepdim=True) - psd_e_k) * inv_km1
    loo_m = (psd_m_k.sum(dim=1, keepdim=True) - psd_m_k) * inv_km1
    return coherence_ratio(loo_c, loo_e, loo_m)


def loo_coherence_max(eeg_fft: torch.Tensor, emg_fft: torch.Tensor
                      ) -> torch.Tensor:
    """(W, F, E, M) largest leave-one-taper-out MSC replicate: how near
    the jackknife comes to 1, where float32 cannot resolve Fisher z."""
    return _loo_coherence(eeg_fft, emg_fft, 1.0).amax(dim=1)


def ci_tolerance(loo_max, atol: float = 5e-5):
    """Per-cell bound on the difference between two float32 computations
    of the jackknife CIs (numpy or torch ``loo_max`` from
    :func:`loo_coherence_max`).

    A replicate c_k carries a few float32 ulps of rounding (~5e-7 near
    1), which Fisher z amplifies by dz/dc = 1/(1 − c²) ≈ 1/(2(1 − c)),
    and the CI by t_crit and the slope of tanh² (< 1): so ``atol`` plus
    1e-6/(1 − max_k c_k).  Coherence itself has no such amplification
    and is held to ``atol`` alone.
    """
    return atol + 1e-6 / (1.0 - loo_max).clip(min=2.0 ** -24)


def msc_jackknife_plain(eeg_fft: torch.Tensor, emg_fft: torch.Tensor,
                        t_crit: float, emg_max: bool = True,
                        inv_fs_n: float = 1.0) -> dict:
    """Plain PyTorch version of the kernel, in the formula order of the
    JAX package's XLA kernel (``coherence.py:91-143``).

    eeg_fft: (W, K, F, E) complex64; emg_fft: (W, K, F, M) complex64.
    ``inv_fs_n`` scales the PSD/CSD as the XLA kernel does; coherence is
    scale-invariant, so the CUDA kernel omits it.
    Returns dict of (W, F, E) arrays (``emg_max``) or (W, F, E, M).
    """
    K = eeg_fft.shape[1]
    coh_k = _loo_coherence(eeg_fft, emg_fft, inv_fs_n)      # (W,K,F,E,M)
    coherence_mean = torch.clamp(coh_k.mean(dim=1), 0.0, 1.0)
    z_k = fisher_atanh(coh_k)
    del coh_k
    z_mean = z_k.mean(dim=1)
    z_var = ((K - 1) / K) * ((z_k - z_mean[:, None]) ** 2).sum(dim=1)
    z_se = torch.sqrt(z_var)

    z_center = fisher_atanh(coherence_mean)
    ci_lower = torch.minimum(
        inverse_fisher_atanh(z_center - t_crit * z_se), coherence_mean)
    ci_upper = torch.maximum(
        inverse_fisher_atanh(z_center + t_crit * z_se), coherence_mean)

    if emg_max:
        # first index among equal maxima, as jnp.argmax
        idx = torch.argmax(coherence_mean, dim=-1, keepdim=True)
        take = lambda a: torch.take_along_dim(a, idx, dim=-1)[..., 0]
        return {"coherence": take(coherence_mean),
                "ci_lower": take(ci_lower), "ci_upper": take(ci_upper)}
    return {"coherence": coherence_mean, "ci_lower": ci_lower,
            "ci_upper": ci_upper}


def _check_spectra(eeg_fft: torch.Tensor, emg_fft: torch.Tensor) -> None:
    for name, x in (("eeg_fft", eeg_fft), ("emg_fft", emg_fft)):
        if x.dtype != torch.complex64:
            raise TypeError(f"{name} must be complex64, got {x.dtype}")
        if x.ndim != 4:
            raise ValueError(f"{name} must be (W, K, F, C), got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if eeg_fft.shape[:3] != emg_fft.shape[:3]:
        raise ValueError(f"spectra disagree on (W, K, F): "
                         f"{tuple(eeg_fft.shape)} vs {tuple(emg_fft.shape)}")
    if eeg_fft.device != emg_fft.device:
        raise ValueError("eeg_fft and emg_fft lie on different devices")


def _launch(entry: str, eeg_fft, emg_fft, t_crit, emg_max) -> dict:
    """One launch of the C entry ``entry`` on CUDA spectra; counted in
    ``msc_jackknife.launches``."""
    W, K, F, E = eeg_fft.shape
    M = emg_fft.shape[-1]
    if K < 2:
        raise ValueError(f"the jackknife needs K >= 2 tapers, got {K}")
    out_shape = (W, F, E) if emg_max else (W, F, E, M)
    outs = [torch.empty(out_shape, dtype=torch.float32,
                        device=eeg_fft.device) for _ in range(3)]
    if W * F * E == 0 or M == 0:
        return dict(zip(("coherence", "ci_lower", "ci_upper"), outs))
    lib = _build.load_library()
    with torch.cuda.device(eeg_fft.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            eeg_fft.data_ptr(), emg_fft.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), W, K, F, E, M,
            float(t_crit), int(bool(emg_max)), stream)
    _build.check_launch(lib, code, entry)
    msc_jackknife.launches += 1
    return dict(zip(("coherence", "ci_lower", "ci_upper"), outs))


def msc_jackknife(eeg_fft: torch.Tensor, emg_fft: torch.Tensor,
                  t_crit: float, emg_max: bool = True,
                  inv_fs_n: float = 1.0) -> dict:
    """Jackknifed MSC from tapered rFFT spectra (see module docstring).

    CPU tensors run :func:`msc_jackknife_plain`; CUDA tensors launch the
    kernel on the current stream.  Shapes and result as the plain version.
    """
    _check_spectra(eeg_fft, emg_fft)
    if eeg_fft.device.type == "cpu":
        return msc_jackknife_plain(eeg_fft, emg_fft, t_crit, emg_max,
                                   inv_fs_n)
    if eeg_fft.device.type != "cuda":
        raise ValueError(f"unsupported device {eeg_fft.device}")
    return _launch("mba_msc_jackknife", eeg_fft, emg_fft, t_crit, emg_max)


def msc_jackknife_runtime_k(eeg_fft: torch.Tensor, emg_fft: torch.Tensor,
                            t_crit: float, emg_max: bool = True) -> dict:
    """The kernel's runtime-K path at any K >= 2, also where
    :func:`msc_jackknife` takes a compile-time instance (K <= 16): for
    holding the two paths to each other, bit for bit, on the card.  CUDA
    tensors only; the launch counts in ``msc_jackknife.launches``."""
    _check_spectra(eeg_fft, emg_fft)
    if eeg_fft.device.type != "cuda":
        raise ValueError(f"the runtime-K path runs on the card only, got "
                         f"{eeg_fft.device}")
    return _launch("mba_msc_jackknife_rt", eeg_fft, emg_fft, t_crit,
                   emg_max)


msc_jackknife.launches = 0
