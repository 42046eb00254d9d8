"""Rotation-null coefficient pass as gram matmuls.

Port of ``mba_tpu/ops/gram_coeffs.py:73-199``.  The normalised taper
product y_k = conj(E_k)·M_k·sqrt(w/(pe·pm)) factorises into an EEG-only
and an EMG-only part, because pe·pm is separable, so every window-summed
pair product C_kl(f, e, m) = Σ_w A_kl(f, e)·B_kl(f, m) is a batched
matmul over (pair, frequency) contracting the window axis, and the band
spectra are one matmul against a taper-folded band DFT matrix.

All matmuls are plain float32 ``torch.einsum``/``torch.matmul``, outside
any kernel, as the JAX package leaves them to XLA.  The device policy
(``mba_tpu_torch._device``) keeps them out of TF32.
"""
from __future__ import annotations

import numpy as np
import torch

from mba_tpu_torch.ops.cuda_coeffs import _pair_indices
from mba_tpu_torch.ops.framing import band_spectra, frame_signal, pad_windows
from mba_tpu_torch.utils.profiling import count

_F32_TINY = float(np.finfo(np.float32).tiny)
# clamp each power factor at sqrt(tiny) so the factorized denominator
# pe'·pm' ≥ tiny matches the fused engine's max(pe·pm, tiny) clamp in
# the degenerate (zero-signal) region
_EPS_HALF = float(np.sqrt(np.finfo(np.float32).tiny))
GRAM_CHUNK = 512


def band_dft_tapered(tapers: torch.Tensor, window_samples: int,
                     band_lo: int, band_hi: int) -> torch.Tensor:
    """Constant (S, 2·K·F) taper-folded band DFT matrix.

    ``out[s, (part, k, f)] = taper[k, s] · {cos, sin}(−2π·s·(band_lo+f)/S)``
    — a frame (…, S) times this matrix gives the Re/Im parts of its K
    tapered band spectra.  The angle is reduced with exact integer
    arithmetic before the trig, so there is no large-argument error.
    """
    S = window_samples
    K = tapers.shape[0]
    nF = band_hi - band_lo
    dev = tapers.device
    s_idx = torch.arange(S, dtype=torch.int64, device=dev)
    f_idx = torch.arange(band_lo, band_hi, dtype=torch.int64, device=dev)
    sf = (s_idx[:, None] * f_idx[None, :]) % S                 # exact
    ang = sf.to(torch.float32) * np.float32(-2.0 * np.pi / S)
    tr = torch.stack([torch.cos(ang), torch.sin(ang)])         # (2, S, F)
    D = tr[:, None] * tapers[None, :, :, None]                 # (2,K,S,F)
    return D.permute(2, 0, 1, 3).reshape(S, 2 * K * nF)


def gram_coeffs_subject(eeg: torch.Tensor, emg: torch.Tensor,
                        starts: torch.Tensor, weights: torch.Tensor,
                        tapers: torch.Tensor, window_samples: int,
                        band_lo: int, band_hi: int,
                        gram_chunk: int = GRAM_CHUNK,
                        spectra: str = "dft"):
    """Per-subject rotation-null coefficients via gram matmuls.

    eeg (n, E) / emg (n, M) in any real dtype (cast to float32 per window
    chunk); starts (W,) int; weights (W,) float32; tapers (K, S) float32,
    all on one device.  Returns ``(base (F, E, M), coef (F, E, M, P))``
    with P = K(K−1) (cos pairs then sin pairs), such that
    ``stat(φ) = base + feats(φ)·coef`` is the weighted window-mean MSC
    under taper-rotated EMG spectra.  ``spectra='fft'`` takes the band
    spectra of the window front end (``framing.band_spectra``, the rFFT)
    instead of the DFT matmul.  (The JAX version's ``dft_precision``/
    ``gram_precision`` are TPU matmul-pass knobs; here every matmul is
    full float32.)
    """
    if spectra not in ("dft", "fft"):
        raise ValueError(f"spectra must be 'dft' or 'fft', got {spectra!r}")
    K = tapers.shape[0]
    ks, ls = _pair_indices(K)
    ks = torch.as_tensor(ks, device=tapers.device)
    ls = torch.as_tensor(ls, device=tapers.device)
    nF = band_hi - band_lo
    nE = eeg.shape[1]
    nM = emg.shape[1]
    P2 = len(ks)

    gc = int(min(gram_chunk, starts.shape[0]))
    starts, weights = pad_windows(starts, weights, gc)
    count("coeffs.windows_framed", starts.shape[0])
    if spectra == "dft":
        D = band_dft_tapered(tapers, window_samples, band_lo, band_hi)

    def re_im(sig, cs):
        """(n, C) signal + (gc,) starts → Re/Im (gc, K, F, C) float32."""
        if spectra == "fft":
            X = band_spectra(sig, cs, tapers, window_samples, band_lo,
                             band_hi)
            return X.real, X.imag
        fr = frame_signal(sig, cs, window_samples).to(torch.float32)
        C = sig.shape[1]
        Xq = torch.einsum("wsc,sq->wcq", fr, D)
        Xq = Xq.reshape(-1, C, 2, K, nF).movedim(1, -1)  # (gc,2,K,F,C)
        return Xq[:, 0], Xq[:, 1]

    def side_operands(Xr, Xi, sqrtw):
        power = Xr * Xr + Xi * Xi                        # (gc, K, F, C)
        inv = sqrtw[:, None, None] / torch.clamp_min(power.sum(dim=1),
                                                     _EPS_HALF)
        return power * inv[:, None], inv

    def g(x, y):                                         # (gc,P2,F,C)² →
        return torch.einsum("wpfe,wpfm->pfem", x, y)     # (P2,F,E,M)

    dev = eeg.device
    diag = torch.zeros((nF, nE, nM), dtype=torch.float32, device=dev)
    re_c = torch.zeros((P2, nF, nE, nM), dtype=torch.float32, device=dev)
    im_c = torch.zeros_like(re_c)
    for c0 in range(0, starts.shape[0], gc):
        cs = starts[c0:c0 + gc]
        wts = weights[c0:c0 + gc]
        Er, Ei = re_im(eeg, cs)
        Mr, Mi = re_im(emg, cs)
        sqrtw = torch.sqrt(wts.to(torch.float32))
        a_diag, ipe = side_operands(Er, Ei, sqrtw)
        b_diag, ipm = side_operands(Mr, Mi, sqrtw)
        diag += torch.einsum("wkfe,wkfm->fem", a_diag, b_diag)
        # E side: A_kl = conj(E_k)·E_l · sqrt(wt)/pe
        Ar = (Er[:, ks] * Er[:, ls] + Ei[:, ks] * Ei[:, ls]) * ipe[:, None]
        Ai = (Er[:, ks] * Ei[:, ls] - Ei[:, ks] * Er[:, ls]) * ipe[:, None]
        # M side: B_kl = M_k·conj(M_l) · sqrt(wt)/pm
        Br = (Mr[:, ks] * Mr[:, ls] + Mi[:, ks] * Mi[:, ls]) * ipm[:, None]
        Bi = (Mi[:, ks] * Mr[:, ls] - Mr[:, ks] * Mi[:, ls]) * ipm[:, None]
        re_c += g(Ar, Br) - g(Ai, Bi)      # Re Σ_w y_k conj(y_l)
        im_c += g(Ar, Bi) + g(Ai, Br)      # Im Σ_w y_k conj(y_l)

    wsum = torch.clamp_min(weights.sum(), _F32_TINY)
    base = diag / wsum
    coef = torch.cat([2.0 * re_c, -2.0 * im_c], dim=0) / wsum
    return base, coef.movedim(0, -1)                     # (F, E, M, P)
