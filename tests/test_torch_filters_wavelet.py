"""Parity of ``mba_tpu_torch.ops.filters`` and ``ops.wavelet`` with
``mba_tpu.ops.filters`` and ``mba_tpu.ops.wavelet`` on the CPU.

Tolerances: the FIR taps are the same float64 design, equal within atol
1e-15; filtered outputs within 1e-5·max|x| (two float32 FFT
implementations, pocketfft through XLA and torch's, on the same chunks);
wavelet coefficients, reconstructions and denoised signals within
1e-5·max|x| (float32 convolutions summed in another order); the port
also passes ``tests/data/preproc_golden.npz`` at the golden test's own
tolerances (``tests/test_preproc_golden.py``).
"""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mba_tpu.ops import filters as JF
from mba_tpu.ops import wavelet as JW

from mba_tpu_torch.ops import filters as TF
from mba_tpu_torch.ops import wavelet as TW

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "preproc_golden.npz")
FILTER_RTOL = 1e-5       # × max|x|
WAVELET_RTOL = 1e-5      # × max|x|


def _signal(n, C=4, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 256.0
    x = (np.sin(2 * np.pi * 21.5 * t)[:, None]
         + 0.5 * np.sin(2 * np.pi * 50 * t)[:, None]
         + rng.standard_normal((n, C)))
    return x.astype(np.float32)


def _close(got, ref, scale, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=rtol * scale, err_msg=what)


# ---- FIR design ------------------------------------------------------------

@pytest.mark.parametrize("fs,lo,hi", [(2048.0, 0.1, 100.0),
                                      (2048.0, 20.0, 500.0),
                                      (256.0, 8.0, 30.0), (512.0, None, 40.0),
                                      (512.0, 1.0, None), (256.0, None, None),
                                      (256.0, 1.0, 200.0)])
def test_bandpass_taps_equal_jax(fs, lo, hi):
    np.testing.assert_allclose(TF.design_bandpass_fir(fs, lo, hi),
                               JF.design_bandpass_fir(fs, lo, hi),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("fs,freqs,widths", [
    (2048.0, [50.0, 100.0, 150.0, 200.0], None), (256.0, [50.0], 2.0),
    (256.0, [50.0, 100.0, 150.0], None)])           # 150 Hz is dropped
def test_notch_taps_equal_jax(fs, freqs, widths):
    np.testing.assert_allclose(TF.design_notch_fir(fs, freqs, widths),
                               JF.design_notch_fir(fs, freqs, widths),
                               rtol=0, atol=1e-15)


# ---- FIR application -------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0.1, 100.0), (8.0, 30.0), (None, 40.0),
                                   (1.0, None)])
def test_bandpass_filter_matches_jax(lo, hi):
    x = _signal(256 * 20)
    got = TF.bandpass_filter(x, 256.0, lo, hi, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close(got, JF.bandpass_filter(x, 256.0, lo, hi), np.abs(x).max(),
           FILTER_RTOL)


def test_notch_filter_matches_jax():
    x = _signal(256 * 20)
    _close(TF.notch_filter(x, 256.0, [50.0, 100.0], device="cpu"),
           JF.notch_filter(x, 256.0, [50.0, 100.0]), np.abs(x).max(),
           FILTER_RTOL)


@pytest.mark.parametrize("n", [512, 700, 2])
def test_short_signal_takes_the_zero_pad_branch(n):
    """The 0.1-100 Hz band-pass has 8 449 taps at 256 Hz, longer than the
    signal: the reflection covers n − 1 samples and zeros the rest."""
    x = _signal(n)
    assert len(TF.design_bandpass_fir(256.0, 0.1, 100.0)) // 2 > n - 1
    _close(TF.bandpass_filter(x, 256.0, 0.1, 100.0, device="cpu"),
           JF.bandpass_filter(x, 256.0, 0.1, 100.0), np.abs(x).max(),
           FILTER_RTOL)


@pytest.mark.parametrize("zero_phase", [True, False])
@pytest.mark.parametrize("n_taps", [1, 30, 31])
def test_fir_filter_matches_jax(zero_phase, n_taps):
    """Odd and even kernels, centred or causal, a one-tap kernel, and a
    small chunk so that several segments go through one batched FFT."""
    h = np.hanning(n_taps + 2)[1:-1] if n_taps > 1 else np.array([0.5])
    x = _signal(3000)
    got = TF.fir_filter(x, h, zero_phase=zero_phase, chunk=256,
                        device="cpu")
    _close(got, JF.fir_filter(x, h, zero_phase=zero_phase, chunk=256),
           np.abs(x).max(), FILTER_RTOL)


def test_fir_filter_keeps_a_1d_signal_1d():
    x = _signal(1000, C=1)[:, 0]
    got = TF.bandpass_filter(x, 256.0, 8.0, 30.0, device="cpu")
    assert tuple(got.shape) == x.shape
    _close(got, JF.bandpass_filter(x, 256.0, 8.0, 30.0), np.abs(x).max(),
           FILTER_RTOL)


@pytest.mark.parametrize("pad", [0, 3, 9, 20])
def test_reflect_limited_pad_matches_jax(pad):
    x = _signal(10, C=2)
    np.testing.assert_array_equal(
        TF._reflect_limited_pad(torch.from_numpy(x), pad).numpy(),
        np.asarray(JF._reflect_limited_pad(jnp.asarray(x), pad)))


# ---- the golden fixture ----------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_port_passes_golden_taps(golden):
    np.testing.assert_allclose(TF.design_bandpass_fir(2048.0, 0.1, 100.0),
                               golden["eeg_taps"], rtol=0, atol=1e-15)
    np.testing.assert_allclose(TF.design_bandpass_fir(2048.0, 20.0, 500.0),
                               golden["emg_taps"], rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        TF.design_notch_fir(2048.0, [50.0 * i for i in range(1, 5)]),
        golden["notch_taps"], rtol=0, atol=1e-15)


@pytest.mark.parametrize("key,call", [
    ("eeg_filtered", lambda x, fs: TF.bandpass_filter(x, fs, 0.1, 100.0,
                                                      device="cpu")),
    ("emg_filtered", lambda x, fs: TF.bandpass_filter(x, fs, 20.0, 500.0,
                                                      device="cpu")),
    ("notch_filtered", lambda x, fs: TF.notch_filter(
        x, fs, [50.0 * i for i in range(1, 5)], device="cpu"))])
def test_port_passes_golden_filtered_chirp(golden, key, call):
    sig = golden["signal"]
    got = call(sig, float(golden["fs"])).numpy()
    np.testing.assert_allclose(got, golden[key],
                               atol=2e-4 * np.abs(sig).max())


@pytest.mark.parametrize("w", ["db4", "sym5", "coif1"])
def test_port_passes_golden_wavelets(golden, w):
    sig = golden["signal"][:, 0]
    for i, c in enumerate(TW.wavedec(sig, w, level=3, device="cpu")):
        ref = golden[f"{w}_c{i}"]
        np.testing.assert_allclose(c.numpy(), ref,
                                   atol=2e-4 * np.abs(ref).max())
    den = TW.wavelet_denoise(sig, w, level=3, device="cpu").numpy()
    np.testing.assert_allclose(den, golden[f"{w}_denoised"], atol=3e-4)
    rec = TW.waverec(TW.wavedec(sig, w, level=3, device="cpu"), w,
                     lengths=TW.wavedec_lengths(len(sig), w, 3))
    np.testing.assert_allclose(rec.numpy(), sig, atol=2e-4)


# ---- wavelets --------------------------------------------------------------

@pytest.mark.parametrize("w", ["db4", "sym5", "coif1", "haar"])
def test_wavelet_filters_and_max_level_equal_jax(w):
    for a, b in zip(TW.wavelet_filters(w), JW.wavelet_filters(w)):
        np.testing.assert_array_equal(a, b)
    for n in (5, 64, 1001, 3_477_504):
        assert TW.dwt_max_level(n, len(a)) == JW.dwt_max_level(n, len(a))
    with pytest.raises(ValueError):
        TW.wavelet_filters("db99")


@pytest.mark.parametrize("w,n", [("db4", 64), ("db4", 1001),
                                 ("sym5", 1001), ("coif1", 1000),
                                 ("haar", 1001)])
def test_dwt_idwt_match_jax(w, n):
    x = _signal(n, C=3)
    ca, cd = TW.dwt(x, w, device="cpu")
    ja, jd = JW.dwt(jnp.asarray(x), w)
    scale = np.abs(x).max()
    _close(ca, ja, scale, WAVELET_RTOL, "cA")
    _close(cd, jd, scale, WAVELET_RTOL, "cD")
    _close(TW.idwt(ca, cd, w, n), JW.idwt(ja, jd, w, n), scale,
           WAVELET_RTOL, "idwt")
    a1, d1 = TW.dwt(x[:, 0], w, device="cpu")          # 1-D in, 1-D out
    assert a1.ndim == d1.ndim == 1
    _close(a1, ja[:, 0], scale, WAVELET_RTOL, "1-D cA")


@pytest.mark.parametrize("w,n,level", [("db4", 1000, 3),
                                       ("coif1", 151, None)])
def test_wavedec_waverec_match_jax(w, n, level):
    """Three levels of an even length, and every level (the pywt
    maximum) of an odd one."""
    x = _signal(n, C=3)
    got = TW.wavedec(x, w, level, device="cpu")
    ref = JW.wavedec(x, w, level)
    assert len(got) == len(ref)
    scale = np.abs(x).max()
    for g, r in zip(got, ref):
        _close(g, r, scale, WAVELET_RTOL)
    lengths = TW.wavedec_lengths(n, w, len(got) - 1)
    assert lengths == JW.wavedec_lengths(n, w, len(got) - 1)
    for lens in (lengths, None):
        _close(TW.waverec(got, w, lengths=lens),
               JW.waverec(ref, w, lengths=lens), scale, WAVELET_RTOL)
    _close(TW.waverec(got, w, lengths=lengths), x, scale, 1e-5,
           "perfect reconstruction")


@pytest.mark.parametrize("mode,w,n,C", [
    ("soft", "db4", 2048, 4), ("hard", "db4", 2048, 4),
    ("soft", "sym5", 1001, 3), ("hard", "coif1", 777, 1)])
def test_wavelet_denoise_matches_jax(mode, w, n, C):
    x = _signal(n, C)
    got = TW.wavelet_denoise(x, w, mode=mode, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close(got, JW.wavelet_denoise(x, w, mode=mode), np.abs(x).max(),
           WAVELET_RTOL)
    _close(TW.wavelet_denoise(x[:, 0], w, mode=mode, device="cpu"),
           JW.wavelet_denoise(x[:, 0], w, mode=mode), np.abs(x).max(),
           WAVELET_RTOL, "1-D")


def test_denoise_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        TW.wavelet_denoise(_signal(64), 'db4', mode='medium', device="cpu")


def test_global_median_averages_the_middle_pair():
    """An even count whose lower middle value and middle-pair mean
    differ: jnp.median's mean, not torch.median's lower value."""
    v = np.array([5.0, 1.0, 4.0, 2.0, 9.0, 8.0], np.float32)
    got = float(TW.global_median(torch.from_numpy(v.reshape(3, 2))))
    assert got == float(jnp.median(jnp.asarray(v))) == 4.5
    assert float(torch.median(torch.from_numpy(v))) == 4.0
    assert float(TW.global_median(torch.from_numpy(v[:5]))) == 4.0


def test_denoise_threshold_uses_the_even_median():
    """The finest level of 2 × 1000 samples holds 2 × 503 values, an even
    count: a signal whose two middle |cD₁| values are far apart, so the
    threshold moves with the median rule; the port matches JAX."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1000, 2)).astype(np.float32)
    x[::2, 1] *= 40.0                       # one channel much louder
    finest = TW.wavedec(x, 'db4', device="cpu")[-1].abs().reshape(-1)
    srt = torch.sort(finest).values
    n = srt.numel()
    assert n % 2 == 0 and float(srt[n // 2] - srt[n // 2 - 1]) > 1e-3
    _close(TW.wavelet_denoise(x, 'db4', device="cpu"),
           JW.wavelet_denoise(x, 'db4'), np.abs(x).max(), WAVELET_RTOL)


# ---- the device rule -------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda x: TF.bandpass_filter(x, 256.0, 8.0, 30.0),
    lambda x: TF.notch_filter(x, 256.0, [50.0]),
    lambda x: TW.wavelet_denoise(x, 'db4'),
    lambda x: TW.wavedec(x, 'db4')])
def test_numpy_input_without_a_card_raises(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(_signal(512))
