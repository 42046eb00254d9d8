"""Parity of the port's spectral estimators (``mba_tpu_torch.ops.
spectral``, ``ops.framing.resample_linear``) with ``mba_tpu``.

Mirrors ``tests/test_ops_spectral.py``: the same numpy inputs, made from
a seed, go through the JAX function on the CPU and the port on CPU
tensors.  Tolerances: multitaper PSD rtol 1e-4 with atol 1e-6·max on the
linear scale and atol 1e-4 on log10; Welch rtol 1e-4; the amplitude
spectrum and resampling 1e-6 of the signal's scale.  The two packages
run the same float32 formulas through different FFT libraries.
"""
import numpy as np
import pytest
import torch

from mba_tpu.ops import framing as jframing
from mba_tpu.ops import spectral as JS

from mba_tpu_torch.ops import framing as tframing
from mba_tpu_torch.ops import spectral as TS

from _torch_parity import t32, to_np

torch.set_num_threads(1)

PSD_RTOL, PSD_ATOL_REL, LOG_ATOL = 1e-4, 1e-6, 1e-4
WELCH_RTOL = 1e-4


def _synthetic(fs=256, seconds=4, n_ch=4, seed=0):
    """A 21.5 Hz tone under noise in every channel, float64."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    return np.stack([np.sin(2 * np.pi * 21.5 * t)
                     + 0.5 * rng.standard_normal(len(t))
                     for _ in range(n_ch)], axis=1)


def _assert_psd_close(got, ref, log_scale):
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    if log_scale:
        np.testing.assert_allclose(got, ref, rtol=0, atol=LOG_ATOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=PSD_RTOL,
                                   atol=PSD_ATOL_REL * np.abs(ref).max())


@pytest.mark.parametrize("n_freqs,ws", [(65, 128), (65, 129), (1, 1)])
def test_onesided_scale_equals_jax(n_freqs, ws):
    np.testing.assert_array_equal(TS._onesided_scale(n_freqs, ws),
                                  JS._onesided_scale(n_freqs, ws))


@pytest.mark.parametrize("log_scale", [False, True])
def test_mt_psd_kernel_matches_jax(log_scale):
    import jax.numpy as jnp
    from mba_tpu.ops.dpss import dpss_windows
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((6, 128, 3)).astype(np.float32)
    tapers = np.ascontiguousarray(dpss_windows(128, 3, 5)).astype(np.float32)
    onesided = JS._onesided_scale(65, 128)
    inv = np.float32(1.0 / (256.0 * 128))
    ref = JS._mt_psd_kernel(jnp.asarray(frames), jnp.asarray(tapers),
                            jnp.asarray(onesided), inv, log_scale)
    got = TS._mt_psd_kernel(t32(frames), t32(tapers), t32(onesided),
                            float(inv), log_scale)
    _assert_psd_close(got, ref, log_scale)


@pytest.mark.parametrize("kw", [
    dict(apply_log_scale=False),
    dict(apply_log_scale=True),
    dict(apply_log_scale=False, window_chunk=3),        # ragged last chunk
    dict(apply_log_scale=True, window_length_sec=1.0, overlap_frac=0.75,
         nw=2.5),
    dict(apply_log_scale=False, window_length_sec=0.3),  # odd window, 76
])
def test_multitaper_psd_matches_jax(kw):
    x = _synthetic()
    kw = dict(dict(window_length_sec=0.5, overlap_frac=0.5), **kw)
    ref, t_ref, f_ref = JS.multitaper_psd(x, 256, axis=0, **kw)
    got, t_got, f_got = TS.multitaper_psd(x, 256, axis=0, **kw)
    assert isinstance(got, np.ndarray)
    _assert_psd_close(got, ref, kw["apply_log_scale"])
    np.testing.assert_array_equal(t_got, t_ref)
    np.testing.assert_array_equal(f_got, f_ref)


@pytest.mark.parametrize("layout", ["transposed", "one_channel", "int16"])
def test_multitaper_psd_layouts_match_jax(layout):
    x = _synthetic(n_ch=3)
    kw = dict(window_length_sec=0.5, apply_log_scale=False)
    if layout == "transposed":
        args, ref_x = dict(input_array=x.T, axis=1), x
    elif layout == "one_channel":
        args, ref_x = dict(input_array=x[:, 0]), x[:, 0]
    else:   # ADC counts travel as int16 and are cast on the device
        counts = np.round(x * 1000).astype(np.int16)
        args, ref_x = dict(input_array=counts, axis=0), counts
    ref = JS.multitaper_psd(ref_x, 256, axis=0, **kw)[0]
    got = TS.multitaper_psd(sampling_freq=256, **args, **kw)[0]
    _assert_psd_close(got, ref, False)


def test_multitaper_psd_device_output_is_a_tensor():
    x = _synthetic(n_ch=2)
    host, tc_h, fr_h = TS.multitaper_psd(x, 256.0, axis=0)
    dev, tc_d, fr_d = TS.multitaper_psd(t32(x), 256.0, axis=0,
                                        device_output=True)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_array_equal(tc_d, tc_h)
    np.testing.assert_array_equal(fr_d, fr_h)


def test_multitaper_psd_needs_axis_for_2d():
    with pytest.raises(AttributeError, match="axis"):
        TS.multitaper_psd(_synthetic(), 256.0)


@pytest.mark.parametrize("nperseg,axis", [(1024, 0), (256, 0), (99, 1),
                                          (10_000, 0)])
def test_welch_psd_matches_jax(nperseg, axis):
    x = _synthetic(seconds=8)
    arr = x.T.copy() if axis == 1 else x
    f_ref, p_ref = JS.welch_psd(arr, 256, nperseg=nperseg, axis=axis)
    f_got, p_got = TS.welch_psd(arr, 256, nperseg=nperseg, axis=axis)
    np.testing.assert_array_equal(f_got, f_ref)
    assert p_got.shape == p_ref.shape and p_got.dtype == np.float32
    np.testing.assert_allclose(p_got, p_ref, rtol=WELCH_RTOL)


@pytest.mark.parametrize("target", [21.5, 40.0])
def test_spectral_snr_matches_jax(target):
    x = _synthetic(seconds=8, n_ch=1)
    ref, f_ref, p_ref = JS.spectral_snr(x, 256, target_freq=target,
                                        return_psd=True)
    got, f_got, p_got = TS.spectral_snr(x, 256, target_freq=target,
                                        return_psd=True)
    assert got == pytest.approx(ref, abs=1e-3)
    np.testing.assert_allclose(p_got, p_ref, rtol=WELCH_RTOL)
    assert TS.spectral_snr(x * 7.3, 256, target_freq=target) == \
        pytest.approx(got, abs=1e-3)


@pytest.mark.parametrize("layout", ["2d", "1d", "axis1", "odd"])
def test_amplitude_spectrum_matches_jax(layout):
    x = _synthetic(n_ch=3)
    arr, axis = {"2d": (x, 0), "1d": (x[:, 0], 0), "axis1": (x.T, 1),
                 "odd": (x[:-1], 0)}[layout]
    a_ref, f_ref = JS.amplitude_spectrum(arr, 256, axis=axis)
    a_got, f_got = TS.amplitude_spectrum(arr, 256, axis=axis)
    np.testing.assert_array_equal(f_got, f_ref)
    assert a_got.shape == a_ref.shape
    np.testing.assert_allclose(a_got, a_ref, rtol=0,
                               atol=1e-6 * np.abs(a_ref).max())


def test_amplitude_spectrum_of_a_sine():
    fs = 128
    t = np.arange(fs * 4) / fs
    amp, freqs = TS.amplitude_spectrum(2.5 * np.sin(2 * np.pi * 16 * t), fs)
    assert freqs[np.argmax(amp[:, 0])] == pytest.approx(16.0, abs=0.3)
    assert amp.max() == pytest.approx(2.5, rel=1e-3)


@pytest.mark.parametrize("n,fs_in,fs_out,nch", [(100, 100, 50, 3),
                                                (100, 100, 200, 3),
                                                (257, 128, 100, 0),
                                                (64, 64, 64, 0)])
def test_resample_linear_matches_jax(n, fs_in, fs_out, nch):
    import jax.numpy as jnp
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, nch) if nch else n).astype(np.float32)
    ref = np.asarray(jframing.resample_linear(jnp.asarray(x), fs_in, fs_out))
    got = tframing.resample_linear(torch.from_numpy(x), fs_in, fs_out)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
