"""Parity of the port's quantized transfers (``mba_tpu_torch.utils.
transfer``) and host quantizers (``mba_tpu_torch.native.quantize``) with
``mba_tpu/utils/transfer.py`` and ``mba_tpu/native/build.py``.

The integers are the JAX package's (the same float32 operations in the
same order, XLA's division by a constant taken as its multiply by the
float32 reciprocal), but where a float32 rounding would land a value on
a tie of the half-to-even rounding; the dequantized values lie within
the returned bound of the input; the byte counts and the errors are the
JAX package's.  The host quantizers and the upload paths are bit for
bit.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mba_tpu.native import (quantize_int8_per_channel as j_q8,
                            quantize_int16_per_channel as j_q16)
from mba_tpu.utils import transfer as JT

from mba_tpu_torch.native import (quantize_int8_per_channel as t_q8,
                                  quantize_int16_per_channel as t_q16)
from mba_tpu_torch.utils import transfer as TT

torch.set_num_threads(1)


def _spectrogram(seed=0, shape=(37, 19, 6)):
    """A log-PSD-like array: per-(freq, channel) offsets and spreads."""
    rng = np.random.default_rng(seed)
    lanes = rng.uniform(-8, 2, shape[1:]) + rng.uniform(0.05, 3, shape[1:]) \
        * rng.standard_normal(shape)
    return lanes.astype(np.float32)


@pytest.mark.parametrize("lane", ["channel", "all_but_first"])
@pytest.mark.parametrize("td", [np.int16, np.int8])
@pytest.mark.parametrize("seed", [0, 1])
def test_download_quantized_matches_jax(seed, td, lane):
    x = _spectrogram(seed)
    lane_ndim = 1 if lane == "channel" else x.ndim - 1
    ref, nb_ref, err_ref = JT.download_quantized(jnp.asarray(x), td,
                                                 lane_ndim)
    got, nb, err = TT.download_quantized(torch.from_numpy(x), td, lane_ndim)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert nb == nb_ref and err == err_ref
    int_dtype, levels = JT._INT_INFO[np.dtype(td)]
    q_ref, s_ref, lo_ref = (np.asarray(a) for a in JT._quantize_on_device(
        jnp.asarray(x), int_dtype, levels, lane_ndim))
    q, s, lo = (a.numpy() for a in TT.quantize_lanes(
        torch.from_numpy(x), TT._INT_INFO[np.dtype(td)][0], levels,
        lane_ndim))
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(lo, lo_ref)
    # off by one only at a tie of the rounding
    off = q.astype(np.int32) != q_ref.astype(np.int32)
    frac = ((x - lo) / s - (levels + 1) / 2) % 1.0
    assert np.all(np.abs(q.astype(np.int32) - q_ref)[off] == 1)
    assert np.all(np.abs(frac[off] - 0.5) < 1e-3)
    np.testing.assert_array_equal(got[~off], ref[~off])
    # half a step, plus the float32 rounding of the dequantize chain
    assert np.abs(got - x).max() <= err * 1.05


def test_download_quantized_float32_and_errors_match_jax():
    x = _spectrogram(2, (5, 4))
    ref = JT.download_quantized(jnp.asarray(x), None)
    got = TT.download_quantized(torch.from_numpy(x), None)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:] == (x.nbytes, 0.0)
    for kw, exc in ((dict(transfer_dtype=np.int32), ValueError),
                    (dict(lane_ndim=0), ValueError),
                    (dict(lane_ndim=2), ValueError)):
        with pytest.raises(exc) as e_ref:
            JT.download_quantized(jnp.asarray(x), **kw)
        with pytest.raises(exc) as e_got:
            TT.download_quantized(torch.from_numpy(x), **kw)
        assert str(e_got.value) == str(e_ref.value)


def test_download_quantized_keeps_the_device_rule(monkeypatch):
    """numpy input goes to the card unless ``device='cpu'``; without a
    card that raises, as every entry point does."""
    x = _spectrogram(3, (6, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TT.download_quantized(x, np.int16)
    got = TT.download_quantized(x, np.int16, device="cpu")
    ref = JT.download_quantized(jnp.asarray(x), np.int16)
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("shape", [(500, 4), (3, 200, 5)])
@pytest.mark.parametrize("bits", [16, 8])
def test_host_quantizers_equal_jax(bits, shape):
    rng = np.random.default_rng(bits + len(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 50, shape[-1])
         ).astype(np.float32)
    x[..., 0] = 0.0                     # a flat channel: peak floor 1e-30
    ref = (j_q16 if bits == 16 else j_q8)(x)
    got = (t_q16 if bits == 16 else t_q8)(x)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        (t_q16 if bits == 16 else t_q8)(x.ravel())


@pytest.mark.parametrize("td", [np.int16, np.int8, None])
def test_upload_quantized_equals_jax(td):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 300, 4)) * 1e-4).astype(np.float32)
    ref, nb_ref, err_ref = JT.upload_quantized(x, td)
    got, nb, err = TT.upload_quantized(x, td, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (nb, err) == (nb_ref, err_ref)
    if td is not None:
        assert np.abs(got.numpy() - x).max() <= err


def test_upload_quantized_errors_match_jax():
    counts = np.zeros((10, 2), np.int16)
    with pytest.raises(TypeError, match="upload_counts"):
        JT.upload_quantized(counts)
    with pytest.raises(TypeError, match="upload_counts"):
        TT.upload_quantized(counts, device="cpu")
    x = np.zeros((10, 2), np.float32)
    with pytest.raises(ValueError, match="int16/int8/None"):
        JT.upload_quantized(x, np.float16)
    with pytest.raises(ValueError, match="int16/int8/None"):
        TT.upload_quantized(x, np.float16, device="cpu")


@pytest.mark.parametrize("scale", ["scalar", "per_channel"])
def test_upload_counts_equals_jax(scale):
    rng = np.random.default_rng(6)
    counts = rng.integers(-30000, 30000, (400, 3)).astype(np.int16)
    sc = (np.float32(2.5e-4) if scale == "scalar"
          else rng.uniform(1e-4, 1e-3, 3).astype(np.float32))
    ref, nb_ref = JT.upload_counts(counts, sc)
    got, nb = TT.upload_counts(counts, sc, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert nb == nb_ref


def test_upload_counts_errors_match_jax():
    counts = np.zeros((5, 3), np.int16)
    for args, exc in (((counts.T, np.ones(3, np.float32)), ValueError),
                      ((counts.astype(np.float32), 1.0), TypeError)):
        with pytest.raises(exc) as e_ref:
            JT.upload_counts(*args)
        with pytest.raises(exc) as e_got:
            TT.upload_counts(*args, device="cpu")
        assert str(e_got.value) == str(e_ref.value)


def test_jax_is_on_the_cpu_here():
    assert jax.devices()[0].platform == "cpu"
