"""Parity of the port's CMC path (``mba_tpu_torch``) with ``mba_tpu``.

Covers the copied host helpers (DPSS tapers, window grid), the window
gather, the plain epilogue behind kernel B1 against both the JAX XLA
kernel and the Pallas kernel (interpret mode), and ``multitaper_msc``
end to end.  Tolerance 5e-5 on coherence and CIs, the Pallas-vs-XLA
tolerance of ``tests/test_ops_coherence.py:217``: the two packages sum
the same float32 formulas with different libraries.  End to end, CIs
also get a relative 2e-4, for cells whose replicates near 1.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.stats import t as t_dist

from mba_tpu.ops import coherence as JC
from mba_tpu.ops import dpss as jdpss
from mba_tpu.ops import framing as jframing
from mba_tpu.ops.pallas_msc import msc_chunk_pallas

from mba_tpu_torch.ops import coherence as TC
from mba_tpu_torch.ops import cuda_msc
from mba_tpu_torch.ops import dpss as tdpss
from mba_tpu_torch.ops import framing as tframing

from _torch_parity import (MSC_MASKS, MSC_OPTIONS, MSC_TRANSFERS,
                           assert_dicts_close, check_msc_assembly,
                           coupled_signals, t32, to_np)

torch.set_num_threads(1)

KEYS = ("coherence", "ci_lower", "ci_upper")
RESULT_KEYS = ("coherence_raw", "coherence_ci_lower", "coherence_ci_upper")


def _frames(seed, w, ws, nE, nM, shared_amp=0.5):
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal(ws * (w + 1))
    eegf = np.stack([(shared_amp * shared[i * ws // 2:i * ws // 2 + ws, None]
                      + rng.standard_normal((ws, nE))) for i in range(w)])
    emgf = np.stack([(shared_amp * shared[i * ws // 2:i * ws // 2 + ws, None]
                      + rng.standard_normal((ws, nM))) for i in range(w)])
    return eegf.astype(np.float32), emgf.astype(np.float32)


def _consts(ws, nw=3, fs=256.0):
    tapers = np.asarray(tdpss.filtered_tapers(ws, nw, 0.9), np.float32)
    K = tapers.shape[0]
    t_crit = np.float32(t_dist.ppf(0.975, K - 1))
    inv = np.float32(1.0 / (fs * ws))
    return tapers, t_crit, inv


@pytest.mark.parametrize("ws,nw", [(256, 3), (128, 2), (500, 2.5)])
def test_dpss_and_threshold_equal_jax_package(ws, nw):
    np.testing.assert_array_equal(tdpss.filtered_tapers(ws, nw, 0.9),
                                  jdpss.filtered_tapers(ws, nw, 0.9))
    t1, r1 = tdpss.dpss_windows(ws, nw, 5, return_ratios=True)
    t2, r2 = jdpss.dpss_windows(ws, nw, 5, return_ratios=True)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(r1, r2)
    assert tdpss.cmc_independence_threshold_host(5, 0.01) == \
        jdpss.cmc_independence_threshold_host(5, 0.01)


@pytest.mark.parametrize("convention", ["cmc", "psd"])
def test_window_grid_equal_jax_package(convention):
    a = tframing.window_grid(3000, 256, 128, 256.0, convention=convention)
    b = jframing.window_grid(3000, 256, 128, 256.0, convention=convention)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_frame_signal_exact():
    x = np.random.default_rng(0).standard_normal((1000, 3)) \
        .astype(np.float32)
    starts = np.array([0, 100, 744], np.int64)
    got = tframing.frame_signal(torch.from_numpy(x), starts, 256)
    ref = jframing.frame_signal(jnp.asarray(x), starts, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("use_jackknife", [True, False])
@pytest.mark.parametrize("emg_max", [True, False])
def test_msc_chunk_matches_xla_kernel(use_jackknife, emg_max):
    eegf, emgf = _frames(0, 2, 256, 8, 4)
    tapers, t_crit, inv = _consts(256)
    ref = JC._msc_chunk_kernel(
        jnp.asarray(eegf), jnp.asarray(emgf), jnp.asarray(tapers), inv,
        t_crit, use_jackknife=use_jackknife, aggregate_emg_max=emg_max)
    got = TC._msc_chunk(t32(eegf), t32(emgf), t32(tapers), float(inv),
                        float(t_crit), use_jackknife, emg_max)
    assert set(got) == set(ref)
    for key in ref:
        assert tuple(got[key].shape) == tuple(ref[key].shape)
    assert_dicts_close(got, ref, ref.keys(), atol=5e-5)


@pytest.mark.parametrize("ws,nw,emg_max,nE,nM", [
    (256, 3, True, 8, 4),      # test_ops_coherence.py:185
    (128, 2, True, 4, 3),      # F = 65: not a multiple of the Pallas block
    (256, 3, False, 6, 3),     # full-grid mode
    (256, 9, True, 4, 3),      # K = 17: the card's runtime-K instance
])
def test_msc_chunk_matches_pallas_interpret(ws, nw, emg_max, nE, nM):
    eegf, emgf = _frames(1, 2, ws, nE, nM)
    tapers, t_crit, inv = _consts(ws, nw)
    ref = msc_chunk_pallas(jnp.asarray(eegf), jnp.asarray(emgf),
                           jnp.asarray(tapers), t_crit, interpret=True,
                           emg_max=emg_max)
    got = TC._msc_chunk(t32(eegf), t32(emgf), t32(tapers), float(inv),
                        float(t_crit), True, emg_max)
    F = ws // 2 + 1
    assert tuple(got["coherence"].shape) == \
        ((2, F, nE) if emg_max else (2, F, nE, nM))
    assert_dicts_close(got, ref, KEYS, atol=5e-5)


def test_exactly_coherent_pair_propagates_nan_like_jax():
    """EMG channel 1 = EEG channel 2: the leave-one-out MSC reaches 1,
    the float32 Fisher clip lets it through to +inf and the z variance
    to NaN, which jnp.maximum/minimum carry into the CIs.  The port must
    carry the NaN too, not drop it (as fmax/fmin would)."""
    eegf, emgf = _frames(2, 2, 256, 6, 3)
    emgf[..., 1] = eegf[..., 2]
    tapers, t_crit, inv = _consts(256)
    ref = JC._msc_chunk_kernel(
        jnp.asarray(eegf), jnp.asarray(emgf), jnp.asarray(tapers), inv,
        t_crit, use_jackknife=True, aggregate_emg_max=False)
    got = TC._msc_chunk(t32(eegf), t32(emgf), t32(tapers), float(inv),
                        float(t_crit), True, False)
    np.testing.assert_allclose(to_np(got["coherence"]),
                               to_np(ref["coherence"]), atol=5e-5)
    for key in ("ci_lower", "ci_upper"):
        a, b = to_np(got[key]), to_np(ref[key])
        pair = np.zeros(a.shape, bool)
        pair[..., 2, 1] = True
        # NaN only in the coherent pair, and there in nearly every cell
        assert not np.isnan(a[~pair]).any() and not np.isnan(b[~pair]).any()
        assert np.isnan(a[pair]).mean() > 0.9
        # c_k may round to 1 or to 1 − 2⁻²⁴ in either package: allow a
        # handful of cells whose NaN-ness differs
        assert (np.isnan(a) != np.isnan(b)).sum() <= 0.02 * pair.sum()
        both = ~np.isnan(a) & ~np.isnan(b)
        np.testing.assert_allclose(a[both], b[both], atol=5e-5)


def test_plain_epilogue_equals_wrapper_on_cpu():
    eegf, emgf = _frames(3, 2, 128, 3, 5)
    tapers, t_crit, _ = _consts(128, 2)
    e = TC.tapered_rfft(t32(eegf), t32(tapers))
    m = TC.tapered_rfft(t32(emgf), t32(tapers))
    before = cuda_msc.msc_jackknife.launches
    a = cuda_msc.msc_jackknife(e, m, float(t_crit), emg_max=True)
    b = cuda_msc.msc_jackknife_plain(e, m, float(t_crit), emg_max=True)
    assert cuda_msc.msc_jackknife.launches == before
    for key in KEYS:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


class TestMultitaperMsc:
    @pytest.mark.parametrize("kw", [
        dict(use_jackknife=True),
        dict(use_jackknife=True, aggregate_emg_max=True),
        dict(use_jackknife=False, significance_level=0.2),
        dict(use_jackknife=True, apply_bonferroni_correction=True,
             freq_range=(8.0, 40.0)),
        dict(use_jackknife=True, aggregate_emg_max=True, window_chunk=3,
             window_mask=np.array([0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1],
                                  bool)),
    ])
    def test_matches_jax_package(self, kw):
        eeg, emg = coupled_signals()
        ref = JC.multitaper_msc(eeg, emg, 256, window_length_sec=1.0, **kw)
        got = TC.multitaper_msc(eeg, emg, 256, window_length_sec=1.0,
                                device="cpu", **kw)
        assert set(got) == set(ref)
        keys = [k for k in RESULT_KEYS if k in ref]
        for key in keys:
            assert got[key].dtype == np.float32
            assert got[key].shape == ref[key].shape
        assert_dicts_close(got, ref, keys[:1], atol=5e-5)
        # CIs: where the replicates near 1, dz/dc = 1/(1 − c²) multiplies
        # float32 rounding by over 100 (one cell of 8514 here moves
        # 9e-5 at ci_lower 0.62), hence the relative term
        assert_dicts_close(got, ref, keys[1:], atol=5e-5, rtol=2e-4)
        np.testing.assert_array_equal(got["freqs"], ref["freqs"])
        np.testing.assert_array_equal(got["time_centers"],
                                      ref["time_centers"])
        assert got["metadata"] == ref["metadata"]
        if "window_mask" in kw:
            assert np.all(got["coherence_raw"][~kw["window_mask"]] == 0)

    def test_significance_mask_agrees(self):
        eeg, emg = coupled_signals(seconds=8)
        kw = dict(window_length_sec=1.0, use_jackknife=False)
        ref = JC.multitaper_msc(eeg, emg, 256, **kw)
        got = TC.multitaper_msc(eeg, emg, 256, device="cpu", **kw)
        it = got["metadata"]["IT_unadjusted"]
        # cells within float32 noise of the threshold may flip
        near = np.abs(ref["coherence_raw"] - it) < 5e-5
        np.testing.assert_array_equal(got["coherence_significant"][~near],
                                      ref["coherence_significant"][~near])

    def test_int16_adc_counts_accepted(self):
        rng = np.random.default_rng(2)
        eeg_i = (rng.standard_normal((256 * 4, 3)) * 2000).astype(np.int16)
        emg_i = (rng.standard_normal((256 * 4, 2)) * 2000).astype(np.int16)
        kw = dict(window_length_sec=1.0, apply_independence_threshold=False)
        ref = JC.multitaper_msc(eeg_i.astype(np.float32),
                                emg_i.astype(np.float32), 256, **kw)
        got = TC.multitaper_msc(eeg_i, emg_i, 256, input_transfer="int16",
                                device="cpu", **kw)
        assert_dicts_close(got, ref, RESULT_KEYS, atol=5e-5)

    def test_transposed_axes_and_timings(self):
        eeg, emg = coupled_signals()
        ref = TC.multitaper_msc(eeg, emg, 256, window_length_sec=1.0,
                                device="cpu")
        got = TC.multitaper_msc(eeg.T.copy(), emg.T.copy(), 256,
                                window_length_sec=1.0, eeg_axis=1,
                                emg_axis=1, collect_timings=True,
                                device="cpu")
        np.testing.assert_array_equal(got["coherence_raw"],
                                      ref["coherence_raw"])
        for key in ("upload_sec", "upload_bytes", "compute_sec",
                    "download_sec", "download_bytes"):
            assert key in got["timings"]

    @pytest.mark.parametrize("input_transfer", [None, "int16"])
    @pytest.mark.parametrize("eeg_axis", [0, 1])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
    @pytest.mark.parametrize("channels", [[2], [3, 0, 0, -1]])
    def test_eeg_channels_are_the_selected_array(self, input_transfer,
                                                 eeg_axis, dtype, channels):
        """``eeg_channels`` gives, bit for bit, what the call on the
        selected array (``np.take`` along the channel axis) gives: every
        result, the grid and the metadata, quantized upload or not."""
        eeg, emg = coupled_signals()
        eeg = np.concatenate([eeg, eeg[:, ::-1] * 0.5], axis=1)
        eeg = (eeg * 1000).astype(dtype)
        if eeg_axis == 1:
            eeg = eeg.T.copy()
        kw = dict(window_length_sec=1.0, eeg_axis=eeg_axis,
                  input_transfer=input_transfer, device="cpu")
        got = TC.multitaper_msc(eeg, emg, 256, eeg_channels=channels, **kw)
        want = TC.multitaper_msc(np.take(eeg, channels, axis=1 - eeg_axis),
                                 emg, 256, **kw)
        assert set(got) == set(want)
        for key, val in want.items():
            if key == "metadata":
                assert got[key] == val
            else:
                assert got[key].dtype == val.dtype
                np.testing.assert_array_equal(got[key], val)

    @pytest.mark.parametrize("input_transfer", [None, "int16"])
    @pytest.mark.parametrize("transfer_dtype,step", [
        (np.float16, 2.0 ** -11),     # an f16 ulp on [0.5, 1)
        (np.int16, 1 / 65535),        # a lane's step: span ≤ 1 on [0, 1]
        (np.int8, 1 / 255),
    ])
    def test_transfer_options_match_jax(self, transfer_dtype, step,
                                        input_transfer):
        """The reduced downloads and the host int16 upload against the
        JAX package: within 5e-5 (2e-4 relative on the CIs) plus one step
        of the transfer type, each package rounding its own float32
        results; the download bytes equal.  The port's ``upload_bytes``
        are the bytes that crossed (int16 here), the JAX package's the
        float32 arrays they became."""
        eeg, emg = coupled_signals()
        kw = dict(window_length_sec=1.0, transfer_dtype=transfer_dtype,
                  input_transfer=input_transfer, collect_timings=True)
        ref = JC.multitaper_msc(eeg, emg, 256, **kw)
        got = TC.multitaper_msc(eeg, emg, 256, device="cpu", **kw)
        for key in RESULT_KEYS:
            assert got[key].dtype == np.float32
        assert_dicts_close(got, ref, RESULT_KEYS[:1], atol=5e-5 + step)
        assert_dicts_close(got, ref, RESULT_KEYS[1:], atol=5e-5 + step,
                           rtol=2e-4)
        assert got["timings"]["download_bytes"] == \
            ref["timings"]["download_bytes"]
        n_in = eeg.size + emg.size
        assert got["timings"]["upload_bytes"] == \
            n_in * (2 if input_transfer else 4)

    @pytest.mark.parametrize("nw", [5, 8, 9])
    def test_jackknife_at_many_tapers_matches_jax(self, nw):
        """nw = 5, 8 and 9 (K = 9, 15 and 17 tapers; on the card K = 17
        takes B1's runtime-K instance): the jackknife has no taper limit
        on either device.  Coherence within 5e-5, the CIs within 5e-5 +
        2e-4·|ref| (float32 Fisher z near 1)."""
        eeg, emg = coupled_signals()
        kw = dict(window_length_sec=1.0, nw=nw, aggregate_emg_max=True)
        ref = JC.multitaper_msc(eeg, emg, 256, **kw)
        got = TC.multitaper_msc(eeg, emg, 256, device="cpu", **kw)
        assert got["metadata"]["K_tapers"] == \
            ref["metadata"]["K_tapers"] == 2 * nw - 1
        assert_dicts_close(got, ref, RESULT_KEYS[:1], atol=5e-5)
        assert_dicts_close(got, ref, RESULT_KEYS[1:], atol=5e-5, rtol=2e-4)

    def test_validation_errors_match(self):
        eeg, emg = coupled_signals()
        with pytest.raises(ValueError, match="window_mask"):
            TC.multitaper_msc(eeg, emg, 256, window_mask=np.ones(3, bool),
                              device="cpu")
        with pytest.raises(ValueError, match="same number of samples"):
            TC.multitaper_msc(eeg[:-10], emg, 256, device="cpu")
        with pytest.raises(ValueError, match="selects no frequency"):
            TC.multitaper_msc(eeg, emg, 256, freq_range=(500.0, 600.0),
                              device="cpu")


@pytest.mark.parametrize("transfer", list(MSC_TRANSFERS))
@pytest.mark.parametrize("options", list(MSC_OPTIONS))
@pytest.mark.parametrize("mask", list(MSC_MASKS))
def test_results_land_in_place_bit_for_bit(monkeypatch, mask, options,
                                           transfer):
    """Each run of active windows is copied into its rows of the full
    grid: the same bits, bytes downloaded and zero rows as a whole
    download then a fancy-index scatter, and one copy a result and run
    (``cmc.download_copies``)."""
    check_msc_assembly(monkeypatch, "cpu", mask, options, transfer)
