"""Parity of the port's surrogate module (``mba_tpu_torch.ops.surrogate``)
with ``mba_tpu.ops.surrogate``.

Mirrors ``tests/test_ops_surrogate.py``.  The host fault injection is a
copy and must agree exactly.  The phase-randomised null draws its phases
as ``jax.random`` does (``ops/prng.py``); the parity tests here also hand
the port the JAX draws through the module function
(``_torch_parity.jax_chunk_phases``), and hold it to: ``observed``
within atol 5e-5; ``max_stat`` within rtol
1e-4 / atol 5e-5; ``p_fwe`` equal; ``null_quantiles`` equal except in at
most 1e-3 of the cells, and there by one bin (a coherence within float32
rounding of a bin edge may fall on either side).
"""
import numpy as np
import pytest
import torch

from mba_tpu.ops import surrogate as JS

from mba_tpu_torch.ops import prng
from mba_tpu_torch.ops import surrogate as TS

from _torch_parity import jax_chunk_phases, t32, to_np

torch.set_num_threads(1)

OBS_ATOL = 5e-5
MAX_RTOL, MAX_ATOL = 1e-4, 5e-5
QUANTILE_CELLS = 1e-3


def _coupled(seed, fs=128, seconds=8, nE=1, nM=1, lo=12.0, hi=20.0,
             drift=0.0):
    """A stochastic band-limited shared drive (phase randomisation keeps a
    deterministic sine), plus noise; ``drift`` adds a slow shared sine."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1 / fs)
    spec[(f < lo) | (f > hi)] = 0
    shared = np.fft.irfft(spec, n=n)
    shared /= shared.std()
    shared += drift * np.sin(2 * np.pi * 0.02 * np.arange(n) / fs)
    eeg = shared[:, None] + 0.5 * rng.standard_normal((n, nE))
    emg = shared[:, None] + 0.5 * rng.standard_normal((n, nM))
    return eeg.astype(np.float32), emg.astype(np.float32)


# ---- host fault injection (copied) ---------------------------------------

@pytest.mark.parametrize("n_channels,scale", [(3, (1.0, 1.0)),
                                              (2, (10.0, 15.0))])
def test_insert_bad_channels_equals_jax(n_channels, scale):
    x = np.random.default_rng(0).standard_normal((500, 8))
    a, ia = TS.insert_bad_channels(x, axis=0, n_channels=n_channels,
                                   scale_range=scale,
                                   rng=np.random.default_rng(4))
    b, ib = JS.insert_bad_channels(x, axis=0, n_channels=n_channels,
                                   scale_range=scale,
                                   rng=np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    assert ia == ib and len(ia) == n_channels


@pytest.mark.parametrize("noise_type,shape", [("white", (1000,)),
                                              ("pink", (2048, 3))])
def test_generate_noise_equals_jax(noise_type, shape):
    a = TS.generate_noise(shape, noise_type, 2.5, np.random.default_rng(1))
    b = JS.generate_noise(shape, noise_type, 2.5, np.random.default_rng(1))
    np.testing.assert_array_equal(a, b)
    assert abs(np.sqrt(np.mean(a ** 2)) - 2.5) < 1e-9


@pytest.mark.parametrize("axis", [0, 1])
def test_add_noise_to_channels_equals_jax(axis):
    x = np.random.default_rng(2).standard_normal((4000, 4))
    x = x.T.copy() if axis == 1 else x
    a = TS.add_noise_to_channels(x, 0.0, [1, 3], axis=axis, random_seed=3)
    b = JS.add_noise_to_channels(x, 0.0, [1, 3], axis=axis, random_seed=3)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="Channel indices"):
        TS.add_noise_to_channels(x, 0.0, [9], axis=axis)


def test_unknown_noise_and_missing_axis_raise():
    with pytest.raises(ValueError, match="noise_type"):
        TS.generate_noise((10,), "brown", 1.0)
    with pytest.raises(AttributeError, match="axis"):
        TS.insert_bad_channels(np.zeros((10, 3)))


# ---- phase randomisation -------------------------------------------------

@pytest.mark.parametrize("n", [512, 511])
def test_rotate_phases_matches_jax_phase_randomize(n):
    """The same key's draws in both packages give the same surrogates;
    odd n has no Nyquist bin."""
    import jax
    x = np.random.default_rng(n).standard_normal((n, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JS.phase_randomize(key, x, 4))
    phases = np.array(jax.random.uniform(key, (4, n // 2 + 1, 2),
                                         minval=0.0, maxval=2 * np.pi))
    xt = torch.from_numpy(x)
    got = TS.rotate_phases(torch.fft.rfft(xt, dim=0), n, t32(phases))
    assert tuple(got.shape) == ref.shape == (4, n, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_phase_randomize_keeps_amplitude_and_is_real():
    x = np.random.default_rng(0).standard_normal((512, 2)).astype(np.float32)
    surr = TS.phase_randomize(prng.prng_key(0), torch.from_numpy(x),
                              4).numpy()
    assert surr.dtype == np.float32 and surr.shape == (4, 512, 2)
    for s in surr:
        np.testing.assert_allclose(np.abs(np.fft.rfft(s, axis=0)),
                                   np.abs(np.fft.rfft(x, axis=0)),
                                   rtol=2e-3, atol=2e-3)
        # DC and Nyquist are not rotated
        np.testing.assert_allclose(s.sum(0), x.sum(0), atol=1e-3)
    assert not np.allclose(surr[0], surr[1])


def test_draw_chunk_phases_range_and_seed():
    a = TS.draw_chunk_phases(prng.prng_key(5), 50, 33, 2, "cpu")
    b = TS.draw_chunk_phases(prng.prng_key(5), 50, 33, 2, "cpu")
    assert a.dtype == torch.float32 and tuple(a.shape) == (50, 33, 2)
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) < 2 * np.pi


# ---- the pieces of the null ------------------------------------------------

def test_msc_spectrum_mean_matches_jax():
    import jax.numpy as jnp
    from mba_tpu_torch.ops.dpss import filtered_tapers
    rng = np.random.default_rng(3)
    ef = rng.standard_normal((5, 128, 2)).astype(np.float32)
    mf = (0.5 * ef[..., :1] + rng.standard_normal((5, 128, 3))) \
        .astype(np.float32)
    tapers = filtered_tapers(128, 3, 0.9).astype(np.float32)
    inv = np.float32(1.0 / (128.0 * 128))
    ref = JS._msc_spectrum_mean(jnp.asarray(ef), jnp.asarray(mf),
                                jnp.asarray(tapers), inv)
    got = TS._msc_spectrum_mean(t32(ef), t32(mf), t32(tapers), float(inv))
    assert tuple(got.shape) == ref.shape == (65, 2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=OBS_ATOL)


def test_hist_accumulate_equals_jax_exactly():
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    spectra = rng.uniform(0, 1, (7, 5, 2, 3)).astype(np.float32)
    spectra[0, 0, 0, :] = [0.0, 1.0, 1023 / 1024]     # the edges
    n_cells = 5 * 2 * 3
    hist0 = rng.integers(0, 9, n_cells * 1024).astype(np.int32)
    ref = JS._hist_accumulate_jit(jnp.asarray(spectra), jnp.asarray(hist0),
                                  n_cells, 1024)
    hist = torch.from_numpy(hist0.copy())
    got = TS._hist_accumulate(torch.from_numpy(spectra), hist)
    assert got is hist and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("args", [(119, 4096, 5, 1, 1, 64),
                                  (119, 4096, 5, 64, 64, 64),
                                  (10_000, 8192, 8, 256, 256, 512),
                                  (119, 4096, 5, 1, 1, 250)])
def test_auto_vmap_width_equals_jax(args):
    assert TS._auto_vmap_width(*args) == JS._auto_vmap_width(*args)


@pytest.mark.parametrize("fs,wl,band", [(93, 0.5, None), (128, 1.0, None),
                                        (100, 0.7, (8.0, 30.0)),
                                        (2048, 2.0, (13.0, 100.0))])
def test_null_freq_mask_equals_jax(fs, wl, band):
    ws = int(wl * fs)
    freqs = np.fft.rfftfreq(ws, d=1.0 / fs)
    got = TS._null_freq_mask(freqs, ws, band)
    np.testing.assert_array_equal(got, JS._null_freq_mask(freqs, ws, band))
    assert not got[0] and (ws % 2 or not got[-1])


# ---- the null, with the JAX draws injected --------------------------------

def _assert_null_close(got, ref, max_stat_only):
    np.testing.assert_allclose(got["observed"], ref["observed"], rtol=0,
                               atol=OBS_ATOL)
    np.testing.assert_array_equal(got["freqs"], ref["freqs"])
    assert got["max_stat"].shape == ref["max_stat"].shape
    np.testing.assert_allclose(got["max_stat"], ref["max_stat"],
                               rtol=MAX_RTOL, atol=MAX_ATOL)
    assert got["observed_max"] == pytest.approx(ref["observed_max"],
                                                abs=OBS_ATOL)
    assert got["p_fwe"] == ref["p_fwe"]
    assert set(got["null_quantiles"]) == set(ref["null_quantiles"])
    for q, r in ref["null_quantiles"].items():
        g = got["null_quantiles"][q]
        if max_stat_only:
            assert g == pytest.approx(r, rel=MAX_RTOL, abs=MAX_ATOL)
            continue
        assert g.dtype == np.float32 and g.shape == r.shape
        diff = np.abs(g - r) * TS.N_BINS
        assert (diff > 0).mean() <= QUANTILE_CELLS and diff.max() <= 1, q
    # the JAX package's clocks, as sums of the port's spans, and the
    # span records and counters themselves
    assert set(got["timings"]) == {"upload_sec", "observed_sec",
                                   "null_sec", "upload_bytes", "spans",
                                   "counters"}
    assert got["timings"]["upload_bytes"] == ref["timings"]["upload_bytes"]


@pytest.mark.parametrize("case", [
    dict(n_surrogates=100, surrogate_chunk=32),          # surplus of 28
    dict(n_surrogates=64, surrogate_chunk=32, band=(8.0, 40.0)),
    dict(n_surrogates=48, surrogate_chunk=16, nE=2, nM=3),
    dict(n_surrogates=40, surrogate_chunk=40, max_stat_only=True),
    dict(n_surrogates=30, surrogate_chunk=64, window_length_sec=0.5,
         overlap_frac=0.75),                             # chunk > n
])
def test_null_matches_jax_on_injected_phases(monkeypatch, case):
    case = dict(case)
    nE, nM = case.pop("nE", 1), case.pop("nM", 1)
    eeg, emg = _coupled(11, nE=nE, nM=nM)
    kw = dict(dict(window_length_sec=1.0, quantiles=(0.95, 0.99), seed=3),
              **case)
    ref = JS.msc_phase_randomized_null(eeg, emg, 128, **kw)
    monkeypatch.setattr(TS, "draw_chunk_phases", jax_chunk_phases(3))
    got = TS.msc_phase_randomized_null(eeg, emg, 128, **kw, device="cpu")
    _assert_null_close(got, ref, case.get("max_stat_only", False))


def test_null_takes_int16_counts_and_one_channel(monkeypatch):
    eeg, emg = _coupled(12)
    counts = [np.round(x[:, 0] * 3000).astype(np.int16) for x in (eeg, emg)]
    kw = dict(window_length_sec=1.0, n_surrogates=32, surrogate_chunk=32,
              seed=1)
    ref = JS.msc_phase_randomized_null(*[c.astype(np.float32)
                                         for c in counts], 128, **kw)
    monkeypatch.setattr(TS, "draw_chunk_phases", jax_chunk_phases(1))
    got = TS.msc_phase_randomized_null(*counts, 128, **kw, device="cpu")
    _assert_null_close(got, ref, False)


def test_null_on_its_own_generator_detects_coupling():
    """A 12-20 Hz coupling under a strong shared drift: the drift pins
    DC coherence near 1 in the data and in every surrogate, and the max
    statistic (DC excluded, band 8-40 Hz) still detects the coupling."""
    eeg, emg = _coupled(9, seconds=16, drift=20.0)
    res = TS.msc_phase_randomized_null(
        eeg, emg, 128, n_surrogates=100, window_length_sec=1.0,
        band=(8.0, 40.0), quantiles=(0.95,), surrogate_chunk=50, seed=1,
        device="cpu")
    assert res["observed"][0, 0, 0] > 0.9
    assert res["null_quantiles"][0.95][0, 0, 0] > 0.9
    assert res["p_fwe"] < 0.05
    assert np.quantile(res["max_stat"], 0.95) < 0.8
    again = TS.msc_phase_randomized_null(
        eeg, emg, 128, n_surrogates=100, window_length_sec=1.0,
        band=(8.0, 40.0), quantiles=(0.95,), surrogate_chunk=50, seed=1,
        device="cpu")
    np.testing.assert_array_equal(again["max_stat"], res["max_stat"])


def test_null_options_that_raise():
    eeg, emg = _coupled(13)
    with pytest.raises(TypeError, match="DeviceMesh"):
        TS.msc_phase_randomized_null(eeg, emg, 128, n_surrogates=8,
                                     mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="selects no valid"):
        TS.msc_phase_randomized_null(eeg, emg, 128, n_surrogates=8,
                                     band=(70.0, 60.0), surrogate_chunk=8,
                                     max_stat_only=True, device="cpu")


def test_null_observed_equals_spectrum_mean():
    """``observed`` is :func:`_msc_spectrum_mean` of the framed signals."""
    from mba_tpu_torch.ops.dpss import filtered_tapers
    from mba_tpu_torch.ops.framing import frame_signal, window_grid
    eeg, emg = _coupled(14, nE=2, nM=2)
    res = TS.msc_phase_randomized_null(eeg, emg, 128, n_surrogates=4,
                                       window_length_sec=1.0,
                                       surrogate_chunk=4, device="cpu")
    starts, _ = window_grid(len(eeg), 128, 64, 128.0)
    tapers = t32(filtered_tapers(128, 3, 0.9))
    ref = TS._msc_spectrum_mean(frame_signal(t32(eeg), starts, 128),
                                frame_signal(t32(emg), starts, 128), tapers,
                                float(np.float32(1 / (128.0 * 128))))
    np.testing.assert_array_equal(res["observed"], to_np(ref))
