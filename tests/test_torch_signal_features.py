"""Parity of the port's feature-extraction stage (``mba_tpu_torch.
pipeline.signal_features``, its host helpers and the workflow entry
points) with ``mba_tpu``.

Mirrors ``tests/test_pipeline_signal_features.py:9-190`` and
``tests/test_band_aggregates.py``.  Stated tolerances: the copied host
helpers and numpy aggregators agree exactly; band aggregates rtol 1e-6 /
atol 1e-7 with NaNs equal; task-wise CMC coherence MSC_ATOL = 5e-5 and
its CIs ``cuda_msc.ci_tolerance`` (5e-5 plus the float32 rounding that
Fisher z amplifies where a jackknife replicate nears 1); log10 PSD atol
1e-4.  The experiment log is the synthetic one of
``tests/test_pipeline_data_integration.py``, enriched by ``mba_tpu``.
"""
import datetime

import numpy as np
import pandas as pd
import pytest
import torch

from mba_tpu import channel_layout as jlayout
from mba_tpu.pipeline import cbpa as jcbpa
from mba_tpu.pipeline import data_integration as jdi
from mba_tpu.pipeline import signal_features as JF
from mba_tpu.utils import file_management as jfm

from mba_tpu_torch import channel_layout as tlayout
from mba_tpu_torch.ops import coherence as TC
from mba_tpu_torch.ops import cuda_msc
from mba_tpu_torch.ops.dpss import filtered_tapers
from mba_tpu_torch.ops.framing import frame_signal, window_grid
from mba_tpu_torch.pipeline import cbpa as tcbpa
from mba_tpu_torch.pipeline import data_analysis as tda
from mba_tpu_torch.pipeline import data_integration as tdi
from mba_tpu_torch.pipeline import signal_features as TF
from mba_tpu_torch.utils import file_management as tfm

from _torch_parity import t32, to_np
from test_pipeline_data_integration import make_raw_log

torch.set_num_threads(1)

MSC_ATOL = 5e-5
BAND_RTOL, BAND_ATOL = 1e-6, 1e-7
LOG_PSD_ATOL = 1e-4


@pytest.fixture(scope="module")
def enriched():
    return jdi.prepare_log_frame(make_raw_log(), set_time_index=False)


def _ci_tol(eeg, emg, fs, window_sec, emg_max):
    """``ci_tolerance`` per output cell of ``multitaper_msc`` (the CMC
    window grid); the EMG-max mode takes the largest over EMG."""
    ws = int(window_sec * fs)
    starts, _ = window_grid(len(eeg), ws, ws // 2, fs)
    tapers = t32(filtered_tapers(ws, 3, 0.9))
    e, m = (TC.tapered_rfft(frame_signal(t32(x), starts, ws), tapers)
            for x in (eeg, emg))
    loo = cuda_msc.loo_coherence_max(e, m).numpy()
    return cuda_msc.ci_tolerance(loo.max(-1) if emg_max else loo, MSC_ATOL)


def _assert_cmc_close(got, ref, tol):
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=MSC_ATOL)
    for g, r in zip(got[1:3], ref[1:3]):
        assert g.shape == r.shape and g.dtype == np.float32
        assert (np.abs(g - r) <= tol).all()
    for g, r in zip(got[3:], ref[3:]):
        np.testing.assert_array_equal(g, r)


# ---- copied host helpers ---------------------------------------------------

def test_channel_layout_equals_jax():
    assert tlayout.EEG_CHANNELS == jlayout.EEG_CHANNELS
    assert tlayout.EEG_CHANNEL_IND_DICT == jlayout.EEG_CHANNEL_IND_DICT
    assert tlayout.EEG_CHANNELS_BY_AREA == jlayout.EEG_CHANNELS_BY_AREA
    assert tlayout.EMG_CHANNELS == jlayout.EMG_CHANNELS
    np.testing.assert_array_equal(tlayout.eeg_positions_3d(),
                                  jlayout.eeg_positions_3d())
    np.testing.assert_array_equal(tlayout.emg_grid_positions_3d(),
                                  jlayout.emg_grid_positions_3d())


@pytest.mark.parametrize("channels,left", [(['Cz', 'C3', 'FC5'], True),
                                           (['C4', 'FT10'], False),
                                           (tcbpa.CMC_EEG_CHANNEL_SUBSET,
                                            True)])
def test_mirror_channels_equal_jax(channels, left):
    assert TF.mirror_eeg_channel_list(channels, input_is_left=left) == \
        jlayout.mirror_eeg_channel_list(channels, input_is_left=left)


def test_cbpa_constants_equal_jax():
    assert tcbpa.EEG_SFREQ == jcbpa.EEG_SFREQ
    assert tcbpa.CMC_EEG_CHANNEL_SUBSET == jcbpa.CMC_EEG_CHANNEL_SUBSET
    assert tcbpa.CMC_CHANNEL_FILE_SUFFIX == jcbpa.CMC_CHANNEL_FILE_SUFFIX


def test_file_management_picks_the_same_file(tmp_path):
    for name in ("2024-01-02 10_00_00 PSD eeg.npy",
                 "2024-01-03 09_00_00 PSD eeg.npy",
                 "2024-01-04 09_00_00 PSD emg.npy", "no date PSD eeg.npy"):
        (tmp_path / name).write_bytes(b"")
    for kw in (dict(file_title_keywords=["PSD", "eeg"]),
               dict(suffix_to_consider=".npy", return_type="dict")):
        assert tfm.most_recent_file(tmp_path, **kw) == \
            jfm.most_recent_file(tmp_path, **kw)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text("# c\nA --- 1\nB --- x, y\n")
    for key, kind in (("A", "int"), ("B", "str_list")):
        assert tfm.TxtConfig(cfg).get_as_type(key, kind) == \
            jfm.TxtConfig(cfg).get_as_type(key, kind)
    assert tfm.file_title("t", ".npy").endswith(" t.npy")


@pytest.mark.parametrize("kw", [dict(song_id=0), dict(trial_id=0),
                                dict(silence_id=0), dict(trial_id=2),
                                dict(song_id=0, verbose=True),
                                dict(song_id=0, assumed_latency_sec=0.0,
                                     cut_off_sec_to_prevent_transients=0.5)])
def test_task_start_end_equals_jax(enriched, kw):
    assert tdi.get_task_start_end(enriched, **kw) == \
        jdi.get_task_start_end(enriched, **kw)


def test_log_spans_equal_jax(enriched):
    for out in ("dict", "list"):
        assert tdi.get_all_task_start_ends(enriched, out) == \
            jdi.get_all_task_start_ends(enriched, out)
    assert tdi.get_qtc_measurement_start_end(enriched, verbose=False) == \
        jdi.get_qtc_measurement_start_end(enriched, verbose=False)
    assert tdi.turn_trial_id_into_song_or_silence_id(enriched, 2) == \
        jdi.turn_trial_id_into_song_or_silence_id(enriched, 2)
    assert tdi.turn_song_or_silence_id_into_trial_id(enriched,
                                                     silence_id=0) == 2
    for kw in (dict(song_id=99), dict(silence_id=99)):
        with pytest.raises(ValueError, match="not found"):
            tdi.get_task_start_end(enriched, **kw)
    naive = pd.Timestamp("2024-01-01 12:00:00")
    assert tda.make_timezone_aware(naive) == naive.tz_localize("utc")
    with pytest.raises(TypeError):
        tda.make_timezone_aware("2024-01-01")


# ---- task window masks ---------------------------------------------------

def test_build_task_window_mask_equals_jax(enriched):
    centers = np.arange(0.5, 91.0, 0.5)
    kw = dict(pre_buffer_sec=3.0, post_buffer_sec=2.0, verbose=False)
    got = TF._build_task_window_mask(centers, enriched, **kw)
    ref = JF._build_task_window_mask(centers, enriched, **kw)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(got)


def test_mask_from_spans_takes_datetime():
    start = pd.Timestamp("2024-01-01 12:00:00", tz="UTC")
    spans = [(start + pd.Timedelta(seconds=10),
              start + pd.Timedelta(seconds=20))]
    centers = np.arange(0, 40, 1.0)
    kw = dict(pre_buffer_sec=2.0, post_buffer_sec=3.0, verbose=False)
    ref = JF.task_window_mask_from_spans(centers, spans, start, **kw)
    got = TF.task_window_mask_from_spans(centers, spans, start, **kw)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.nonzero(got)[0], np.arange(8, 24))
    py = [tuple(t.to_pydatetime() for t in span) for span in spans]
    np.testing.assert_array_equal(TF.task_window_mask_from_spans(
        centers, py, start.to_pydatetime(), **kw), got)
    assert isinstance(py[0][0], datetime.datetime)


# ---- thin wrappers -------------------------------------------------------

@pytest.mark.parametrize("shape,fs_in,fs_out,axis", [((100, 3), 100, 50, 0),
                                                     ((3, 100), 100, 200, 1),
                                                     ((64,), 64, 64, None)])
def test_resample_data_matches_jax(shape, fs_in, fs_out, axis):
    x = np.random.default_rng(0).standard_normal(shape)
    ref = JF.resample_data(x, fs_in, fs_out, axis=axis)
    got = TF.resample_data(x, fs_in, fs_out, axis=axis)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_fisher_and_threshold_equal_jax():
    c = np.array([0.0, 0.1, 0.5, 0.9, 1.0])
    np.testing.assert_array_equal(TF.fisher_atanh_transform(c),
                                  JF.fisher_atanh_transform(c))
    np.testing.assert_array_equal(TF.inverse_fisher_atanh(c),
                                  JF.inverse_fisher_atanh(c))
    for kw in (dict(K=5, alpha=0.05),
               dict(K=5, alpha=0.05, n_comparisons=100,
                    apply_bonferroni=True)):
        m1, it1 = TF.apply_threshold_filtering(c, **kw)
        m2, it2 = JF.apply_threshold_filtering(c, **kw)
        assert it1 == it2 and m1.tolist() == m2.tolist()
    assert TF.compute_cmc_independence_threshold(7, 0.01) == \
        JF.compute_cmc_independence_threshold(7, 0.01)


@pytest.mark.parametrize("ws,nw,nE,nM", [(128, 3, 4, 3), (100, 2.5, 2, 5)])
def test_jackknife_coherence_and_ci_matches_jax(ws, nw, nE, nM):
    rng = np.random.default_rng(ws)
    shared = rng.standard_normal((ws, 1))
    eeg = 0.6 * shared + rng.standard_normal((ws, nE))
    emg = 0.6 * shared + rng.standard_normal((ws, nM))
    tapers = filtered_tapers(ws, nw, 0.9)
    ref = JF.jackknife_coherence_and_ci(tapers, eeg, emg, 128.0, ws)
    before = cuda_msc.msc_jackknife.launches
    got = TF.jackknife_coherence_and_ci(tapers, eeg, emg, 128.0, ws)
    assert cuda_msc.msc_jackknife.launches == before     # CPU: plain
    assert got[0].shape == ref[0].shape == (ws // 2 + 1, nE, nM)
    e, m = (TC.tapered_rfft(t32(x)[None], t32(tapers)) for x in (eeg, emg))
    tol = cuda_msc.ci_tolerance(cuda_msc.loo_coherence_max(e, m)[0].numpy(),
                                MSC_ATOL)
    _assert_cmc_close(got, ref, tol)


def test_multitaper_psd_wrapper_saves_and_keeps_tensor(tmp_path):
    x = np.random.default_rng(1).standard_normal((512, 3)).astype(np.float32)
    dev, tc, fr = TF.multitaper_psd(x, 128.0, window_length_sec=0.5, axis=0,
                                    device_output=True, psd_save_dir=tmp_path,
                                    psd_file_suffix="eeg", device="cpu")
    assert isinstance(dev, torch.Tensor)
    ref = JF.multitaper_psd(x, 128.0, window_length_sec=0.5, axis=0)[0]
    spec, t, f = TF.fetch_stored_spectrograms(tmp_path, "PSD", "eeg",
                                              expected_n_channels=3)
    np.testing.assert_array_equal(spec, dev.numpy())
    np.testing.assert_allclose(spec, ref, rtol=0, atol=LOG_PSD_ATOL)
    np.testing.assert_array_equal(t, tc)
    np.testing.assert_array_equal(f, fr)


def test_snr_and_dft_wrappers_match_jax():
    fs = 128
    t = np.arange(fs * 8) / fs
    x = (np.sin(2 * np.pi * 21.5 * t)
         + 0.5 * np.random.default_rng(2).standard_normal(len(t)))
    assert TF.compute_spectral_snr(x, fs) == \
        pytest.approx(JF.compute_spectral_snr(x, fs), abs=1e-3)
    a, f = TF.discrete_fourier_transform(x, fs)
    b, g = JF.discrete_fourier_transform(x, fs)
    np.testing.assert_array_equal(f, g)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())


# ---- task-wise CMC ---------------------------------------------------------

def _cmc_signals(fs=128, seconds=8, n_eeg=64, n_emg=3, seed=0):
    rng = np.random.default_rng(seed)
    n = fs * seconds
    shared = rng.standard_normal((n, 1))
    eeg = (0.5 * shared + rng.standard_normal((n, n_eeg))).astype(np.float32)
    emg = (0.5 * shared + rng.standard_normal((n, n_emg))).astype(np.float32)
    return eeg, emg, fs


@pytest.mark.parametrize("kw", [
    dict(),
    dict(window_mask="trials"),
    dict(window_mask="trials", enforce_independence_threshold=True),
    dict(enforce_independence_threshold=True,
         independence_threshold_alpha=1 - 1e-9),
    dict(use_jackknife=False, window_mask="trials"),
    dict(freq_range=(8.0, 40.0), eeg_channel_subset=['C3', 'C1', 'Cz']),
])
def test_task_wise_cmc_matches_jax(kw):
    eeg, emg, fs = _cmc_signals()
    kw = dict(kw)
    subset = kw.pop("eeg_channel_subset", None)
    if kw.get("window_mask") == "trials":
        mask = np.zeros(15, bool)
        mask[2:6] = mask[9:13] = True
        kw["window_mask"] = mask
    args = (eeg if subset else eeg[:, :4], emg, fs, "flexor")
    kw = dict(window_size_sec=1.0, eeg_channel_subset=subset, **kw)
    ref = JF.compute_task_wise_aggregated_cmc(*args, **kw)
    got = TF.compute_task_wise_aggregated_cmc(*args, **kw)
    assert len(got) == len(ref)
    if not kw.get("use_jackknife", True):
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=MSC_ATOL)
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(g, r)
        return
    e = eeg[:, [tlayout.EEG_CHANNEL_IND_DICT[c] for c in subset]] \
        if subset else eeg[:, :4]
    tol = _ci_tol(e, emg, fs, 1.0, emg_max=True)
    if "freq_range" in kw:
        f = ref[4]
        tol = tol[:, int(f[0]):int(f[-1]) + 1]
    _assert_cmc_close(got, ref, tol)
    if "window_mask" in kw:
        assert np.all(got[0][~kw["window_mask"]] == 0)


def test_task_wise_cmc_from_the_log_frame(enriched, tmp_path):
    """The window mask built from the experiment log, the artifacts
    saved and fetched."""
    eeg, emg, fs = _cmc_signals(seconds=92, n_emg=2, seed=3)
    kw = dict(eeg_channel_subset=tcbpa.CMC_EEG_CHANNEL_SUBSET,
              window_size_sec=2.0, log_frame=enriched)
    timings = {}
    ref = JF.compute_task_wise_aggregated_cmc(eeg, emg, fs, "extensor", **kw)
    got = TF.compute_task_wise_aggregated_cmc(eeg, emg, fs, "extensor",
                                              save_dir=tmp_path,
                                              timings_out=timings, **kw)
    e = eeg[:, [tlayout.EEG_CHANNEL_IND_DICT[c]
                for c in tcbpa.CMC_EEG_CHANNEL_SUBSET]]
    _assert_cmc_close(got, ref, _ci_tol(e, emg, fs, 2.0, emg_max=True))
    active = np.any(got[0] != 0, axis=(1, 2))
    assert 0 < active.sum() < len(active)
    assert timings["K_tapers"] == 5 and "compute_sec" in timings
    spec, t, f = TF.fetch_stored_spectrograms(
        tmp_path, "Extensor CMC Trial-wise",
        file_identifier=tcbpa.CMC_CHANNEL_FILE_SUFFIX,
        expected_n_channels=11)
    np.testing.assert_array_equal(spec, got[0])
    with pytest.raises(ValueError, match="expected 5 channels"):
        TF.fetch_stored_spectrograms(tmp_path, "Extensor CMC",
                                     expected_n_channels=5)


def test_task_wise_cmc_refusals():
    eeg, emg, fs = _cmc_signals(seconds=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.compute_task_wise_aggregated_cmc(eeg[:, :2], emg, fs, "flexor",
                                            window_size_sec=1.0,
                                            transfer_dtype=np.int16)
    with pytest.raises(ValueError, match="same number of samples"):
        TF.compute_task_wise_aggregated_cmc(eeg[:-5], emg, fs, "flexor")


def test_spectrogram_f16_storage(tmp_path):
    rng = np.random.default_rng(0)
    spec = rng.uniform(-12.0, 3.0, (6, 17, 4)).astype(np.float32)
    tc, fr = np.linspace(0.5, 5.5, 6), np.linspace(0, 256, 17)
    TF.save_spectrograms(torch.from_numpy(spec), tc, fr, "PSD",
                         save_dir=tmp_path, identifier_suffix="f16case",
                         save_dtype=np.float16)
    got, gt, gf = TF.fetch_stored_spectrograms(tmp_path, "PSD",
                                               file_identifier="f16case")
    ref, _, _ = JF.fetch_stored_spectrograms(tmp_path, "PSD",
                                             file_identifier="f16case")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, spec, atol=0.01)
    assert np.abs(got - spec).max() > 0
    np.testing.assert_array_equal(gt, tc)
    np.testing.assert_array_equal(gf, fr)


def test_max_cmc_spectrograms_equals_jax():
    rng = np.random.default_rng(5)
    c, lo, hi = (rng.random((3, 9, 2, 4)) for _ in range(3))
    for a, b in zip(TF.max_cmc_spectrograms_over_channels(c, lo, hi),
                    JF.max_cmc_spectrograms_over_channels(c, lo, hi)):
        np.testing.assert_array_equal(a, b)


# ---- aggregators -----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(behaviour='mean'),
    dict(behaviour='max'),
    dict(behaviour='max', bounds=True),
    dict(behaviour='mean', bounds=True, pre_aggregate_axis=(2, 'max')),
    dict(behaviour='mean', log_transform=True,
         frequency_bands={'beta': (13, 30), 'low': (0, 13)}),
])
def test_band_aggregation_equals_jax(kw):
    kw = dict(kw)
    freqs = np.linspace(0, 100, 101)
    rng = np.random.default_rng(1)
    spec = rng.random((4, 101, 2))
    if kw.pop("bounds", False):
        kw.update(lower_array=spec - 0.1, upper_array=spec + 0.1)
    got = TF.aggregate_spectrogram_over_frequency_band(spec, freqs, **kw)
    ref = JF.aggregate_spectrogram_over_frequency_band(spec, freqs, **kw)
    assert got.keys() == ref.keys()
    for band in ref:
        np.testing.assert_array_equal(np.asarray(got[band]),
                                      np.asarray(ref[band]))
    # the half-open [low, high) rule, kept from the JAX package
    beta = (freqs >= 13) & (freqs < 30)
    if kw["behaviour"] == 'mean' and "lower_array" not in kw \
            and "frequency_bands" not in kw:
        np.testing.assert_allclose(got['beta'], spec[:, beta].mean(axis=1))


@pytest.mark.parametrize("case", range(4))
def test_band_aggregation_refusals(case):
    spec, freqs = np.zeros((2, 21, 1)), np.linspace(0, 20, 21)
    kw = [dict(), dict(lower_array=spec), dict(frequency_bands={}),
          dict(behaviour='median', frequency_bands={'a': (1, 5)})][case]
    with pytest.raises(ValueError):
        TF.aggregate_spectrogram_over_frequency_band(spec, freqs, **kw)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("kw", [
    dict(normalize_mvc=True, freq_slice='slow',
         aggregation_ops=[('mean', 1), ('max', 1)]),
    dict(normalize_mvc=True),
    dict(freq_slice=(10, 60), channel_indices=[0, 2],
         aggregation_ops=[('max', 1)]),
    dict(is_log_scaled=True, normalize_mvc=True, freq_slice='beta'),
])
def test_aggregate_psd_spectrogram_equals_jax(kw):
    spec = np.random.default_rng(3).random((10, 50, 4)) + 0.5
    spec[2, 5, 1] = np.nan
    freqs = np.linspace(0, 250, 50)
    with np.errstate(all='ignore'):
        np.testing.assert_array_equal(
            TF.aggregate_psd_spectrogram(spec, freqs, **kw),
            JF.aggregate_psd_spectrogram(spec, freqs, **kw))
    with pytest.raises(ValueError, match="Unknown frequency band"):
        TF.aggregate_psd_spectrogram(spec, freqs, freq_slice='nope')


def _psd_like():
    rng = np.random.default_rng(0)
    return (rng.normal(-8, 1, size=(40, 129, 16)).astype(np.float32),
            np.linspace(0, 128, 129))


def _cmc_like():
    """Zeroed off-task windows, one all-NaN window, scattered NaN bins."""
    rng = np.random.default_rng(1)
    spec = rng.uniform(0, 1, size=(30, 65, 11)).astype(np.float32)
    spec[:5] = 0.0
    spec[17] = np.nan
    spec[20, 13:20, 3] = np.nan
    return spec, np.linspace(0, 64, 65)


@pytest.mark.parametrize("which", ["psd", "cmc"])
@pytest.mark.parametrize("path", ["host", "tensor"])
def test_band_aggregate_spectrogram_matches_jax(which, path):
    """Host path against the JAX host path; the tensor path (the device
    reduction, here on CPU tensors) against the JAX device path."""
    import jax.numpy as jnp
    spec, freqs = _psd_like() if which == "psd" else _cmc_like()
    if path == "host":
        ref = JF.band_aggregate_spectrogram(spec, freqs)
        got = TF.band_aggregate_spectrogram(spec, freqs)
        assert isinstance(got[0], np.ndarray)
    else:
        ref = JF.band_aggregate_spectrogram(jnp.asarray(spec), freqs)
        got = TF.band_aggregate_spectrogram(torch.from_numpy(spec), freqs)
        assert isinstance(got[0], torch.Tensor)
    assert got[1] == ref[1]
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(to_np(got[0]), to_np(ref[0]), rtol=BAND_RTOL,
                               atol=BAND_ATOL, equal_nan=True)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("band", ["all", "theta", "beta", "gamma"])
def test_band_aggregates_match_full_grid_aggregator(band):
    spec, freqs = _cmc_like()
    payload, names, edges = TF.band_aggregate_spectrogram(
        torch.from_numpy(spec), freqs)
    agg = TF.BandAggregates(payload.numpy(), np.arange(len(spec)), names,
                            edges)
    with np.errstate(all='ignore'):
        for stat in ("mean", "max"):
            expected = TF.aggregate_psd_spectrogram(
                spec, freqs, freq_slice=band, aggregation_ops=[(stat, 1)])
            np.testing.assert_allclose(agg.select(band, stat), expected,
                                       rtol=BAND_RTOL, atol=BAND_ATOL,
                                       equal_nan=True)


def test_band_aggregates_roundtrip(tmp_path):
    spec, freqs = _psd_like()
    payload, names, edges = TF.band_aggregate_spectrogram(
        torch.from_numpy(spec), freqs)
    tc = np.arange(len(spec)) * 0.5
    TF.save_band_aggregates(payload, tc, names, edges, "PSD", tmp_path,
                            identifier_suffix="eeg")
    agg = TF.fetch_band_aggregates(tmp_path, "PSD", file_identifier="eeg")
    ref = JF.fetch_band_aggregates(tmp_path, "PSD", file_identifier="eeg")
    np.testing.assert_array_equal(agg.payload, payload.numpy())
    np.testing.assert_array_equal(agg.payload, ref.payload)
    assert agg.band_names == ref.band_names == names
    assert agg.n_channels == 16 and agg.n_windows == 40
    np.testing.assert_array_equal(agg.select("beta", "max", [1, 3]),
                                  payload.numpy()[:, names.index("beta"),
                                                  [1, 3], 1])
    with pytest.raises(ValueError, match="not stored"):
        agg.select("ripple", "mean")
    with pytest.raises(ValueError):
        TF.fetch_band_aggregates(tmp_path, "PSD", file_identifier="emg")
    with pytest.raises(ValueError, match="No requested band"):
        TF.band_aggregate_spectrogram(spec, freqs, bands={'x': (300, 400)})


# ---- the workflow entry points ---------------------------------------------

def test_workflow_entry_points_match_jax(enriched, tmp_path):
    from mba_tpu.workflows import subject_feature_extraction_workflow as JW
    from mba_tpu_torch.workflows import \
        subject_feature_extraction_workflow as TW
    rng = np.random.default_rng(4)
    fs, n = 128, 128 * 92
    shared = rng.standard_normal((n, 1))
    eeg = (0.4 * shared + rng.standard_normal((n, 64))).astype(np.float32)
    flex, ext = ((0.4 * shared + rng.standard_normal((n, 2)))
                 .astype(np.float32) for _ in range(2))
    dirs = {p: tmp_path / p for p in ("jax", "torch")}
    for d in dirs.values():
        d.mkdir()
    JW.extract_psd_features(dirs["jax"], eeg, flex, ext, fs)
    TW.extract_psd_features(dirs["torch"], eeg, flex, ext, fs)
    for modality in ("eeg", "emg_1_flexor", "emg_2_extensor"):
        got, ref = (TF.fetch_stored_spectrograms(dirs[p], "PSD", modality)
                    for p in ("torch", "jax"))
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=LOG_PSD_ATOL)
        np.testing.assert_array_equal(got[1], ref[1])
    JW.extract_cmc_features(dirs["jax"], eeg, flex, ext, fs, enriched,
                            handedness="Left")
    TW.extract_cmc_features(dirs["torch"], eeg, flex, ext, fs, enriched,
                            handedness="Left")
    mirrored = tlayout.mirror_eeg_channel_list(
        tcbpa.CMC_EEG_CHANNEL_SUBSET, input_is_left=True)
    for muscle in ("Flexor", "Extensor"):
        got, ref = (TF.fetch_stored_spectrograms(
            dirs[p], f"{muscle} CMC Trial-wise", expected_n_channels=11)
            for p in ("torch", "jax"))
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=MSC_ATOL)
        np.testing.assert_array_equal(got[1], ref[1])
    assert mirrored != tcbpa.CMC_EEG_CHANNEL_SUBSET
