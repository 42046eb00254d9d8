"""Parity of ``mba_tpu_torch.pipeline.preprocessing`` and
``workflows.preprocessing_workflow`` with the JAX package on the CPU.

The cascade runs stage by stage in both packages on the same numpy
recording (16 channels, 40 s at 256 Hz for EEG with an 8-component ICA;
16 channels, 20 s at 512 Hz for EMG), with a planted line, an ECG-like
component, one channel with amplitude bursts and one short burst.
Tolerances: every float32 stage within 1e-4·max|x| (FFT filtering and
ICA epochs summed in another order; the filter stages alone agree within
1e-5); ``bad_channels``, ``bad_annotations``, the ICA's epochs and the IC
labels equal; the ICA sources equal up to sign and order at |corr| ≥
0.999.
"""
import json

import numpy as np
import pytest
import torch
import jax

from mba_tpu.pipeline import preprocessing as JP

from mba_tpu_torch.pipeline import preprocessing as TP
from mba_tpu_torch.workflows import preprocessing_workflow as TW

torch.set_num_threads(1)

STAGE_RTOL = 1e-4        # × max|x|
FILTER_RTOL = 1e-5       # × max|x|
CORR_MIN = 0.999
STAGES = ("np_filtered_data", "np_referenced_data",
          "np_amplitude_compliant_data", "np_artefact_free_data",
          "np_spatially_filtered_data", "np_denoised_data", "np_output_data")


def recording(fs=256, seconds=40, n_ch=16, seed=0):
    """Volts: a 21.5 Hz rhythm, a 50 Hz line, slow drift and noise at
    ~10 µV, an ECG-like spike train through a left-right topography,
    ±2 mV bursts on channel 3 over 8 % of the time (a bad channel) and
    one 50-ms burst on channel 5 (an annotation only)."""
    rng = np.random.default_rng(seed)
    n = fs * seconds
    t = np.arange(n) / fs
    x = (np.sin(2 * np.pi * 21.5 * t)[:, None]
         + 0.5 * np.sin(2 * np.pi * 50 * t)[:, None]
         + 0.3 * np.sin(2 * np.pi * 0.05 * t)[:, None]
         + 0.3 * rng.standard_normal((n, n_ch)))
    ecg = np.zeros(n)
    for beat in np.arange(0.3, seconds, 0.9) * fs:
        d = np.arange(n) - beat
        ecg += 8.0 * np.exp(-0.5 * (d / (0.012 * fs)) ** 2)
    x += 0.6 * ecg[:, None] * np.linspace(-0.6, 0.6, n_ch)[None]
    x *= 1e-5
    square = 2e-3 * np.sign(np.sin(2 * np.pi * np.arange(n) * 20 / fs))
    if n_ch > 5:
        for s in range(0, n, 5 * fs):
            x[s:s + int(0.4 * fs), 3] += square[s:s + int(0.4 * fs)]
        x[2 * fs:2 * fs + fs // 20, 5] += square[:fs // 20]
    return x


EEG_KW = dict(sampling_freq=256, modality='eeg', n_ica_components=8,
              wavelet_type='db4')
EMG_KW = dict(sampling_freq=512, modality='emg', n_ica_components=None)


def _pair(x, **kw):
    return (JP.BiosignalPreprocessor(x, **kw),
            TP.BiosignalPreprocessor(x, **kw, device="cpu"))


@pytest.fixture(scope="module")
def eeg_pair():
    return _pair(recording(), **EEG_KW)


@pytest.fixture(scope="module")
def emg_pair():
    return _pair(recording(fs=512, seconds=20, seed=1), **EMG_KW)


def _scale(p):
    return float(np.abs(p.np_input_data).max())


@pytest.mark.parametrize("stage", STAGES)
def test_eeg_stage_matches_jax(eeg_pair, stage):
    ref, got = eeg_pair
    a, b = getattr(got, stage), getattr(ref, stage)
    assert isinstance(a, np.ndarray) and a.dtype == np.asarray(b).dtype
    tol = FILTER_RTOL if stage in STAGES[:3] else STAGE_RTOL
    np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                               atol=tol * _scale(ref), err_msg=stage)


def test_eeg_annotations_ica_and_labels_match_jax(eeg_pair):
    ref, got = eeg_pair
    assert got.bad_channels == ref.bad_channels == [got.channel_names[3]]
    assert got.bad_annotations == ref.bad_annotations
    assert any(1.95 <= s <= 2.05 for s, _ in got.bad_annotations)
    ica_t, ica_j = got.ica_result, ref.ica_result
    assert ica_t.n_iter_ == ica_j.n_iter_ < ica_t.max_iter
    x = got.np_amplitude_compliant_data
    k = ica_t.n_components_
    c = np.abs(np.corrcoef(ica_t.get_sources(x).T,
                           ica_j.get_sources(x).T)[:k, k:])
    assert c.max(axis=1).min() >= CORR_MIN
    assert (got.ica_automatic_labels["labels"]
            == ref.ica_automatic_labels["labels"])
    assert "heart beat" in got.ica_automatic_labels["labels"]
    assert ica_t.exclude == ica_j.exclude and ica_t.exclude


@pytest.mark.parametrize("stage", ["np_filtered_data", "np_output_data"])
def test_emg_cascade_matches_jax(emg_pair, stage):
    ref, got = emg_pair
    np.testing.assert_allclose(getattr(got, stage),
                               np.asarray(getattr(ref, stage)), rtol=0,
                               atol=FILTER_RTOL * _scale(ref))
    assert got.bad_channels == ref.bad_channels == ["EMG03"]
    assert got.bad_annotations == ref.bad_annotations
    np.testing.assert_array_equal(got.np_referenced_data,
                                  got.np_filtered_data)


def test_device_resident_cascade_keeps_tensors(eeg_pair):
    """``device_resident`` on CPU tensors: every stage a tensor, the
    output equal to the numpy-staged cascade's."""
    _, host = eeg_pair
    x = torch.as_tensor(recording(), dtype=torch.float32)
    dev = TP.BiosignalPreprocessor(x, **EEG_KW, device_resident=True)
    assert dev.device == torch.device("cpu")
    out = dev.np_output_data
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    for stage in ("np_filtered_data", "np_referenced_data",
                  "np_artefact_free_data", "np_spatially_filtered_data"):
        assert isinstance(getattr(dev, stage), torch.Tensor), stage
    assert dev.bad_channels == host.bad_channels
    assert dev.ica_result.exclude == host.ica_result.exclude
    np.testing.assert_allclose(out.numpy(), host.np_output_data, rtol=0,
                               atol=STAGE_RTOL * _scale(host))
    assert dev.free_intermediate_stages() is out
    assert dev._filtered_data is None and dev.np_output_data is out


@pytest.mark.parametrize("window", [2, 7, 25])
def test_rolling_ptp_matches_jax(window):
    x = np.random.default_rng(3).standard_normal((203, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TP._rolling_ptp(torch.from_numpy(x), window).numpy(),
        np.asarray(JP._rolling_ptp(jax.numpy.asarray(x), window)))


def test_validation_suite_matches_jax(eeg_pair):
    ref, got = eeg_pair
    for name, kw in (("validate_filtering", {}),
                     ("validate_referencing", {}),
                     ("validate_wavelet_denoising", {}),
                     ("validate_amplitude_thresholding", dict(n_runs=2))):
        a = getattr(got, name)(verbose=False, **kw)
        b = getattr(ref, name)(verbose=False, **kw)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3,
                                   err_msg=name)
    # unfiltered: a band-stopped bin's coherence is a ratio of rounding
    # errors, which the two packages' FFTs round differently
    kw = dict(n_ica_components=None, band_pass_frequencies=(None, None),
              notch_frequency=None)
    p = TP.BiosignalPreprocessor(recording(seconds=8, n_ch=8), 256, 'eeg',
                                 **kw, device="cpu")
    q = JP.BiosignalPreprocessor(recording(seconds=8, n_ch=8), 256, 'eeg',
                                 **kw)
    np.testing.assert_allclose(p.validate_spatial_filtering(verbose=False),
                               q.validate_spatial_filtering(verbose=False),
                               rtol=1e-4, atol=1e-5)


def test_invalidation_table_matches_jax():
    """Each setter clears what the JAX package clears."""
    x = recording(seconds=4, n_ch=6)
    kw = dict(sampling_freq=256, modality='eeg', n_ica_components=None,
              amplitude_rejection_threshold=1e-3, wavelet_type='db4')
    attrs = ('_filtered_data', '_referenced_data',
             '_amplitude_compliant_data', '_bad_channels',
             '_spatially_filtered_data', '_denoised_data', '_output_data')
    for setter, value in (("denoising_threshold_mode", "hard"),
                          ("reference_channels", None),
                          ("band_pass_frequencies", (8, 30)),
                          ("amplitude_rejection_threshold", 2e-3),
                          ("laplacian_filter_neighbor_radius", 0.06),
                          ("np_input_data", x * 2)):
        ref, got = _pair(x, **kw)
        _ = ref.np_output_data, got.np_output_data
        setattr(ref, setter, value)
        setattr(got, setter, value)
        assert ([getattr(got, a) is None for a in attrs]
                == [getattr(ref, a) is None for a in attrs]), setter
    got = TP.BiosignalPreprocessor(x, **kw, device="cpu")
    with pytest.raises(ValueError, match="undefined"):
        got.clean_downstream_results("bogus stage")


def test_init_rules_match_jax():
    x = recording(seconds=2, n_ch=4)
    with pytest.raises(AssertionError):
        TP.BiosignalPreprocessor(np.zeros((4, 100)), 256, 'eeg',
                                 device="cpu")
    emg = TP.BiosignalPreprocessor(x, 256, 'emg', n_ica_components=5,
                                   device="cpu")
    assert emg.band_pass_frequencies == (20, 500)
    assert emg.laplacian_filter_neighbor_radius is None
    with pytest.raises(ValueError, match="EEG"):
        _ = emg.ica_result
    p = TP.BiosignalPreprocessor(x, 256, 'eeg', n_ica_components=None,
                                 amplitude_rejection_threshold=None,
                                 device="cpu")
    with pytest.raises(ValueError, match="n_ica_components"):
        _ = p.ica_result
    with pytest.raises(ValueError, match="amplitude_rejection"):
        p._annotate_amplitude_based_artefacts()
    q = TP.BiosignalPreprocessor(x, 256, 'eeg', n_ica_components=None,
                                 amplitude_rejection_threshold=1e-12,
                                 device="cpu")
    with pytest.raises(ValueError, match="all channels"):
        _ = q.np_amplitude_compliant_data
    assert str(p) == str(JP.BiosignalPreprocessor(
        x, 256, 'eeg', n_ica_components=None))


def test_config_round_trip(tmp_path):
    """The port's config restores an equal cascade, and the JAX package
    reads it (the files are the same format)."""
    x = recording(seconds=4, n_ch=6)
    p = TP.BiosignalPreprocessor(x, 256, 'eeg', n_ica_components=None,
                                 wavelet_type='sym5',
                                 band_pass_frequencies=(1, 40),
                                 device="cpu")
    p.manual_ics_to_exclude = [1, 3]
    p.export_results(tmp_path, identifier="unit")
    cfg = next(tmp_path.glob("*Preprocessor Config*.json"))
    assert json.loads(cfg.read_text())["bad_channels"] == p.bad_channels
    p2 = TP.BiosignalPreprocessor.init_from_config(cfg, x, device="cpu")
    assert p2.wavelet_type == 'sym5'
    assert tuple(p2.band_pass_frequencies) == (1, 40)
    assert p2.manual_ics_to_exclude == [1, 3]
    np.testing.assert_allclose(p2.np_output_data, p.np_output_data,
                               atol=1e-6)
    j2 = JP.BiosignalPreprocessor.init_from_config(cfg, x)
    np.testing.assert_allclose(np.asarray(j2.np_output_data),
                               p.np_output_data, rtol=0,
                               atol=STAGE_RTOL * np.abs(x).max())
    with pytest.raises(ValueError, match="json"):
        TP.BiosignalPreprocessor.init_from_config(tmp_path / "c.txt", x)


def test_import_npy_with_config_matches_jax(tmp_path):
    x = recording(seconds=4, n_ch=6)
    np.save(tmp_path / "2024-01-01 10_00_00 Preprocessed eeg test.npy", x)
    cfg = {'sampling_freq': 256, 'modality': 'eeg',
           'bad_channels': ['Fp1', 'Fp2']}
    (tmp_path / "2024-01-01 10_00_00 Preprocessor Config test.json"
     ).write_text(json.dumps(cfg))
    for kw in ({}, dict(load_only_first_n_seconds=2,
                        channel_subset_inds=[0, 1, 4]),
               dict(bad_channel_treatment='None')):
        got, cfg_t = TP.import_npy_with_config("test", tmp_path,
                                               sampling_rate_Hz=256, **kw)
        ref, cfg_j = JP.import_npy_with_config("test", tmp_path,
                                               sampling_rate_Hz=256, **kw)
        np.testing.assert_array_equal(got, ref)
        assert cfg_t == cfg_j
    got, _ = TP.import_npy_with_config("test", tmp_path, sampling_rate_Hz=256)
    assert (got[:, 0] == 0).all() and (got[:, 2] == 0).all()
    assert not (got[:, 1] == 0).all()


@pytest.mark.parametrize("resident", [False, True])
def test_workflow_matches_jax(tmp_path, resident):
    """preprocess_subject_modality on a raw EEG file, EEG defaults but a
    4-component ICA: the saved output within 1e-4·max|x| of the JAX
    workflow's, the config written beside it."""
    from mba_tpu.workflows import preprocessing_workflow as JWf
    x = recording(seconds=20, n_ch=8)
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        np.save(tmp_path / d / "2024-01-01 10_00_00 Raw eeg.npy", x)
    kw = dict(sampling_freq=256, n_ica_components=4)
    got = TW.preprocess_subject_modality(0, "eeg", tmp_path / "port",
                                         device="cpu",
                                         device_resident=resident, **kw)
    ref = JWf.preprocess_subject_modality(0, "eeg", tmp_path / "jax", **kw)
    assert isinstance(got.np_output_data,
                      torch.Tensor if resident else np.ndarray)
    saved = [np.load(next((tmp_path / d).glob("*Preprocessed eeg*.npy")))
             for d in ("port", "jax")]
    np.testing.assert_allclose(saved[0], saved[1], rtol=0,
                               atol=STAGE_RTOL * np.abs(x).max())
    assert got.bad_channels == ref.bad_channels
    assert next((tmp_path / "port").glob("*Preprocessor Config*.json"))


def test_preprocessor_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TP.BiosignalPreprocessor(recording(seconds=2, n_ch=4), 256, 'eeg')
    p = TP.BiosignalPreprocessor(recording(seconds=2, n_ch=4), 256, 'eeg',
                                 n_ica_components=None, device="cpu")
    assert isinstance(p.np_filtered_data, np.ndarray)
