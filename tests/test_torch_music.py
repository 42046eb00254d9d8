"""The port's music features (``mba_tpu_torch.pipeline.music_control``,
``workflows.music_feature_extraction_workflow``) against ``mba_tpu``'s,
on the CPU.

The STFT frames the clip and takes the rFFT on the device the caller
names (here ``"cpu"``; the JAX package runs XLA's FFT): magnitudes agree
within rtol 1e-5 and atol 1e-6 × the spectrum's maximum.  On click tracks
with clean onsets every peak pick lands on the same frame, so the BPM,
beat grid, onsets, IOI entropy and syncopation are equal.  The WAV
loader, the Spotify control and the workflow's tables are host copies
and equal to the value.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from mba_tpu.pipeline import music_control as JM
from mba_tpu.workflows import music_feature_extraction_workflow as JMW
from mba_tpu_torch.pipeline import music_control as TM
from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.workflows import music_feature_extraction_workflow \
    as TMW

import test_reporting_music as JT
from test_reporting_music import _click_track, _write_wav

torch.set_num_threads(1)

STFT_RTOL = 1e-5
STFT_ATOL = 1e-6     # × the spectrum's maximum


def _syncopated_track(sr=22050, seconds=12, bpm=120, seed=0):
    """Clicks on every beat and on every other off-beat (a known tempo
    with syncopated onsets)."""
    t = np.arange(int(sr * seconds)) / sr
    y = 0.002 * np.random.default_rng(seed).standard_normal(len(t))
    period = 60.0 / bpm
    dur = int(0.03 * sr)
    click = np.hanning(dur) * np.sin(2 * np.pi * 1000 * t[:dur])
    for i, beat in enumerate(np.arange(0.1, seconds - 0.5, period)):
        for onset in ([beat, beat + period / 2] if i % 2 else [beat]):
            idx = int(onset * sr)
            y[idx:idx + dur] += click
    return y, sr


TRACKS = {
    "click_120": lambda: _click_track(bpm=120),
    "click_96_8s": lambda: _click_track(bpm=96, seconds=8, click_hz=700),
    "syncopated_120": lambda: _syncopated_track(),
}


@pytest.mark.parametrize("sampwidth", [1, 2, 3, 4])
def test_wav_bit_depths_match_jax(tmp_path, sampwidth):
    sr = 8000
    y = 0.5 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)
    path = tmp_path / f"tone{sampwidth}.wav"
    JT.TestWavFormats()._write(path, y, sr, sampwidth)
    got, got_sr = TM.load_audio_file(path, duration=None)
    want, want_sr = JM.load_audio_file(path, duration=None)
    assert got_sr == want_sr == sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    tol = {1: 2e-2, 2: 1e-3, 3: 1e-5, 4: 1e-6}[sampwidth]
    np.testing.assert_allclose(got, y, atol=tol)
    short, _ = TM.load_audio_file(path, duration=0.25)
    np.testing.assert_array_equal(short, got[:2000])


def test_wav_stereo_downmix_matches_jax(tmp_path):
    sr = 8000
    left = 0.8 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)
    inter = np.empty(2 * len(left))
    inter[0::2], inter[1::2] = left, 0.0
    path = tmp_path / "stereo.wav"
    JT.TestWavFormats()._write(path, inter, sr, 2, n_channels=2)
    got, _ = TM.load_audio_file(path, duration=None)
    np.testing.assert_array_equal(got, JM.load_audio_file(path, None)[0])
    np.testing.assert_allclose(got, left / 2, atol=1e-3)


def test_non_wav_is_refused(tmp_path):
    for module in (TM, JM):
        with pytest.raises(ValueError, match="WAV only"):
            module.load_audio_file(tmp_path / "song.mp3")
    assert TM.load_librosa_file is TM.load_audio_file


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (512, 128), (1024, 300)])
@pytest.mark.parametrize("track", list(TRACKS))
def test_stft_matches_jax(track, n_fft, hop):
    y, _ = TRACKS[track]()
    got = TM.compute_stft(y, n_fft, hop, device="cpu")
    want = np.asarray(JM.compute_stft(y, n_fft, hop))
    assert got.shape == want.shape == (n_fft // 2 + 1,
                                       1 + len(y) // hop)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=STFT_RTOL,
                               atol=STFT_ATOL * float(want.max()))


@pytest.mark.parametrize("track", list(TRACKS))
def test_tempo_onsets_and_syncopation_match_jax(track):
    y, sr = TRACKS[track]()
    bpm, beats, intervals = TM.compute_bpm_and_beat_times_and_intervals(
        y, sr, verbose=False, device="cpu")
    j_bpm, j_beats, j_intervals = \
        JM.compute_bpm_and_beat_times_and_intervals(y, sr, verbose=False)
    assert bpm == j_bpm
    np.testing.assert_array_equal(beats, j_beats)
    np.testing.assert_array_equal(intervals, j_intervals)
    onsets = TM.compute_onset_times(y, sr, device="cpu")
    np.testing.assert_array_equal(onsets, JM.compute_onset_times(y, sr))
    assert TM.compute_ioi_entropy_and_var_coefficient(onsets, False) == \
        JM.compute_ioi_entropy_and_var_coefficient(onsets, False)
    sync = TM.compute_syncopation_degree(beats, onsets, intervals, False)
    assert sync == JM.compute_syncopation_degree(beats, onsets, intervals,
                                                 False)
    planted = 96 if track == "click_96_8s" else 120
    assert abs(bpm - planted) < 6 or abs(bpm - planted / 2) < 3
    assert len(onsets) >= 10
    if track == "syncopated_120":
        assert sync[1] > 0     # some onsets fall off the beat grid


def test_short_and_empty_inputs_match_jax():
    y = np.zeros(1024, np.float32)
    for module in (TM, JM):
        kw = {"device": "cpu"} if module is TM else {}
        bpm, beats, ivals = module.compute_bpm_and_beat_times_and_intervals(
            y, 22050, verbose=False, **kw)
        assert np.isnan(bpm) and len(beats) == len(ivals) == 0
        assert module.compute_onset_times(y[:512], 22050, **kw).size == 0
        assert module.compute_ioi_entropy_and_var_coefficient([1.0]) == \
            (None, None)
        assert module.compute_syncopation_degree([], [], []) == (None, None)


def test_all_features_match_jax(tmp_path):
    y, sr = _syncopated_track(seconds=10)
    path = tmp_path / "t.wav"
    _write_wav(path, y, sr)
    got = TM.compute_all_musical_features(path, duration=8.0, device="cpu")
    want = JM.compute_all_musical_features(path, duration=8.0)
    assert got[0] == want[0]
    for a, b in zip(got[1:3], want[1:3]):      # flux, centroid
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert got[3:] == want[3:]
    S = TM.compute_stft(TM.load_audio_file(path, 8.0)[0], device="cpu")
    np.testing.assert_array_equal(TM.compute_spectral_flux(S, False),
                                  JM.compute_spectral_flux(S, False))
    np.testing.assert_array_equal(
        TM.compute_spectral_centroid(S, sr, False),
        JM.compute_spectral_centroid(S, sr, False))


def test_spotify_controller_noop_mode(tmp_path, capsys):
    sel = tmp_path / "music_selection.txt"
    sel.write_text("Happy --- spotify:track:aaa, spotify:track:bbb\n"
                   "Sad --- spotify:track:ccc\n")
    ctl, ref = TM.SpotifyController(sel), JM.SpotifyController(sel)
    assert ctl.category_url_dict == ref.category_url_dict
    assert [ctl.play_next_from("Happy") for _ in range(3)] == \
        [ref.play_next_from("Happy") for _ in range(3)] == \
        ["spotify:track:aaa", "spotify:track:bbb", "spotify:track:aaa"]
    assert ctl.play_next_from("Unknown") is None
    assert ctl.get_current_track() == ref.get_current_track()
    assert ctl.get_current_track()["Title"] is None
    assert ctl.status_string() == "No track playing currently."
    ctl.play(), ctl.pause()
    assert "noop" in capsys.readouterr().out
    assert TM.SpotifyController().category_url_dict == {}


def test_add_metrics_from_txt_matches_jax(tmp_path, monkeypatch):
    """Without osascript every lookup is empty (title ``None``), so the
    inner join keeps no row, in both packages."""
    sel = tmp_path / "music_selection.txt"
    sel.write_text("Happy --- spotify:track:aaa\n")
    frame = pd.DataFrame({"BPM": [120.0, 90.0]},
                         index=["None - None", "Other"])
    for module in (TM, JM):
        monkeypatch.setattr(module.time, "sleep", lambda s: None)
    got = TM.add_metrics_from_txt(frame, sel)
    pd.testing.assert_frame_equal(got, JM.add_metrics_from_txt(frame, sel))
    assert got.empty and {"Title", "Artist", "BPM_manual"} <= set(got)


def test_lookup_table_matches_jax(tmp_path):
    """``build_song_characteristics_table`` over a folder of WAVs."""
    audio = tmp_path / "audio"
    audio.mkdir()
    for i, (name, make) in enumerate(TRACKS.items()):
        _write_wav(audio / f"{name} - Artist {i}.wav", *make())
    _write_wav(audio / "untitled.wav", *_click_track(seconds=6, bpm=100))
    got = TMW.build_song_characteristics_table(audio, save_dir=tmp_path,
                                               duration=8.0, device="cpu")
    want = JMW.build_song_characteristics_table(audio, duration=8.0)
    float_cols = ["Spectral Flux Mean", "Spectral Flux Std.",
                  "Spectral Centroid Mean"]
    rest = [c for c in got.columns if c not in float_cols]
    pd.testing.assert_frame_equal(got[rest], want[rest])
    np.testing.assert_allclose(got[float_cols].to_numpy(float),
                               want[float_cols].to_numpy(float), rtol=1e-4)
    assert got["Artist"].tolist()[-1] == "Unknown" and len(got) == 4
    saved = filemgmt.most_recent_file(tmp_path, ".csv",
                                      ["Song Characteristics Lookup Table"])
    assert len(pd.read_csv(saved)) == 4


def test_extend_lookup_table_matches_jax(tmp_path):
    """Each package extends its own copy of the table: the extended table
    it saves would be the other's newest "Song Characteristic" file."""
    table = JT.TestMusicWorkflowBlocks()._table(4).reset_index()
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        table.to_csv(tmp_path / name / filemgmt.file_title(
            "Song Characteristic Lookup Table", ".csv"), index=False)
    _write_wav(tmp_path / "extra_song.wav", *_click_track(seconds=8))
    entry = [("extra_song.wav", "Artist X", "Extra Song", "Familiar Happy",
              "Pop", "spotify:xyz", 10.0)]
    got = TMW.extend_lookup_table(tmp_path / "port",
                                  single_files_to_add=entry,
                                  audio_dir=tmp_path, duration=8.0,
                                  device="cpu")
    want = JMW.extend_lookup_table(tmp_path / "jax",
                                   single_files_to_add=entry,
                                   audio_dir=tmp_path, duration=8.0)
    spectral = [c for c in got.columns if c.startswith("Spectral")]
    rest = [c for c in got.columns if c not in spectral]
    pd.testing.assert_frame_equal(got[rest], want[rest])
    np.testing.assert_allclose(got[spectral].to_numpy(float),
                               want[spectral].to_numpy(float), rtol=1e-4)
    assert got.loc["extra_song.wav", "Artist"] == "Artist X"
    assert len(got) == 5


@pytest.mark.parametrize("n,k", [(16, 3), (12, 4)])
def test_cluster_song_features_matches_jax(tmp_path, n, k):
    """K-means and the PCA fallback (no umap here) are seeded."""
    table = JT.TestMusicWorkflowBlocks()._table(n)
    got = TMW.cluster_song_features(table, k=k, save_dir=tmp_path)
    want = JMW.cluster_song_features(table, k=k)
    for key in ("labels", "centroids", "embedding"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["embedding_method"] == want["embedding_method"] == "PCA"
    assert got["feature_labels"] == want["feature_labels"]
    assert len(set(got["labels"])) == k
    assert len(list(tmp_path.glob("*Song Feature Clusters PCA.png"))) == 1


def test_cluster_song_features_needs_k_rows():
    table = JT.TestMusicWorkflowBlocks()._table(3)
    for module in (TMW, JMW):
        with pytest.raises(ValueError, match="at least k=4"):
            module.cluster_song_features(table, k=4)


def test_mi_and_scatters_match_jax(tmp_path):
    table = JT.TestMusicWorkflowBlocks()._table(20, seed=1).reset_index()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = TMW.music_feature_mi_and_scatters(table,
                                            save_dir=tmp_path / "port")
    want = JMW.music_feature_mi_and_scatters(table,
                                             save_dir=tmp_path / "jax")
    assert got == want and len(got) == len(TMW.MUSIC_FEATURE_LABELS)
    names = [sorted(p.name[20:] for p in (tmp_path / k).glob("*.png"))
             for k in ("port", "jax")]
    assert names[0] == names[1] and len(names[0]) == 3


def test_category_reassignments_match_jax(tmp_path):
    frame = pd.DataFrame({
        "Category or Silence": ["Happy", "Sad", "Silence", "Happy",
                                "Classic"],
        "Perceived Category": ["Happy", "Happy", "Sad", None, "Sad"]})
    got = TMW.analyse_category_reassignments(frame, save_dir=tmp_path)
    want = JMW.analyse_category_reassignments(frame)
    pd.testing.assert_frame_equal(got[1], want[1])
    assert int(got[1].values.sum()) == 3
    empty = frame.assign(**{"Perceived Category": None})
    assert TMW.analyse_category_reassignments(empty) is None
