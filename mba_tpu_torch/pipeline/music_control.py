"""Music-stimulus control + native audio feature extraction.

Parity target: reference ``src/pipeline/music_control.py`` (803 LoC):

- :class:`SpotifyController` — macOS AppleScript (osascript) play/pause/
  skip/track-info with category playlists parsed from
  ``config/music_selection.txt`` (:28-345).  Degrades gracefully off-macOS.
- Audio features (the reference used librosa; implemented natively here,
  the STFT framed and transformed on the device):
  BPM + beat tracking (:383-421), STFT (:424), spectral flux (:453),
  spectral centroid (:490), onset detection (:524), IOI entropy/CV
  (:550-607), syncopation degree/ratio (:610-684), bundled
  :func:`compute_all_musical_features` (:687-770) and
  :func:`add_metrics_from_txt` (:773-800).

Audio loading uses the stdlib's WAV reader (mp3/m4a decoding is out of scope
without external decoders; the study's lookup-table workflow accepts WAV).

Port of ``mba_tpu/pipeline/music_control.py``: the STFT frames the
signal on ``device`` (the card unless ``"cpu"``) and takes torch's rFFT
there; ``device=`` reaches it through every feature that needs it.  The
Spotify control, the WAV loader and the peak picking are host copies.
"""
from __future__ import annotations

import shutil
import subprocess
import time
import wave
from pathlib import Path

import numpy as np
import pandas as pd

import torch

from mba_tpu_torch._device import entry_device, to_device
from mba_tpu_torch.ops.framing import frame_signal
from mba_tpu_torch.utils.file_management import TxtConfig


# ══════════════════════════════════════════════════════════════════════
#  Spotify control (host / macOS)
# ══════════════════════════════════════════════════════════════════════
class SpotifyController:
    """AppleScript-driven Spotify control with category playlists.

    Playlist DSL (reference :79-138): ``config/music_selection.txt`` maps
    ``CATEGORY --- url1, url2, ...``.  On systems without ``osascript``
    every command becomes a logged no-op so the acquisition pipeline can
    run with the dummy sampler.
    """

    def __init__(self, music_selection_txt: str | Path | None = None):
        self.category_url_dict: dict[str, list[str]] = {}
        self._position: dict[str, int] = {}
        if music_selection_txt is not None:
            self._load_selection(music_selection_txt)
        self._osascript = shutil.which("osascript")
        if self._osascript is None:
            print("[SpotifyController] osascript not available — running "
                  "in no-op mode (non-macOS host).")

    def _load_selection(self, path: str | Path) -> None:
        cfg = TxtConfig(path)
        for category, value in cfg.settings_dict.items():
            urls = [u.strip() for u in value.split(',') if u.strip()]
            self.category_url_dict[category] = urls
            self._position[category] = 0

    # ── low-level AppleScript ────────────────────────────────────────
    def _run_applescript(self, script: str) -> str | None:
        if self._osascript is None:
            print(f"[SpotifyController noop] {script.splitlines()[0]}")
            return None
        out = subprocess.run([self._osascript, "-e", script],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(f"[SpotifyController] osascript error: {out.stderr}")
            return None
        return out.stdout.strip()

    # ── transport ────────────────────────────────────────────────────
    def play(self) -> None:
        self._run_applescript('tell application "Spotify" to play')

    def pause(self) -> None:
        self._run_applescript('tell application "Spotify" to pause')

    def play_track(self, uri: str) -> None:
        self._run_applescript(
            f'tell application "Spotify" to play track "{uri}"')

    def play_next_from(self, category: str) -> str | None:
        """Play the next track of a category playlist (round-robin)."""
        urls = self.category_url_dict.get(category)
        if not urls:
            print(f"[SpotifyController] Unknown category '{category}'")
            return None
        idx = self._position[category] % len(urls)
        self._position[category] += 1
        self.play_track(urls[idx])
        return urls[idx]

    def get_current_track(self) -> dict:
        """Current track metadata dict (Title/Artist/BPM/Genre/...)."""
        raw = self._run_applescript(
            'tell application "Spotify"\n'
            'set t to name of current track\n'
            'set a to artist of current track\n'
            'set al to album of current track\n'
            'set d to duration of current track\n'
            'return t & "|" & a & "|" & al & "|" & d\n'
            'end tell')
        if raw is None:
            return {"Title": None, "Artist": None, "Album": None,
                    "Duration [ms]": None, "BPM": None, "Genre": None,
                    "File Title": None}
        parts = raw.split("|")
        title = parts[0] if parts else None
        artist = parts[1] if len(parts) > 1 else None
        return {"Title": title, "Artist": artist,
                "Album": parts[2] if len(parts) > 2 else None,
                "Duration [ms]": (float(parts[3])
                                  if len(parts) > 3 else None),
                "BPM": None, "Genre": None,
                "File Title": f"{title} - {artist}"}

    def status_string(self) -> str:
        """Status line in the acquisition GUI's 'CATEGORY (i/n) | Song by
        Artist | 10s / 180s' grammar."""
        track = self.get_current_track()
        if track["Title"] is None:
            return "No track playing currently."
        return f"{track['Title']} by {track['Artist']} | 0s / 0s"


# ══════════════════════════════════════════════════════════════════════
#  audio loading & spectral features (native librosa replacement)
# ══════════════════════════════════════════════════════════════════════
def load_audio_file(file_path, duration: float | None = 120.0
                    ) -> tuple[np.ndarray, int]:
    """Load mono float32 waveform + sample rate from a WAV file.

    Replaces the reference's mutagen+librosa loader (:350-380); WAV is
    read via the stdlib, other codecs require external decoding.
    """
    file_path = Path(file_path)
    if file_path.suffix.lower() != ".wav":
        raise ValueError(
            f"Native loader supports WAV only, got '{file_path.suffix}'. "
            f"Convert compressed audio to WAV first.")
    with wave.open(str(file_path), "rb") as wav:
        sr = wav.getframerate()
        n_channels = wav.getnchannels()
        sampwidth = wav.getsampwidth()
        n_frames = wav.getnframes()
        if duration is not None:
            n_frames = min(n_frames, int(duration * sr))
        raw = wav.readframes(n_frames)
    if sampwidth == 3:
        # 24-bit PCM: sign-extend into int32 (no native numpy dtype)
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        y = (b[:, 0].astype(np.int32)
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        y = np.where(y >= 1 << 23, y - (1 << 24), y).astype(np.float32)
        y = y / float(1 << 23)
    else:
        try:
            dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[sampwidth]
        except KeyError:
            raise ValueError(f"Unsupported WAV sample width: "
                             f"{sampwidth} bytes")
        y = np.frombuffer(raw, dtype=dtype).astype(np.float32)
        if sampwidth == 1:
            y = (y - 128.0) / 128.0
        else:
            y = y / float(2 ** (8 * sampwidth - 1))
    if n_channels > 1:
        y = y.reshape(-1, n_channels).mean(axis=1)
    return y, sr


load_librosa_file = load_audio_file  # reference-compatible alias


def compute_stft(y: np.ndarray, n_fft: int = 2048,
                 hop_length: int = 512, device=None) -> np.ndarray:
    """Magnitude STFT (n_fft//2+1, n_frames) — framing + rFFT on
    ``device``, downloaded once.

    Centered frames with reflect padding and a periodic Hann window
    (librosa.stft conventions; reference :424-450).
    """
    device = entry_device(device)
    y = np.asarray(y, np.float32)
    pad = n_fft // 2
    y_pad = np.pad(y, pad, mode="reflect")
    n_frames = 1 + (len(y_pad) - n_fft) // hop_length
    starts = np.arange(n_frames) * hop_length
    frames = frame_signal(to_device(y_pad[:, None], device), starts, n_fft)
    window = torch.as_tensor(
        (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
         ).astype(np.float32), device=device)
    spec = torch.fft.rfft(frames[:, :, 0] * window[None, :], dim=1).abs()
    return spec.cpu().numpy().T


def compute_spectral_flux(S: np.ndarray, verbose: bool = True
                          ) -> np.ndarray:
    """Normalized L2 spectral flux (reference :453-487)."""
    flux = np.sqrt(np.sum(np.diff(S, axis=1) ** 2, axis=0))
    flux = flux / max(np.max(flux), 1e-20)
    if verbose:
        print(f"Spectral flux: mean {flux.mean():.3f}, "
              f"std {flux.std():.3f}")
    return flux


def compute_spectral_centroid(S: np.ndarray, sr: float,
                              verbose: bool = True) -> np.ndarray:
    """Per-frame spectral centroid in Hz (reference :490-521)."""
    freqs = np.linspace(0, sr / 2, S.shape[0])
    denom = np.maximum(S.sum(axis=0), 1e-20)
    centroid = (freqs[:, None] * S).sum(axis=0) / denom
    if verbose:
        print(f"Spectral centroid: mean {centroid.mean():.1f} Hz")
    return centroid


def _onset_envelope(y: np.ndarray, sr: float, n_fft: int = 2048,
                    hop_length: int = 512, device=None):
    """Half-wave-rectified log-spectral flux (onset strength)."""
    S = compute_stft(y, n_fft, hop_length, device=device)
    log_s = np.log1p(1000.0 * S)
    diff = np.diff(log_s, axis=1)
    env = np.maximum(diff, 0).sum(axis=0)
    env = env / max(env.max(), 1e-20)
    times = (np.arange(1, len(env) + 1) * hop_length) / sr
    return env, times


def compute_onset_times(y: np.ndarray, sr: float,
                        hop_length: int = 512, device=None) -> np.ndarray:
    """Onset times via adaptive peak-picking on the onset envelope
    (librosa.onset.onset_detect replacement; reference :524-547)."""
    env, times = _onset_envelope(y, sr, hop_length=hop_length,
                                 device=device)
    if len(env) < 3:
        return np.array([])
    # adaptive threshold: local mean + global offset
    kernel = max(3, int(0.1 * sr / hop_length))
    pad = np.pad(env, kernel, mode="edge")
    local_mean = np.convolve(pad, np.ones(2 * kernel + 1)
                             / (2 * kernel + 1), mode="same")[
        kernel:-kernel]
    thresh = local_mean + 0.07
    is_peak = ((env[1:-1] > env[:-2]) & (env[1:-1] >= env[2:])
               & (env[1:-1] > thresh[1:-1]))
    peaks = np.flatnonzero(is_peak) + 1
    # enforce 50 ms minimum inter-onset spacing
    min_gap = 0.05
    kept = []
    for p in peaks:
        if not kept or times[p] - times[kept[-1]] >= min_gap:
            kept.append(p)
    return times[kept] if kept else np.array([])


def compute_bpm_and_beat_times_and_intervals(y: np.ndarray, sr: float,
                                             verbose: bool = True,
                                             device=None):
    """Tempo + beat grid from onset-envelope autocorrelation
    (librosa.beat.beat_track replacement; reference :383-421).

    Tempo: dominant autocorrelation lag in the 60–180 BPM window.
    Beats: the phase of a regular grid at that tempo maximising total
    onset strength.
    """
    hop_length = 512
    env, times = _onset_envelope(y, sr, hop_length=hop_length,
                                 device=device)
    if len(env) < 8:
        return np.nan, np.array([]), np.array([])
    fps = sr / hop_length
    env_c = env - env.mean()
    ac = np.correlate(env_c, env_c, mode="full")[len(env_c) - 1:]
    lag_min = max(1, int(fps * 60 / 180))   # 180 BPM
    lag_max = min(len(ac) - 1, int(fps * 60 / 60))  # 60 BPM
    if lag_max <= lag_min:
        return np.nan, np.array([]), np.array([])
    best_lag = lag_min + int(np.argmax(ac[lag_min:lag_max + 1]))
    period_sec = best_lag / fps

    # optimal beat phase: maximise summed onset strength on the grid
    n_phases = 32
    best_phase, best_score = 0.0, -np.inf
    duration = times[-1]
    for phase in np.linspace(0, period_sec, n_phases, endpoint=False):
        grid = np.arange(phase, duration, period_sec)
        idx = np.clip((grid * fps).astype(int), 0, len(env) - 1)
        score = env[idx].sum()
        if score > best_score:
            best_score, best_phase = score, phase
    beat_times = np.arange(best_phase, duration, period_sec)
    beat_intervals = np.diff(beat_times)
    bpm = 60.0 / np.mean(beat_intervals) if len(beat_intervals) else \
        60.0 / period_sec
    if verbose:
        print(f"BPM: {bpm:.1f}, beats: {len(beat_times)}")
    return bpm, beat_times, beat_intervals


def compute_ioi_entropy_and_var_coefficient(onset_times,
                                            verbose: bool = True):
    """Shannon entropy (20-bin) + CV of inter-onset intervals
    (reference :550-607)."""
    if len(onset_times) > 1:
        ioi = np.diff(onset_times)
        hist, _ = np.histogram(ioi, bins=20, density=True)
        hist = hist / np.sum(hist)
        ioi_entropy = float(-np.sum(hist[hist > 0]
                                    * np.log2(hist[hist > 0])))
        ioi_cv = (float(np.std(ioi) / np.mean(ioi))
                  if np.mean(ioi) > 0 else 0.0)
        if verbose:
            print(f"IOI entropy {ioi_entropy:.3f} bits, CV {ioi_cv:.3f}")
        return ioi_entropy, ioi_cv
    return None, None


def compute_syncopation_degree(beat_times, onset_times, beat_intervals,
                               verbose: bool = True):
    """Mean normalized onset-to-beat distance (×2, capped at 1) + share
    of onsets >0.2 beat intervals off-beat (reference :610-684)."""
    if len(beat_times) > 2 and len(onset_times):
        mean_interval = np.mean(beat_intervals)
        dists = np.array([
            np.abs(onset - beat_times[np.argmin(
                np.abs(beat_times - onset))]) / mean_interval
            for onset in onset_times])
        degree = float(np.mean(dists))
        ratio = float(100 * np.sum(dists > 0.2) / len(dists))
        if verbose:
            print(f"Syncopation degree {min(degree * 2, 1.0):.3f}, "
                  f"ratio {ratio:.1f}%")
        return min(degree * 2, 1.0), ratio
    return None, None


def compute_all_musical_features(audio_path, duration: float = 120.0,
                                 verbose: bool = False, device=None):
    """Bundle: BPM, spectral flux, centroid, IOI CV, syncopation
    (reference :687-770); every STFT runs on ``device``."""
    device = entry_device(device)
    y, sr = load_audio_file(audio_path, duration=duration)
    bpm, beat_times, beat_intervals = \
        compute_bpm_and_beat_times_and_intervals(y, sr, verbose,
                                                 device=device)
    S = compute_stft(y, n_fft=2048, hop_length=512, device=device)
    flux = compute_spectral_flux(S, verbose)
    centroid = compute_spectral_centroid(S, sr, verbose)
    onset_times = compute_onset_times(y, sr, device=device)
    _, ioi_cv = compute_ioi_entropy_and_var_coefficient(onset_times,
                                                        verbose=verbose)
    sync_degree, sync_ratio = compute_syncopation_degree(
        beat_times, onset_times, beat_intervals, verbose=verbose)
    return bpm, flux, centroid, ioi_cv, sync_degree, sync_ratio


def add_metrics_from_txt(characteristics_df: pd.DataFrame,
                         txt_file_path) -> pd.DataFrame:
    """Extend the lookup table with Title/Artist/BPM fetched via Spotify
    (reference :773-800)."""
    controller = SpotifyController(txt_file_path)
    rows = {"Title": [], "Artist": [], "BPM": []}
    file_titles = []
    for category, urls in controller.category_url_dict.items():
        for _ in range(len(urls)):
            controller.play_next_from(category)
            time.sleep(1)
            info = controller.get_current_track()
            rows["Title"].append(info["Title"])
            rows["Artist"].append(info["Artist"])
            rows["BPM"].append(info["BPM"])
            file_titles.append(info["File Title"])
    new_df = pd.DataFrame(index=file_titles, data=rows)
    return characteristics_df.join(new_df, how="inner",
                                   rsuffix="_manual")
