"""Experiment orchestrator: the event-driven phase machine (a host copy of
``mba_tpu/acquisition/experiment.py``).

Parity target: reference ``src/experiment_workflow.py:43-729``
(``start_experiment_processes``): TxtConfig-driven parameters, serial
probe with dummy fallback, Manager dict / events / SharedStrings, MVC
calibration, test task, randomised music/silence trials with song-info +
familiarity + post-trial-rating JSONs and the accuracy sampler, triple-tier
log saving, and graceful teardown.  The interactive matplotlib GUIs of the
reference are replaced by a programmable controller hook so the full phase
machine runs headless (the experiment log rows, JSON artifacts and CSV
formats are identical — downstream integration consumes them unchanged).
"""
from __future__ import annotations

import json
import multiprocessing as mp
import random
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import pandas as pd

from mba_tpu_torch.acquisition.sampling import (sampling_process,
                                          dummy_sampling_process,
                                          accuracy_sampler,
                                          dynamometer_volt_to_force,
                                          probe_serial_device)
from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.utils.multiprocessing_tools import save_terminate_process
from mba_tpu_torch.pipeline.music_control import SpotifyController


@dataclass
class ExperimentConfig:
    """Experiment parameters (reference config/experiment_config.txt,
    parsed at experiment_workflow.py:85-136)."""
    subject_id: int = 0
    output_dir: Path = Path("experiment_output")
    serial_sampling_rate_hz: float = 1000.0
    display_refresh_rate_hz: float = 30.0
    trial_duration_sec: float = 45.0
    n_trials_per_category: int = 1
    categories: list[str] = field(default_factory=lambda: [
        "Happy", "Groovy", "Sad", "Classic"])
    n_silence_trials: int = 2
    task_frequencies_hz: list[float] = field(
        default_factory=lambda: [0.05, 0.1])
    target_min_pct_mvc: float = 7.5
    target_max_pct_mvc: float = 22.5
    mvc_calibration_sec: float = 5.0
    music_selection_txt: Path | None = None
    dummy_mode: bool | None = None   # None = auto-probe
    accuracy_sampling_rate_hz: float = 10.0
    trial_breakout_sec: float = 0.0

    @classmethod
    def from_txt(cls, path) -> "ExperimentConfig":
        from mba_tpu_torch.utils.file_management import TxtConfig
        cfg = TxtConfig(path)
        d = cfg.settings_dict
        kwargs = {}
        if "Serial Sampling Rate" in d:
            kwargs["serial_sampling_rate_hz"] = cfg.get_as_type(
                "Serial Sampling Rate", "float")
        if "Display Refresh Rate" in d:
            kwargs["display_refresh_rate_hz"] = cfg.get_as_type(
                "Display Refresh Rate", "float")
        if "Trial Duration" in d:
            kwargs["trial_duration_sec"] = cfg.get_as_type(
                "Trial Duration", "float")
        if "Categories" in d:
            kwargs["categories"] = cfg.get_as_type("Categories",
                                                   "str_list")
        return cls(**kwargs)


class ExperimentLog:
    """The experiment's system-of-record: Time/Music/Event/Questionnaire
    rows with WorkMem/interim/final save tiers (reference
    measurements_and_interactive_visuals.py:2088-2167)."""

    def __init__(self, log_dir: Path):
        self.log_dir = Path(log_dir)
        filemgmt.assert_dir(self.log_dir)
        self.rows: list[dict] = []
        self._n_workmem = 0

    def append(self, music: str = "No track playing currently.",
               event: str = "", questionnaire: str = "") -> None:
        self.rows.append({"Time": pd.Timestamp.now(), "Music": music,
                          "Event": event, "Questionnaire": questionnaire})

    def save_workmem(self) -> None:
        pd.DataFrame(self.rows).to_csv(
            self.log_dir / filemgmt.file_title(
                "Experiment Log Working Memory Full Save", ".csv"),
            index=False)
        self.rows = []
        self._n_workmem += 1

    def save_interim(self) -> None:
        pd.DataFrame(self.rows).to_csv(
            self.log_dir / filemgmt.file_title(
                "Experiment Log Interim Save", ".csv"), index=False)

    def save_final(self) -> None:
        pd.DataFrame(self.rows).to_csv(
            self.log_dir / filemgmt.file_title(
                "Experiment Log Final Full Save", ".csv"), index=False)


def calibrate_mvc(shared_dict, duration_sec: float = 5.0,
                  poll_hz: float = 50.0) -> float:
    """MVC = maximum force during the calibration hold
    (reference experiment_workflow.py:206-270)."""
    t_end = time.monotonic() + duration_sec
    max_force = 0.0
    while time.monotonic() < t_end:
        volts = shared_dict.get("fsr")
        if volts is not None:
            max_force = max(max_force,
                            dynamometer_volt_to_force(volts))
        time.sleep(1.0 / poll_hz)
    return max_force


def _write_json(path: Path, title: str, payload: dict) -> None:
    filemgmt.assert_dir(path)
    with open(path / filemgmt.file_title(title, ".json"), "w") as f:
        json.dump(payload, f, indent=4)


def start_experiment_processes(config: ExperimentConfig,
                               controller=None,
                               time_scale: float = 1.0) -> dict:
    """Run the full experiment phase machine (reference :43-729).

    ``controller`` supplies the answers the reference collected through
    GUI forms; it may implement any of: ``onboarding()``,
    ``offboarding()``, ``familiarity(song_info)``,
    ``post_trial_rating(trial_label)`` → dicts.  Defaults produce neutral
    placeholder answers, so the machine runs fully unattended (the dummy
    sampler analog of the reference's GUI stack).

    ``time_scale`` < 1 shrinks every wait (fast tests).
    """
    cfg = config
    out_dir = Path(cfg.output_dir) / f"subject_{cfg.subject_id:02}"
    serial_dir = out_dir / "serial_measurements"
    log_dir = out_dir / "experiment_logs"
    filemgmt.assert_dir(serial_dir)

    controller = controller or _DefaultController()
    log = ExperimentLog(log_dir)

    # ── processes & shared state (reference :148-204) ─────────────────
    manager = mp.Manager()
    shared = manager.dict()
    stop_event = manager.Event()
    start_trigger = manager.Event()
    stop_trigger = manager.Event()

    device = (None if cfg.dummy_mode else probe_serial_device())
    use_dummy = cfg.dummy_mode if cfg.dummy_mode is not None \
        else device is None
    target = dummy_sampling_process if use_dummy else sampling_process
    kwargs = dict(shared_dict=shared, stop_event=stop_event,
                  save_dir=serial_dir,
                  start_trigger_event=start_trigger,
                  stop_trigger_event=stop_trigger)
    if not use_dummy:
        kwargs["serial_device"] = device
        kwargs["sampling_rate_hz"] = cfg.serial_sampling_rate_hz
    sampler = mp.Process(target=target, kwargs=kwargs, daemon=True)
    sampler.start()

    spotify = SpotifyController(cfg.music_selection_txt)
    trial_dur = cfg.trial_duration_sec * time_scale
    results = {"trials": [], "mvc_kg": None}

    try:
        # ── onboarding (reference :321-346) ───────────────────────────
        onboarding = controller.onboarding()
        _write_json(out_dir, "Subject Data", onboarding)
        log.append(event="Onboarding complete")

        # ── start trigger → Teensy raises TRIG pin ────────────────────
        start_trigger.set()
        log.append(event="Start Trigger")

        # ── MVC calibration (reference :206-270) ──────────────────────
        log.append(event="MVC calibration start")
        mvc = calibrate_mvc(shared,
                            duration_sec=cfg.mvc_calibration_sec
                            * time_scale)
        results["mvc_kg"] = mvc
        log.append(event=f"MVC calibrated: {mvc:.2f} kg")

        # ── test task (excluded from trials; reference :477-500) ──────
        log.append(questionnaire="Starting test motor task with target "
                                 f"frequency "
                                 f"{cfg.task_frequencies_hz[0]:.2f}Hz")
        time.sleep(min(2.0, trial_dur) * 0.2)
        log.append(questionnaire="Test task complete")

        # ── trial schedule: randomised categories + silences ──────────
        schedule = (cfg.categories * cfg.n_trials_per_category
                    + ["Silence"] * cfg.n_silence_trials)
        random.Random(cfg.subject_id).shuffle(schedule)

        song_counter = 0
        silence_counter = 0
        for trial_idx, category in enumerate(schedule):
            task_freq = cfg.task_frequencies_hz[
                trial_idx % len(cfg.task_frequencies_hz)]
            if category == "Silence":
                label = f"silence_{silence_counter:03}"
                music_status = "No track playing currently."
                silence_counter += 1
                trial_dir = out_dir / label
            else:
                label = f"song_{song_counter:03}"
                trial_dir = out_dir / label
                uri = spotify.play_next_from(category)
                n_in_cat = len(spotify.category_url_dict.get(category,
                                                             [1]) or [1])
                title, artist = f"Track{song_counter}", "Artist"
                music_status = (f"{category} (1/{n_in_cat}) | {title} by "
                                f"{artist} | 10s / 180s")
                _write_json(trial_dir, "song information",
                            {"Title": title, "Artist": artist,
                             "Album": None, "Genre": None,
                             "Duration [ms]": 180000, "BPM": None,
                             "URI": uri})
                fam = controller.familiarity(music_status)
                _write_json(trial_dir, "Familiarity Check", fam)
                log.append(music=music_status,
                           questionnaire=f"Familiarity check result: "
                                         f"{fam.get('Familiarity', 3)}")
                song_counter += 1

            # motor task + accuracy sampler (reference :545-696)
            log.append(music=music_status,
                       questionnaire=f"Starting motor task with target "
                                     f"frequency {task_freq:.2f}Hz")
            acc_stop = manager.Event()
            acc_proc = mp.Process(
                target=accuracy_sampler,
                kwargs=dict(shared_dict=shared, stop_event=acc_stop,
                            trial_dir=trial_dir,
                            target_frequency_hz=task_freq,
                            min_pct_mvc=cfg.target_min_pct_mvc,
                            max_pct_mvc=cfg.target_max_pct_mvc,
                            mvc_kg=max(results["mvc_kg"] or 30.0, 1.0),
                            sampling_rate_hz=
                            cfg.accuracy_sampling_rate_hz,
                            start_offset_sec=5.5 * time_scale,
                            run_for_sec=trial_dur),
                daemon=True)
            acc_proc.start()
            t_end = time.monotonic() + trial_dur
            while time.monotonic() < t_end:
                log.append(music=music_status)
                time.sleep(max(trial_dur / 10, 0.01))
            acc_stop.set()
            acc_proc.join(timeout=10)

            # read back RMSE from the accuracy CSV
            try:
                acc_path = filemgmt.most_recent_file(
                    trial_dir, ".csv", ["Trial Accuracy Results"])
                sq = pd.read_csv(acc_path).iloc[:, -1]
                rmse = float(np.sqrt(np.mean(sq))) if len(sq) else np.nan
            except ValueError:
                rmse = np.nan
            log.append(music=music_status,
                       questionnaire=f"Achieved RMSE: {rmse:.3f}")

            rating = controller.post_trial_rating(label)
            _write_json(trial_dir, "Post-Trial Rating", rating)
            log.append(questionnaire=str(rating))
            _write_json(trial_dir, "Trial Summary",
                        {"label": label, "category": category,
                         "task_freq": task_freq, "rmse": rmse})
            results["trials"].append({"label": label,
                                      "category": category,
                                      "rmse": rmse})
            log.save_interim()
            if cfg.trial_breakout_sec:
                time.sleep(cfg.trial_breakout_sec * time_scale)

        # ── stop trigger + offboarding + teardown (reference :702-726) ─
        stop_trigger.set()
        log.append(event="Stop Trigger")
        offboarding = controller.offboarding()
        _write_json(out_dir, "Post-Study Feedback Data", offboarding)
        log.append(event="Offboarding complete")
    finally:
        stop_event.set()
        save_terminate_process(sampler, stop_event)
        log.save_final()

    return results


class _DefaultController:
    """Neutral stand-in for the reference's GUI questionnaire forms."""

    def onboarding(self) -> dict:
        return {"Name": "Anonymous", "Birthdate": "2000-01-01",
                "Gender": "diverse", "Dominant hand": "Right",
                "Listening habit": "A small part of the day",
                "Dancing habit": 1, "Athleticism": 2, "Musical skill": 2}

    def offboarding(self) -> dict:
        return {"Total fatigue": 2, "Total pleasure": 3}

    def familiarity(self, song_info: str) -> dict:
        return {"Familiarity": 3}

    def post_trial_rating(self, trial_label: str) -> dict:
        return {"Liking": 3, "Fitting Category": 3, "Emotional State": 3}
