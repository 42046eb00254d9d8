"""Cells that call ``mba_tpu_torch.pipeline.signal_features.
compute_task_wise_aggregated_cmc``, the entry of the study's per-subject
CMC job (``workflows.subject_feature_extraction_workflow.
extract_cmc_features``): the EEG channel subset against one EMG grid,
over the windows of the session's tasks, with the EMG max-pool fused.

From the configuration: the session of ``trials``, its signal model
(``assumed``), the window and taper parameters, the subset
(``eeg_channel_subset``), the mask's rules (``task_mask``) and the raw
log's cadence (``log``).  At set-up the entry writes the session's raw
experiment log in the acquisition GUI's grammar and enriches it with
the program's ``data_integration.prepare_log_frame``, as the workflow is
given it, one frame a recording.  Each call builds the mask from its
recording's frame; as in the workflow, which fetches a subject's log and
passes it to the flexor call and then the extensor call, the first call
on a recording in each pass over the inputs gets a fresh copy of its
frame, which the program's span table (``data_integration._span_table``,
memoized by the frame's id) has not seen, and the calls after it on the
same recording get that copy.  Set-up ends with one untraced call on
each input after the first (the harness's warm call takes the first), so
that no input meets the program for the first time inside the window.
Traffic keys:
``recordings`` (how many to generate), ``recording`` (the generator's
``arrays``), ``inputs`` (the calls' inputs in turn: {recording, eeg,
emg, muscle}), ``args`` (further keyword arguments of the call) and
``check`` {calls_per_input, limits}.
"""
from __future__ import annotations

import contextlib
import io

import numpy as np
import torch

from benchmarks.harness import signals
from benchmarks.reference import task_cmc
from benchmarks.reference.spectra import tapers
from benchmarks.work.msc_epilogue import step_work

LOG_START = "2024-01-01 12:00:00"


def raw_log(config: dict) -> list[tuple[float, str, str]]:
    """The session's raw log rows, (seconds, event, questionnaire), one
    every ``log.row_seconds``: the Start Trigger on the first, the task's
    start on the row of each trial's start, its RMSE
    ``task_mask.rmse_delay_sec`` after the trial's end (the GUI logs the
    RMSE once it has computed it, in the silence that follows), the Stop
    Trigger on the row after the later of the session's end and the last
    RMSE row."""
    trials, log = config["trials"], config["log"]
    step, delay = log["row_seconds"], config["task_mask"]["rmse_delay_sec"]
    if delay >= trials["silence_seconds"]:
        raise ValueError(f"an RMSE row {delay} s after a trial's end "
                         "falls on or past the next trial's start")
    starts = signals.trial_starts({"trials": trials})
    end = max(signals.session_samples({"sampling_hz": 1, "trials": trials}),
              starts[-1] + trials["seconds"] + delay)
    n_rows = int(round(end / step)) + 2
    text = [""] * n_rows
    for t0 in starts:
        text[int(round(t0 / step))] = (
            "Starting motor task with target frequency "
            f"{log['target_frequency_hz']:.2f}Hz")
        text[int(round((t0 + trials["seconds"] + delay) / step))] = \
            "Achieved RMSE: 0.123"
    event = [""] * n_rows
    event[0], event[-1] = "Start Trigger", "Stop Trigger"
    return [(r * step, event[r], text[r]) for r in range(n_rows)]


def log_frame(rows):
    """The raw rows as the GUI's frame (Time, Music, Questionnaire,
    Event), enriched by the program."""
    import pandas as pd

    from mba_tpu_torch.pipeline.data_integration import prepare_log_frame
    t0 = pd.Timestamp(LOG_START)
    raw = pd.DataFrame({
        "Time": [t0 + pd.Timedelta(seconds=float(t)) for t, _, _ in rows],
        "Music": "No track playing currently.",
        "Questionnaire": [q for _, _, q in rows],
        "Event": [e for _, e, _ in rows]})
    return prepare_log_frame(raw)


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        rec = {"sampling_hz": config["sampling_hz"],
               "drive": config["assumed"]["drive"],
               "trials": config["trials"], **traffic["recording"]}
        self.n_samples = signals.session_samples(rec)
        gen = torch.Generator(device).manual_seed(seed)
        recs = [signals.recording(rec, gen, device)
                for _ in range(traffic["recordings"])]
        self.inputs = [(recs[i["recording"]][i["eeg"]],
                        recs[i["recording"]][i["emg"]], i)
                       for i in traffic["inputs"]]
        self.rows = raw_log(config)
        self.log_frames = [log_frame(self.rows) for _ in recs]
        self.frames: dict[int, object] = {}
        first = {}
        for i, spec in enumerate(traffic["inputs"]):
            first.setdefault(spec["recording"], i)
        self.first_on_recording = set(first.values())
        self.subset = config["eeg_channel_subset"]
        self.mask = config["task_mask"]
        self.params = {"fs": config["sampling_hz"],
                       "window_sec": config["window_sec"],
                       "overlap": config["overlap"], "nw": config["nw"],
                       "taper_threshold": config["taper_eigenvalue_threshold"],
                       "alpha": config["jackknife_alpha"]}
        self.active = task_cmc.active_windows(
            self.n_samples, self.params,
            task_cmc.task_spans(self.rows, self.mask), self.mask)
        with contextlib.redirect_stdout(io.StringIO()):
            for i in range(1, len(self.inputs)):
                self.call(i, False)

    # ---- what the call does -------------------------------------------
    def frame(self, i: int):
        """The log frame of input i's recording: a fresh copy on the first
        input of the recording in a pass, else the copy it got."""
        r = self.inputs[i % len(self.inputs)][2]["recording"]
        if i % len(self.inputs) in self.first_on_recording \
                or r not in self.frames:
            self.frames[r] = self.log_frames[r].copy()
        return self.frames[r]

    def call(self, i: int, traced: bool, **extra):
        """Call i on input i mod the inputs, with ``extra`` keyword
        arguments; returns (result, spans)."""
        from mba_tpu_torch.pipeline.signal_features import \
            compute_task_wise_aggregated_cmc
        eeg, emg, spec = self.inputs[i % len(self.inputs)]
        m, timings = self.mask, ({} if traced else None)
        values, lower, upper, _, _ = compute_task_wise_aggregated_cmc(
            eeg, emg, self.params["fs"], spec["muscle"],
            log_frame=self.frame(i),
            eeg_channel_subset=self.subset["names"],
            window_size_sec=self.params["window_sec"],
            window_overlap_ratio=self.params["overlap"],
            enforce_independence_threshold=self.config[
                "enforce_independence_threshold"],
            use_jackknife=True, jackknife_alpha=self.params["alpha"],
            save_dir=None,
            pre_trial_computation_buffer_sec=m["pre_buffer_sec"],
            post_trial_computation_buffer_sec=m["post_buffer_sec"],
            task_latency_assumption_sec=m["latency_sec"],
            task_end_cutoff_sec=m["end_cutoff_sec"],
            timings_out=timings, device=self.device,
            **{**self.traffic.get("args", {}), **extra})
        return {"coherence": values, "lower": lower, "upper": upper}, \
            timings or {}

    def keep(self, res) -> dict:
        return res

    def control(self, i: int):
        """The program's own lower-precision path: results cast to
        bfloat16 on the device before the download."""
        return self.call(i, False, transfer_dtype=torch.bfloat16)[0]

    # ---- the yardstick ------------------------------------------------
    def check(self, i: int, kept: dict) -> dict:
        eeg, emg, _ = self.inputs[i % len(self.inputs)]
        return task_cmc.compare(kept, eeg, emg, self.subset["indices"],
                                self.active, self.params, self.device)

    def _shape(self) -> tuple[int, int, int, int]:
        """(samples per window, active windows, EEG, EMG channels)."""
        return (int(self.params["window_sec"] * self.params["fs"]),
                int(self.active.sum()), len(self.subset["indices"]),
                self.inputs[0][1].shape[1])

    def units(self) -> dict:
        """Work units of one call: coherence spectra (active windows ×
        EEG subset × EMG channels)."""
        _, W, E, M = self._shape()
        return {"spectra": W * E * M}

    def work(self) -> dict:
        ws, W, E, M = self._shape()
        K = len(tapers(ws, self.params["nw"], self.params["taper_threshold"]))
        return {"spectra_epilogue": step_work(W, K, ws, E, M,
                                              self.n_samples)}
