"""Cells that call ``mba_tpu_torch.ops.coherence.multitaper_msc``: the
jackknifed CMC of every EEG×EMG pair of one recording.

The recording's length comes from the configuration
(``recording_seconds``, or ``trials`` {count, seconds, silence_seconds}
for a session of trials), and so does its signal model (``assumed``).
Traffic keys: ``recordings`` (how many to generate), ``recording``
(the generator's further parameters: ``arrays``), ``inputs``
(the calls' inputs in turn: {recording, eeg, emg}), ``args`` (further
keyword arguments of the call) and ``check`` {calls_per_input,
limits}.
"""
from __future__ import annotations

import torch

from benchmarks.harness import signals
from benchmarks.reference import cmc
from benchmarks.reference.spectra import tapers
from benchmarks.work.msc_epilogue import step_work


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        rec = {"sampling_hz": config["sampling_hz"],
               "drive": config["assumed"]["drive"]}
        for key, as_key in (("subjects", "subjects"), ("trials", "trials"),
                            ("recording_seconds", "seconds")):
            if key in config:
                rec[as_key] = config[key]
        rec.update(traffic["recording"])
        self.rec = rec
        self.n_samples = signals.session_samples(rec)
        gen = torch.Generator(device).manual_seed(seed)
        recs = [signals.recording(rec, gen, device)
                for _ in range(traffic["recordings"])]
        self.inputs = [(recs[i["recording"]][i["eeg"]],
                        recs[i["recording"]][i["emg"]], i)
                       for i in traffic["inputs"]]
        self.params = {"fs": config["sampling_hz"],
                       "window_sec": config["window_sec"],
                       "overlap": config["overlap"], "nw": config["nw"],
                       "taper_threshold": config["taper_eigenvalue_threshold"],
                       "alpha": config["jackknife_alpha"]}

    # ---- what the call does -------------------------------------------
    def eeg_channels(self) -> int:
        return self.inputs[0][0].shape[1]

    def call(self, i: int, traced: bool, **extra):
        """Call i on input i mod the inputs, with ``extra`` keyword
        arguments; returns (result, spans)."""
        from mba_tpu_torch.ops.coherence import multitaper_msc
        eeg, emg, _ = self.inputs[i % len(self.inputs)]
        p = self.params
        res = multitaper_msc(
            eeg, emg, p["fs"], nw=p["nw"], window_length_sec=p["window_sec"],
            overlap_frac=p["overlap"],
            taper_eigenvalue_threshold=p["taper_threshold"],
            use_jackknife=True, jackknife_alpha=p["alpha"],
            aggregate_emg_max=self.config["emg_max_pool"],
            collect_timings=traced, device=self.device,
            **{**self.traffic.get("args", {}), **extra})
        return res, res.get("timings", {})

    def keep(self, res) -> dict:
        return {"coherence": res["coherence_raw"],
                "lower": res["coherence_ci_lower"],
                "upper": res["coherence_ci_upper"]}

    def control(self, i: int):
        """The program's own lower-precision path: results cast to
        bfloat16 on the device before the download."""
        return self.keep(self.call(i, False,
                                   transfer_dtype=torch.bfloat16)[0])

    # ---- the yardstick ------------------------------------------------
    def check(self, i: int, kept: dict) -> dict:
        eeg, emg, _ = self.inputs[i % len(self.inputs)]
        return cmc.compare(kept, eeg, emg, self.params, self.device)

    def _windows(self) -> tuple[int, int]:
        """(samples per window, windows computed per call)."""
        ws = int(self.params["window_sec"] * self.params["fs"])
        hop = int(ws * (1 - self.params["overlap"]))
        return ws, (self.n_samples - ws) // hop + 1

    def units(self) -> dict:
        """Work units of one call: coherence spectra (active windows ×
        EEG × EMG channels)."""
        _, W = self._windows()
        return {"spectra": W * self.eeg_channels()
                * self.inputs[0][1].shape[1]}

    def work(self) -> dict:
        ws, W = self._windows()
        K = len(tapers(ws, self.params["nw"], self.params["taper_threshold"]))
        return {"spectra_epilogue": step_work(
            W, K, ws, self.eeg_channels(), self.inputs[0][1].shape[1],
            self.n_samples)}
