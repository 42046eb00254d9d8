"""Cells that call ``mba_tpu_torch.ops.cohort_null.
cohort_msc_rotation_null``: the cohort's family-wise null of the mean
MSC by taper rotation.

Traffic keys: ``recordings``, ``recording`` and ``inputs`` as in
``multitaper_msc`` (each recording a cohort with a subject axis);
``args`` (further keyword arguments, such as ``coeff_engine``) and
``check``.  Call i draws its surrogates with the seed
:func:`call_seed` (run seed, i).  Where the configuration records a
session of ``trials``, the call's windows are its task windows
(:func:`task_windows`), handed to the program as ``window_starts`` and
``window_weights`` and to the reference as they are.
"""
from __future__ import annotations

import numpy as np

from benchmarks.entries.multitaper_msc import Entry as _Recordings
from benchmarks.harness.signals import trial_starts
from benchmarks.reference import null
from benchmarks.reference.spectra import tapers
from benchmarks.work.null_surrogate import pass_work


def call_seed(seed: int, i: int) -> int:
    """A 32-bit seed for call i of a run with ``seed``."""
    return int(np.random.SeedSequence([seed % 2**64, i])
               .generate_state(1)[0])


def task_windows(rec: dict, window_samples: int, hop: int) -> np.ndarray:
    """Starts (samples) of the windows that lie wholly inside a trial, at
    the hop, trial by trial (``bench.py:351-356``)."""
    fs = rec["sampling_hz"]
    span = int(rec["trials"]["seconds"] * fs)
    return np.concatenate([
        int(t0 * fs) + np.arange(0, span - window_samples + 1, hop)
        for t0 in trial_starts(rec)]).astype(np.int64)


class Entry(_Recordings):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.seed = seed
        self.params.update(band=tuple(config["band_hz"]),
                           n_surrogates=config["surrogates"],
                           surrogate_chunk=config["surrogate_chunk"])
        self.starts = None
        if "trials" in self.rec:
            ws = int(self.params["window_sec"] * self.params["fs"])
            self.starts = task_windows(
                self.rec, ws, int(ws * (1 - self.params["overlap"])))

    def call(self, i: int, traced: bool, **extra):
        from mba_tpu_torch.ops.cohort_null import cohort_msc_rotation_null
        eeg, emg, _ = self.inputs[i % len(self.inputs)]
        p = self.params
        windows = {}
        if self.starts is not None:
            starts = np.tile(self.starts[None], (len(eeg), 1))
            windows = {"window_starts": starts,
                       "window_weights": np.ones(starts.shape, np.float32)}
        res = cohort_msc_rotation_null(
            eeg, emg, p["fs"], n_surrogates=p["n_surrogates"], nw=p["nw"],
            window_length_sec=p["window_sec"], overlap_frac=p["overlap"],
            taper_eigenvalue_threshold=p["taper_threshold"], band=p["band"],
            surrogate_chunk=p["surrogate_chunk"],
            seed=call_seed(self.seed, i), device=self.device, **windows,
            **{**self.traffic.get("args", {}), **extra})
        return res, res["metadata"]["timings"]

    def keep(self, res) -> dict:
        return {k: res[k] for k in ("observed", "max_stat", "p_uncorrected",
                                    "p_fwe")}

    def reference(self, i: int, control: bool = False) -> dict:
        """The reference's null of call i (``control``: in the precision
        below the configuration's, float32 with TF32 operands)."""
        eeg, emg, _ = self.inputs[i % len(self.inputs)]
        return null.cohort_null(eeg, emg, self.params,
                                call_seed(self.seed, i), self.device,
                                starts=self.starts, control=control)

    def control(self, i: int) -> dict:
        """The reference in the precision below the configuration's,
        kept as the program's results are."""
        ref = self.reference(i, control=True)
        n = ref["n_drawn"]
        return {"observed": ref["observed"], "p_fwe": ref["p_fwe"],
                "max_stat": ref["max_stat"],
                "p_uncorrected": (1.0 + ref["counts"]) / (1.0 + n)}

    def check(self, i: int, kept: dict, ref: dict | None = None) -> dict:
        return null.compare(kept, ref or self.reference(i))

    def _shapes(self):
        p = self.params
        ws = int(p["window_sec"] * p["fs"])
        K = len(tapers(ws, p["nw"], p["taper_threshold"]))
        lo, hi = null.band_bins(ws, p["fs"], p["band"])
        J, _, E = self.inputs[0][0].shape
        return K, hi - lo, J, E, self.inputs[0][1].shape[2]

    def units(self) -> dict:
        return {"surrogates": self.params["n_surrogates"]}

    def work(self) -> dict:
        K, nF, J, E, M = self._shapes()
        S = int(min(self.params["surrogate_chunk"],
                    self.params["n_surrogates"]))
        n_drawn = -(-self.params["n_surrogates"] // S) * S
        return {"surrogate": pass_work(n_drawn, S, nF, J * K * (K - 1),
                                       E * M)}
