"""Cells that call ``mba_tpu_torch.ops.surrogate.
msc_phase_randomized_null``: the null of one pair's window-averaged MSC
spectrum by FFT phase randomisation of the EMG, with the per-cell
histogram's quantiles and the max statistic.

The recordings come as in ``multitaper_msc`` (``recordings``,
``recording``, ``inputs``); the null's parameters from the configuration
(``surrogates``, ``surrogate_chunk``, ``quantiles``, ``max_stat_only``,
``band_hz``), with the traffic's ``args`` over them; ``check`` as there.
Call i draws its surrogates with the seed
``rotation_null.call_seed(run seed, i)``.
"""
from __future__ import annotations

from benchmarks.entries.multitaper_msc import Entry as _Recordings
from benchmarks.entries.rotation_null import call_seed
from benchmarks.reference import phase_null
from benchmarks.reference.spectra import tapers
from benchmarks.work.phase_null import step_work


class Entry(_Recordings):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        # the null has no jackknife: the recordings' base reads no alpha
        super().__init__({"jackknife_alpha": None, **config}, traffic, seed,
                         device)
        self.seed = seed
        band = config["band_hz"]
        kw = {"n_surrogates": config["surrogates"],
              "surrogate_chunk": config["surrogate_chunk"],
              "quantiles": tuple(config["quantiles"]),
              "max_stat_only": config["max_stat_only"],
              "band": None if band is None else tuple(band)}
        kw.update(traffic.get("args", {}))
        self.kwargs = kw
        self.params.update(kw)

    def call(self, i: int, traced: bool, **extra):
        from mba_tpu_torch.ops.surrogate import msc_phase_randomized_null
        eeg, emg, _ = self.inputs[i % len(self.inputs)]
        p = self.params
        res = msc_phase_randomized_null(
            eeg, emg, p["fs"], nw=p["nw"], window_length_sec=p["window_sec"],
            overlap_frac=p["overlap"],
            taper_eigenvalue_threshold=p["taper_threshold"],
            seed=call_seed(self.seed, i), device=self.device,
            **{**self.kwargs, **extra})
        return res, res["timings"]

    def keep(self, res) -> dict:
        return {"observed": res["observed"], "max_stat": res["max_stat"],
                "null_quantiles": dict(res["null_quantiles"]),
                "p_fwe": res["p_fwe"]}

    def reference(self, i: int, control: bool = False) -> dict:
        """The reference's null of call i (``control``: its window
        spectra rounded to float16, the step below float32)."""
        eeg, emg, _ = self.inputs[i % len(self.inputs)]
        return phase_null.phase_null(eeg, emg, self.params,
                                     call_seed(self.seed, i), self.device,
                                     control=control)

    def control(self, i: int) -> dict:
        """The reference in the precision below the configuration's,
        kept as the program's results are."""
        return self.keep(self.reference(i, control=True))

    def check(self, i: int, kept: dict, ref: dict | None = None) -> dict:
        return phase_null.compare(kept, ref or self.reference(i))

    def _shape(self) -> tuple[int, int, int, int, int, int]:
        """(samples, window samples, windows, tapers, EEG, EMG)."""
        p = self.params
        ws, W = self._windows()
        K = len(tapers(ws, p["nw"], p["taper_threshold"]))
        return (self.n_samples, ws, W, K, self.inputs[0][0].shape[1],
                self.inputs[0][1].shape[1])

    def units(self) -> dict:
        return {"surrogates": self.params["n_surrogates"]}

    def work(self) -> dict:
        S = int(min(self.params["surrogate_chunk"],
                    self.params["n_surrogates"]))
        n_drawn = -(-self.params["n_surrogates"] // S) * S
        return {"phase_null": step_work(n_drawn, *self._shape())}
