"""Cells that call ``cohort_msc_rotation_null`` with a 16-bit
``compute_dtype`` (the traffic's ``args``): the surrogate contraction on
B2's tensor-core instance, with 2-byte features and coefficients.  As
``rotation_null`` in everything but the work count, which counts the
2-byte operands (``work/null_surrogate_16bit.py``), and the control,
the reference with the contraction's operands rounded to float8 e4m3,
below bfloat16 (``reference/null_16bit.py``)."""
from __future__ import annotations

from benchmarks.entries.rotation_null import Entry as _Null, call_seed
from benchmarks.reference import null_16bit
from benchmarks.work.null_surrogate_16bit import pass_work


class Entry(_Null):
    def control(self, i: int) -> dict:
        """The reference one step below the 16-bit operands, kept as the
        program's results are."""
        eeg, emg, _ = self.inputs[i % len(self.inputs)]
        ref = null_16bit.cohort_null(eeg, emg, self.params,
                                     call_seed(self.seed, i), self.device,
                                     starts=self.starts)
        n = ref["n_drawn"]
        return {"observed": ref["observed"], "p_fwe": ref["p_fwe"],
                "max_stat": ref["max_stat"],
                "p_uncorrected": (1.0 + ref["counts"]) / (1.0 + n)}

    def work(self) -> dict:
        K, nF, J, E, M = self._shapes()
        S = int(min(self.params["surrogate_chunk"],
                    self.params["n_surrogates"]))
        n_drawn = -(-self.params["n_surrogates"] // S) * S
        return {"surrogate_16bit": pass_work(n_drawn, S, nF,
                                             J * K * (K - 1), E * M)}
