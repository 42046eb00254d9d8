"""phase_null.null_s: the phase null's surrogate loop, the summed
``phase_null.surrogates`` records of a call (the draws, the batches,
the histogram, through the maxima's copy to the host), mean per call."""
from benchmarks.metrics._program import mean_seconds


def read(run):
    return mean_seconds(run, "phase_null.surrogates")
