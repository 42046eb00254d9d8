"""phase_null.observed_s: the phase null's observed spectrum, the summed
``phase_null.observed`` records of a call (through its copy to the
host), mean per call."""
from benchmarks.metrics._program import mean_seconds


def read(run):
    return mean_seconds(run, "phase_null.observed")
