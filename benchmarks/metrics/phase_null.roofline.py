"""phase_null.roofline: the least time of the phase null's step
(work/phase_null.py, float32 peaks) over the device's kernel and memset
time in the call (the trace's intervals), in %."""
from benchmarks.metrics._spans import roofline_share


def read(run):
    return roofline_share(run, "phase_null")
