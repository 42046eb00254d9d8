"""null.surrogate_roofline: the least time of the surrogate pass's
contraction (work/null_surrogate.py, float32 peaks) over the device time
of the kernels that run inside the program's null_sec span (the trace's
intervals, not the span's host seconds), in %."""
from benchmarks.metrics._spans import roofline_share


def read(run):
    return roofline_share(run, "surrogate", "null_sec")
