"""cmc.compute_roofline: the least time of the spectra and epilogue
step (work/msc_epilogue.py, float32 peaks) over the device time of the
call's kernels (the trace's intervals: every kernel of a CMC call is a
part of that step; the copies are not kernels), in %."""
from benchmarks.metrics._spans import roofline_share


def read(run):
    return roofline_share(run, "spectra_epilogue")
