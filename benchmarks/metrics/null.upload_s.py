"""null.upload_s: the null's per-subject uploads, timings[upload_sec],
mean per call."""
from benchmarks.metrics._spans import mean_of


def read(run):
    return mean_of(run, "upload_sec")
