"""null.surrogate_s: the surrogate pass (threefry draws, features,
the surrogate tile), timings[null_sec], mean per call."""
from benchmarks.metrics._spans import mean_of


def read(run):
    return mean_of(run, "null_sec")
