"""cmc.compute_s: framing, the tapered rFFT and the jackknife
epilogue (B1), timings[compute_sec], mean per call."""
from benchmarks.metrics._spans import mean_of


def read(run):
    return mean_of(run, "compute_sec")
