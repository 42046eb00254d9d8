"""null.coeffs_s: the coefficient pass (gram or B3),
timings[coeffs_sec], mean per call."""
from benchmarks.metrics._spans import mean_of


def read(run):
    return mean_of(run, "coeffs_sec")
