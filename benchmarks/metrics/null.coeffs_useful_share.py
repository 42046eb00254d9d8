"""null.coeffs_useful_share: the share of the windows the coefficient
pass frames (padding included) that carry weight, 100 × the program's
counters ``coeffs.windows_weighted`` / ``coeffs.windows_framed``, in %."""
from benchmarks.metrics._program import share


def read(run):
    return share(run, "coeffs.windows_weighted", "coeffs.windows_framed")
