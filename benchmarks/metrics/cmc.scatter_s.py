"""cmc.scatter_s: the CMC's scatter of the active windows' results into
fresh full-grid host arrays, the program's ``cmc.scatter`` span, mean
per call."""
from benchmarks.metrics._program import mean_seconds


def read(run):
    return mean_seconds(run, "cmc.scatter")
