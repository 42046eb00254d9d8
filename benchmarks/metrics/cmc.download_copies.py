"""cmc.download_copies: the copies that write the CMC's results into
their rows of the full grid, one a result and run of active windows, the
program's counter ``cmc.download_copies``, mean per call."""
from benchmarks.metrics._program import counters

NAME = "cmc.download_copies"


def read(run):
    cnts = counters(run)
    if cnts is None or any(NAME not in c for c in cnts):
        return None
    return sum(c[NAME] for c in cnts) / len(cnts)
