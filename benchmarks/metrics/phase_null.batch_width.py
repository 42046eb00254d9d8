"""phase_null.batch_width: surrogates a batch of the phase null, the
counters ``phase_null.surrogates_drawn`` over ``phase_null.batches``
summed over the window's calls."""
from benchmarks.metrics._program import counters


def read(run):
    cnts = counters(run)
    keys = ("phase_null.surrogates_drawn", "phase_null.batches")
    if cnts is None or any(k not in c for c in cnts for k in keys):
        return None
    batches = sum(c[keys[1]] for c in cnts)
    return sum(c[keys[0]] for c in cnts) / batches if batches else None
