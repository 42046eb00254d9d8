"""What the readers of the program's own records share.

An entry point that records returns, in its ``timings`` (a call's
``spans`` in the run), ``spans``: records [name, parent, start_s, end_s]
in seconds from the root's start, the root (index 0) closing just before
the entry point returns; and ``counters``: {name: int}.  A program
without them (an older one, or an untraced CMC call) gives the readers
nothing, and each returns None.
"""
from benchmarks.metrics._spans import _kernel_seconds


def records(run):
    """Each call's records, or None where a call has none."""
    out = [c["spans"].get("spans") for c in run["calls"]]
    return out if out and all(out) else None


def counters(run):
    """Each call's counters, or None where a call has none."""
    out = [c["spans"].get("counters") for c in run["calls"]]
    return out if out and all(isinstance(c, dict) for c in out) else None


def seconds(recs, name: str) -> float:
    """The summed length of a call's records named ``name``."""
    return sum(r[3] - r[2] for r in recs if r[0] == name)


def placed(call, recs, name: str) -> list:
    """A call's records named ``name`` as [start, end] on the call's
    clock (seconds from the harness's first clock read in the call, the
    clock of the trace's per-call kernels): the root's end is put at the
    time the call returned."""
    shift = call["returned_s"] - recs[0][3]
    return [[r[2] + shift, r[3] + shift] for r in recs if r[0] == name]


def mean_seconds(run, name: str):
    """The mean per call of the summed records named ``name``."""
    recs = records(run)
    if recs is None:
        return None
    return sum(seconds(r, name) for r in recs) / len(recs)


def rate_gbps(run, key: str, name: str):
    """Σ bytes under the call's ``timings`` key ``key`` / Σ seconds of
    the records named ``name`` over the window's calls, in GB/s; None
    where either is missing or zero."""
    recs = records(run)
    if recs is None or any(key not in c["spans"] for c in run["calls"]):
        return None
    t = sum(seconds(r, name) for r in recs)
    n = sum(c["spans"][key] for c in run["calls"])
    return n / t / 1e9 if t > 0 else None


def share(run, part: str, whole: str):
    """100 × Σ counter ``part`` / Σ counter ``whole`` over the calls."""
    cnts = counters(run)
    if cnts is None or any(part not in c or whole not in c for c in cnts):
        return None
    n = sum(c[whole] for c in cnts)
    return 100.0 * sum(c[part] for c in cnts) / n if n else None


def kernel_share(run, name: str):
    """100 × the device's kernel and memset time that falls inside the
    records named ``name`` (placed on each call's clock) over those
    records' length, summed over the traced window's calls."""
    recs = records(run)
    per_call = (run.get("trace") or {}).get("calls")
    if recs is None or not per_call or len(per_call) != len(recs):
        return None
    inside = length = 0.0
    for call, r, kernels in zip(run["calls"], recs, per_call):
        for a, b in placed(call, r, name):
            inside += _kernel_seconds(kernels, a, b)
            length += b - a
    return 100.0 * inside / length if length > 0 else None
