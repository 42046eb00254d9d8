"""What the span readers share: the mean over the window's calls of a
sum of the program's span seconds (``timings``), or None where no call
has them (the spans exist in the traced run only); and the device time
of a call, or of a span of it, from the traced run's kernels."""


def mean_of(run, *keys):
    vals = [sum(c["spans"][k] for k in keys) for c in run["calls"]
            if all(k in c["spans"] for k in keys)]
    return sum(vals) / len(vals) if vals else None


def mean_host(run, *keys):
    """Mean of each call's wall time minus its spans ``keys``."""
    vals = [c["wall_s"] - sum(c["spans"][k] for k in keys)
            for c in run["calls"] if all(k in c["spans"] for k in keys)]
    return sum(vals) / len(vals) if vals else None


# the program rounds its spans to the millisecond: a span read back from
# the clock may start up to half of one later than it did
SPAN_ROUNDING_S = 0.0005


def _kernel_seconds(intervals, a: float, b: float) -> float:
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in intervals)


def device_seconds(run, span=None):
    """Mean over the traced window's calls of the device's kernel and
    memset time: in the whole call, or (``span``) in the program's span
    of that name, placed on the call's clock as the span that ends when
    the program returns.  None without a trace, or where a call lacks
    the span."""
    trace = run.get("trace") or {}
    per_call = trace.get("calls")
    if not per_call or len(per_call) != len(run["calls"]):
        return None
    vals = []
    for call, kernels in zip(run["calls"], per_call):
        if span is None:
            vals.append(_kernel_seconds(kernels, 0.0, float("inf")))
            continue
        if span not in call["spans"]:
            return None
        end = call["returned_s"]
        start = end - call["spans"][span] - SPAN_ROUNDING_S
        vals.append(_kernel_seconds(kernels, start, end))
    return sum(vals) / len(vals)


def roofline_share(run, step, span=None):
    """100 × the least time of the step's work on the card's peaks over
    the device time that does it (:func:`device_seconds`)."""
    from benchmarks.work.peaks import least_seconds
    t = device_seconds(run, span)
    if not t or step not in run["work"]:
        return None
    return 100.0 * least_seconds(*run["work"][step])[0] / t
