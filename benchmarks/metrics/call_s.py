"""call_s: seconds per call, the window over the calls completed
in it."""


def read(run):
    return run["window_s"] / len(run["calls"]) if run["calls"] else None
