"""null.upload_gbps: the null's per-subject upload rate, the program's
``upload_bytes`` over its ``null.upload`` spans, summed over the
window's calls, in GB/s."""
from benchmarks.metrics._program import rate_gbps


def read(run):
    return rate_gbps(run, "upload_bytes", "null.upload")
