"""null.upload_staged_share: the share of the null's uploaded host bytes
that went through the staging ring, 100 × the program's counters
``upload.staged_bytes`` / ``upload.bytes``, in %."""
from benchmarks.metrics._program import share


def read(run):
    return share(run, "upload.staged_bytes", "upload.bytes")
