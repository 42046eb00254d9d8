"""cmc.download_gbps: the CMC's download rate, the program's
``download_bytes`` over its ``cmc.download`` spans, summed over the
window's calls, in GB/s."""
from benchmarks.metrics._program import rate_gbps


def read(run):
    return rate_gbps(run, "download_bytes", "cmc.download")
