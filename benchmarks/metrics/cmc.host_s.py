"""cmc.host_s: each call's wall time less its upload, compute and
download spans, mean per call: the host's part of the entry point."""
from benchmarks.metrics._spans import mean_host


def read(run):
    return mean_host(run, "upload_sec", "compute_sec", "download_sec")
