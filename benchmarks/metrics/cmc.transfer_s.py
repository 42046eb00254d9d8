"""cmc.transfer_s: upload and download seconds, timings[upload_sec]
+ timings[download_sec], mean per call."""
from benchmarks.metrics._spans import mean_of


def read(run):
    return mean_of(run, "upload_sec", "download_sec")
