"""null.surrogate_roofline_16bit: the least time of the 16-bit surrogate
pass's contraction (work/null_surrogate_16bit.py, on the tensor cores'
16-bit peak) over the device time of the kernels that run inside the
program's null_sec span (the trace's intervals, not the span's host
seconds), in %."""
from benchmarks.metrics._spans import device_seconds
from benchmarks.work.peaks import PEAKS, least_seconds


def read(run):
    t = device_seconds(run, "null_sec")
    if not t or "surrogate_16bit" not in run["work"]:
        return None
    return 100.0 * least_seconds(*run["work"]["surrogate_16bit"],
                                 PEAKS["bf16_flops"])[0] / t
