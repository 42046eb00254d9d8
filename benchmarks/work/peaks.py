"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full power limit of 700 W), and the least time a step's
work could take on it."""
from __future__ import annotations

PEAKS = {
    "float32_flops": 67e12,       # CUDA cores, outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float = PEAKS["float32_flops"]
                  ) -> tuple[float, str]:
    """The larger of the operations' and the bytes' least times, and
    which of the two it is."""
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
