"""Device policy: float32 matmuls stay float32.

The gram coefficient pass and the band DFT are float32 matmuls.  On a
Hopper card cuBLAS may run them in TF32 (about three decimal digits),
which moves the observed coherence map by about 1e-3; reduced-precision
matmuls zeroed results in the JAX package before (bf16 MXU inputs in the
REML power grid).  So the port turns TF32 off for matmuls and cuDNN and
asks for the "highest" float32 matmul precision.
"""
from __future__ import annotations

import numpy as np
import torch


def apply_precision_policy() -> None:
    """Pin full float32 matmuls (no TF32) process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device, *tensors) -> torch.device:
    """The device to run on: ``device`` when given, else that of the
    first torch tensor among ``tensors``, else the card (``cuda``).  The
    CPU runs only when asked for, by ``device="cpu"`` or CPU tensors."""
    if device is not None:
        return torch.device(device)
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cuda")


def entry_device(device, *tensors) -> torch.device:
    """:func:`resolve_device` for an entry point: raises where it names
    the card and there is none, so a call never carries on on the CPU
    unasked."""
    dev = resolve_device(device, *tensors)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mba_tpu_torch runs on an NVIDIA card unless told otherwise, "
            "and torch.cuda.is_available() is False here; pass "
            "device=\"cpu\" to run on the CPU")
    return dev


def dtype_name(dtype) -> str:
    """The name of a numpy, torch or JAX type (``np.int16``,
    ``torch.bfloat16``, ``jnp.bfloat16``) or of a string naming one:
    how an option naming a transfer or compute type is read."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    try:
        return np.dtype(dtype).name
    except TypeError:           # bfloat16 without ml_dtypes
        return getattr(dtype, "__name__", str(dtype))


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(x, device: torch.device) -> torch.Tensor:
    """Signal array → tensor on ``device``.  float32 and integer ADC
    counts (int16/int8) travel as they are, to be cast to float32 on the
    device (coherence is invariant to the per-channel scale); any other
    host dtype is cast to float32 first."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype not in (np.int16, np.int8, np.float32):
            x = x.astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)
