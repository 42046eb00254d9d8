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

from mba_tpu_torch import _staging
from mba_tpu_torch.utils.profiling import count


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


# Host arrays of at least this many bytes go to the card through the
# staging ring (``_staging``).  On an H100 host the staged to_device of
# 16 MB took 2.4 ms against the pageable copy's 3.1, of 8 MB 1.6 against
# 0.9 (PERF.md §6, the staged upload)
STAGE_MIN_BYTES = 16 << 20


class Upload:
    """Tensors on their way to a device, and the event after which they
    are there (None: they already are, for the stream that made them)."""

    def __init__(self, tensors, ready=None):
        self.tensors, self.ready = list(tensors), ready

    def wait(self) -> None:
        """Wait on the host until the bytes are on the device (the copy's
        event, not the whole device)."""
        if self.ready is not None:
            self.ready.synchronize()

    def take(self) -> list:
        """The tensors, for use on the current stream: it waits on the
        copy's event, and the allocator holds their memory for it."""
        tensors, self.tensors = self.tensors, None
        if self.ready is not None:
            stream = torch.cuda.current_stream(tensors[0].device)
            stream.wait_event(self.ready)
            for t in tensors:
                t.record_stream(stream)
        return tensors


def upload(arrays, device: torch.device) -> Upload:
    """Signal arrays → an :class:`Upload` of tensors on ``device``,
    without waiting on the host for the card.  float32 and integer ADC
    counts (int16/int8) travel as they are, to be cast to float32 on the
    device (coherence is invariant to the per-channel scale); any other
    host dtype is cast to float32 first.  Host arrays of at least
    ``STAGE_MIN_BYTES`` then go up through the staging ring on its copy
    stream where ``device`` is a CUDA device; smaller ones, tensors and
    the CPU take the plain copy.  Counts the bytes of the host arrays
    taken to a CUDA device (``upload.bytes``) and of those staged
    (``upload.staged_bytes``)."""
    cuda = device.type == "cuda"
    out, staged = [], []
    for x in arrays:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if x.dtype not in (np.int16, np.int8, np.float32):
                x = x.astype(np.float32)
            x = np.ascontiguousarray(x)
            if cuda:
                count("upload.bytes", x.nbytes)
                if x.nbytes >= STAGE_MIN_BYTES:
                    count("upload.staged_bytes", x.nbytes)
                    staged.append((len(out), x))
                    out.append(None)
                    continue
            x = torch.from_numpy(x)
        out.append(x.to(device))
    if not staged:
        return Upload(out)
    tensors, ready = _staging.stage([x for _, x in staged], device)
    for (i, _), t in zip(staged, tensors):
        out[i] = t
    return Upload(out, ready)


def to_device(x, device: torch.device) -> torch.Tensor:
    """Signal array → tensor on ``device`` (:func:`upload`), in stream
    order for the current stream."""
    return upload([x], device).take()[0]


def wait_stream(device: torch.device) -> None:
    """Wait on the host for the work queued so far on the current stream
    of ``device`` (not the device's other streams; no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
