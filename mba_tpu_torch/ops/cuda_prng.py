"""The threefry draw on the card (``csrc/threefry.cu``).

Port-only: no TPU kernel corresponds to it.  Every random number of the
port's nulls goes through :func:`uniform` here, so a seed gives the JAX
package's draws (``jax.random``, threefry2x32) on the CPU and on the
card.  The plain version is ``ops/prng.py``; it launches ~150
elementwise kernels a draw over int64 tensors, where the kernel runs the
20 rounds of each draw in registers and writes only the result
(``PERF.md`` gives both times).  :func:`permutation` is
``jax.random.permutation`` of a range with its sort keys drawn here.

:func:`threefry_draw` is the wrapper, and :func:`uniform_keys` draws
for many keys in one launch: on the CPU they run the plain version, on
the card they launch the kernel or raise.  ``threefry_draw.launches``
counts the kernel's launches by either.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mba_tpu_torch import _build
from mba_tpu_torch.ops import prng

_MODES = {"pairs": 0, "bits": 1, "uniform": 2}


def threefry_draw(key, shape, kind: str, device, minval: float = 0.0,
                  maxval: float = 1.0) -> torch.Tensor:
    """One key's draw over ``shape``'s flat counters, on ``device``.

    kind ``'uniform'``: float32 in [minval, maxval) (``jax.random.
    uniform``); ``'bits'``: uint32 values in int64 (``jax.random.bits``);
    ``'pairs'``: both threefry words, (*shape, 2) int64 (the keys of
    ``jax.random.split(key, n)`` for shape (n,)).
    """
    if kind not in _MODES:
        raise ValueError(f"kind must be one of {sorted(_MODES)}, got "
                         f"{kind!r}")
    k0, k1 = prng.key_words(key)
    shape = tuple(int(s) for s in shape)
    device = torch.device(device)
    n = math.prod(shape)
    if device.type == "cpu":
        if kind == "pairs":
            return torch.stack(prng.threefry_pairs(key, n), -1).reshape(
                *shape, 2)
        bits = prng.random_bits(key, shape)
        return bits if kind == "bits" else prng.bits_to_uniform(
            bits, minval, maxval)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if kind == "uniform":
        out = torch.empty(shape, dtype=torch.float32, device=device)
    else:
        out = torch.empty(shape + ((2,) if kind == "pairs" else ()),
                          dtype=torch.int32, device=device)
    lo = np.float32(minval)
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mba_threefry(k0, k1, out.data_ptr(), n, _MODES[kind],
                                float(lo), float(np.float32(maxval) - lo),
                                stream)
    _build.check_launch(lib, code, "mba_threefry")
    threefry_draw.launches += 1
    if kind == "uniform":
        return out
    return out.to(torch.int64) & prng.MASK


threefry_draw.launches = 0


def uniform(key, shape, minval: float, maxval: float, device
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device``."""
    return threefry_draw(key, shape, "uniform", device, minval, maxval)


def permutation(key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (``prng.permutation``) on
    ``device``, each round's sort keys drawn by :func:`threefry_draw`."""
    return prng.permutation(
        key, n, device,
        bits=lambda k, shape, dev: threefry_draw(k, shape, "bits", dev))


def uniform_keys(keys, shape, minval: float, maxval: float, device
                 ) -> torch.Tensor:
    """One ``jax.random.uniform(keys[s], shape, float32, minval,
    maxval)`` per key, stacked: (len(keys), *shape) on ``device``, in one
    launch on the card.  ``keys``: (S, 2) uint32, e.g. ``prng.split``'s."""
    keys = np.asarray(keys)
    if keys.dtype != np.uint32 or keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (S, 2) uint32, got {keys.dtype} "
                         f"{keys.shape}")
    shape = tuple(int(s) for s in shape)
    device = torch.device(device)
    if device.type == "cpu":
        out = torch.empty((len(keys),) + shape, dtype=torch.float32)
        for s, key in enumerate(keys):
            out[s] = prng.uniform(key, shape, minval, maxval)
        return out
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((len(keys),) + shape, dtype=torch.float32,
                      device=device)
    keys_d = torch.from_numpy(np.ascontiguousarray(keys).view(np.int32)).to(
        device)
    lo = np.float32(minval)
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mba_threefry_keys(keys_d.data_ptr(), out.data_ptr(),
                                     len(keys), math.prod(shape), float(lo),
                                     float(np.float32(maxval) - lo), stream)
    _build.check_launch(lib, code, "mba_threefry_keys")
    threefry_draw.launches += 1
    return out
