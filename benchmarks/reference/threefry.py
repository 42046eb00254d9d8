"""A frozen copy of ``jax.random``'s threefry key schedule and uniform
draw, in plain PyTorch, for the reference of the rotation null.

The port draws every surrogate phase from ``jax.random`` keys (threefry2x32,
Salmon et al. 2011, with JAX's partitionable counters: the counter of an
element is its row-major flat index as a 64-bit number split into (hi, lo)
words, and a 32-bit draw is the xor of the two output words).  The
reference reproduces those draws from this copy, so that it shares no
code with the program and a change to the program's draws shows as a
wrong answer.  Integers are uint32 values held in int64 tensors (or
Python ints), masked after every add and shift.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32, 20 rounds; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & MASK)) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off."""
    return 0, int(np.int64(seed)) & MASK


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split``: key i is the two words at counter i."""
    return [threefry2x32(key[0], key[1], i >> 32, i & MASK)
            for i in range(num)]


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a·b + c rounded once to float32 (a fused multiply-add), for
    float32 ``a``: the product is exact in float64, and the float64
    sum's own rounding is settled where it lands on a float32 tie."""
    p = a.double() * float(np.float32(b))
    c64 = float(np.float32(c))
    t = p + c64
    bv = t - p
    err = (p - (t - bv)) + (c64 - bv)
    r = t.float()
    toward = torch.where(t > r.double(), torch.inf, -torch.inf).float()
    other = torch.nextafter(r, toward)
    tie = (r.double() + other.double()) * 0.5 == t
    wrong = tie & (err != 0) & ((r.double() - t) * err < 0)
    return torch.where(wrong, other, r)


def uniform(key: tuple[int, int], shape, minval: float, maxval: float,
            device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    n = int(np.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(key[0], key[1], i >> 32, i & MASK)
    bits = w0 ^ w1
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp_min(_fma_f32(f, span, lo), float(lo)).reshape(shape)
