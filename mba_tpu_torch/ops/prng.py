"""``jax.random``'s threefry PRNG in plain PyTorch, bit for bit.

The JAX package draws every random number from ``jax.random`` keys
(threefry2x32, Salmon et al. 2011), whose bits are the same on every
backend.  This module computes the same bits, so a seed gives the port
the JAX package's draws on the CPU and on the card alike.  It follows
JAX 0.9.0's defaults: ``jax_threefry_partitionable`` is True (its
default since JAX 0.5.0), so the counters of a draw are the row-major
flat index of each element as a 64-bit number split into (hi, lo) words,
and a 32-bit draw is the xor of threefry's two output words.

- :func:`threefry2x32` — 20 rounds on int64 tensors holding uint32
  values (masked after every add and shift), so the same integer ops run
  on either device, or on Python ints;
- keys: a key is a ``(2,)`` uint32 numpy array on the host.
  :func:`prng_key` (``jax.random.PRNGKey``), :func:`split`,
  :func:`fold_in`, computed on Python ints;
- draws: :func:`random_bits` (``jax.random.bits``, uint32 values held in
  int64), :func:`uniform` (float32, ``jax.random.uniform``),
  :func:`randint` (int32, ``jax.random.randint``), :func:`permutation`
  (``jax.random.permutation`` of a range).

These are the plain versions: they run on whatever device they are
given, one elementwise op at a time.  ``ops/cuda_prng.py`` is the
wrapper that the nulls call, which launches the hand-written kernel
``csrc/threefry.cu`` for the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32, 20 rounds (``jax._src.prng._threefry2x32``), on
    int64 tensors holding uint32 values, or on Python ints; returns the
    two output words."""
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


def key_words(key) -> tuple[int, int]:
    """The two uint32 words of a key, as Python ints."""
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"a key is a (2,) uint32 array, got {k.dtype} "
                         f"{k.shape}")
    return int(k[0]), int(k[1])


def _size(shape) -> int:
    return math.prod(tuple(shape))


def threefry_pairs(key, n: int, device="cpu"):
    """Both threefry words at counters 0..n−1: (words0, words1), int64."""
    k0, k1 = key_words(key)
    i = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(k0, k1, i >> 32, i & MASK)


def fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a·b + c for float32 ``a`` and float32 scalars, rounded once to
    float32, as a fused multiply-add rounds it (XLA fuses the scale and
    shift of ``jax.random.uniform``).  The product is exact in float64;
    the float64 sum's error (TwoSum) settles the one case where rounding
    the sum twice would differ, a float64 sum on a float32 tie."""
    p = a.double() * float(np.float32(b))
    c64 = float(np.float32(c))
    t = p + c64
    bv = t - p
    err = (p - (t - bv)) + (c64 - bv)            # t + err == p + c exactly
    r = t.float()
    toward = torch.where(t > r.double(), torch.inf, -torch.inf).float()
    other = torch.nextafter(r, toward)
    tie = (r.double() + other.double()) * 0.5 == t
    wrong = tie & (err != 0) & ((r.double() - t) * err < 0)
    return torch.where(wrong, other, r)


def bits_to_uniform(bits: torch.Tensor, minval: float, maxval: float
                    ) -> torch.Tensor:
    """uint32 values (int64) → float32 in [minval, maxval), as
    ``jax.random.uniform`` maps them: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, times (maxval − minval) rounded to
    float32, plus minval in one rounding, floored at minval."""
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    return torch.clamp_min(fma_f32(f, span, lo), float(lo))


def random_bits(key, shape=(), device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values."""
    b0, b1 = threefry_pairs(key, _size(shape), device)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return bits_to_uniform(random_bits(key, shape, device), minval, maxval)


def _as_key(w0, w1) -> np.ndarray:
    return np.array([int(w0), int(w1)], np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed as an
    int64, cut to its low 32 bits, is the second word; the first is 0."""
    return _as_key(0, int(np.int64(seed)) & MASK)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys, key i being
    the two threefry words at counter i.  Keys are few, so the rounds
    run on Python ints (microseconds a key, where ~150 tensor ops on the
    host would take a millisecond)."""
    k0, k1 = key_words(key)
    return np.array([threefry2x32(k0, k1, i >> 32, i & MASK)
                     for i in range(int(num))], np.uint32).reshape(-1, 2)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the threefry words at counter
    (0, data) with ``data`` cut to uint32."""
    k0, k1 = key_words(key)
    return _as_key(*threefry2x32(k0, k1, 0, int(data) & MASK))


def permutation(key, n: int, device="cpu", bits=random_bits
                ) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as int64 on ``device``: JAX's
    ``_shuffle``, ``ceil(3·ln n / ln(2³²−1))`` rounds, each ``key, sub =
    split(key)`` and a stable sort of the range by 32-bit ``bits(sub,
    (n,), device)`` (``lax.sort_key_val`` is stable, so ties keep their
    order).  The keys are uint32 values held in int64, which sort as
    unsigned.  ``bits``: :func:`random_bits`, or the kernel's draw."""
    n = int(n)
    num_rounds = int(np.ceil(3 * np.log(max(1, n))
                             / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, device=device)
    for _ in range(num_rounds):
        key, sub = split(key)
        x = x[torch.argsort(bits(sub, (n,), device), stable=True)]
    return x


def _rem(x, span: int):
    """uint32 remainder as XLA computes it: x % 0 is x."""
    return x if span == 0 else x % span


def randint(key, shape=(), minval: int = 0, maxval: int = 1,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for
    integer bounds within int32: two 32-bit draws from ``split(key)``
    combined modulo the span, as ``jax._src.random._randint`` does."""
    minval, maxval = int(minval), int(maxval)
    if not (_INT32_MIN <= minval <= _INT32_MAX
            and _INT32_MIN <= maxval <= _INT32_MAX):
        raise ValueError("randint bounds must lie within int32")
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    multiplier = _rem((_rem(1 << 16, span) ** 2) & MASK, span)
    offset = _rem((_rem(higher, span) * multiplier + _rem(lower, span))
                  & MASK, span)
    out = (minval + offset) & MASK
    return torch.where(out > _INT32_MAX, out - (1 << 32), out).to(
        torch.int32)
