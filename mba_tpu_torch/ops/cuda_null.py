"""Kernel B2: the rotation-null surrogate tile (``csrc/null_tile.cu``,
float32; ``csrc/null_tile_tc.cu``, bfloat16 and float16).

Replaces the Pallas kernel ``mba_tpu/ops/pallas_null.py:_null_tile_kernel``
(:37-76) and its callers ``_pallas_call_null``/``null_chunk_pallas_body``.
Per frequency: ``stat = base + (Gᵀ · coefT) / J`` for S surrogates against
N = E·M cells, reduced to per-cell exceedance counts over the real
surrogates and a per-surrogate max over all (frequency, cell).  The
(F, S, N) statistic never reaches device memory; the plain version below
materialises it.

:func:`null_tile` is the wrapper: CPU tensors run :func:`null_tile_plain`,
CUDA tensors launch the kernel or raise.  ``null_tile.launches`` counts
kernel launches.

Reduced precision (the null's ``compute_dtype``, ``pallas_null.py:137-
186``): G and coefT may be bfloat16 or float16, each rounded once from
float32 (:func:`null_features`, :func:`prepare_null_coeffs`), with the
products and sums in float32; those run on the tensor cores (``wgmma``
with float32 accumulators), and the plain version is ``bmm`` of the
rounded operands widened to float32.  The tensor-core kernel's copies
(TMA) need 16-byte rows, so a 16-bit operand's contiguous axis is padded
with zeros to a multiple of 8: G's surrogate axis (the real surrogate
count S passed apart) and coefT's cell axis (the real N is base's).
"""
from __future__ import annotations

import torch

from mba_tpu_torch import _build

# cells per partial max row: BN in csrc/null_tile.cu, csrc/null_tile_tc.cu
CELL_TILE = {torch.float32: 128, torch.bfloat16: 256, torch.float16: 256}
REDUCED = (torch.bfloat16, torch.float16)   # the tensor-core instances
ROW_ALIGN = 8        # a 16-bit operand's contiguous axis: 16-byte rows


def padded_width(n: int, dtype: torch.dtype) -> int:
    """Length of an operand's contiguous axis holding ``n`` values:
    ``n`` in float32, ``n`` rounded up to ``ROW_ALIGN`` in 16 bits."""
    if dtype == torch.float32:
        return n
    return -(-n // ROW_ALIGN) * ROW_ALIGN


def prepare_null_coeffs(coef_all: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-time relayout for the kernel (``pallas_null.py:137-150``).

    coef_all: (..., J, nF, N, P) float32 → coefT (..., nF, J·P, ldc) in
    ``dtype`` (rounded once), contiguous (a leading window axis of the
    per-window mode is kept).  ldc = :func:`padded_width`: N in float32;
    in 16 bits N rounded up to a multiple of 8 with zero columns, whose
    cells the kernel and the plain version never read (the real N is
    base's).  Unlike the TPU layout, J·P is not padded: the kernels mask
    its ragged last slice.
    """
    *lead, J, nF, N, P = coef_all.shape
    coefT = (coef_all.to(torch.float32).movedim(-1, -2).movedim(-4, -3)
             .reshape(*lead, nF, J * P, N))
    ldc = padded_width(N, dtype)
    if ldc == N:
        return coefT.to(dtype).contiguous()
    out = torch.zeros((*lead, nF, J * P, ldc), dtype=dtype,
                      device=coefT.device)
    out[..., :N] = coefT
    return out


def null_features(G_jsfp: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Phase features (J, S, nF, P) → the kernels' k-major (nF, J·P, S)
    layout, flattened over (j, p) in the order of
    :func:`prepare_null_coeffs`: a J·P slice of it and of coefT is copied
    to shared memory as it lies, with no transpose (the tensor cores take
    both as M- and N-major operands).  A 16-bit ``dtype`` rounds the
    features once and pads S with zeros to a multiple of ``ROW_ALIGN``,
    as ``pallas_null.py:170-175`` pads S_pad."""
    J, S, nF, P = G_jsfp.shape
    G = G_jsfp.permute(2, 0, 3, 1).reshape(nF, J * P, S)
    S_pad = padded_width(S, dtype)
    if S_pad == S:
        return G.to(dtype).contiguous()
    out = torch.zeros((nF, J * P, S_pad), dtype=dtype, device=G.device)
    out[..., :S] = G
    return out


def feature_rows(G_jsfp: torch.Tensor) -> torch.Tensor:
    """Phase features (J, S, nF, P) → row-major (nF, S, J·P), the layout
    in which the plain products are formed with ``bmm``."""
    J, S, nF, P = G_jsfp.shape
    return G_jsfp.permute(2, 1, 0, 3).reshape(nF, S, J * P).contiguous()


def null_epilogue(stat: torch.Tensor, obs: torch.Tensor):
    """(nF, S, N) surrogate statistic → (max_stat (S,), counts (nF, N)):
    the per-surrogate max and the per-cell exceedances of ``obs``."""
    max_stat = stat.amax(dim=(0, 2))
    counts = (stat >= obs[:, None, :]).sum(dim=1, dtype=torch.int32)
    return max_stat, counts


def null_tile_plain(G: torch.Tensor, coefT: torch.Tensor,
                    base: torch.Tensor, obs: torch.Tensor, J: int,
                    S: int | None = None):
    """Plain PyTorch version: returns (max_stat (S,), counts (nF, N)),
    N = base's width (coefT's first N cells).  16-bit operands are widened
    to float32 for the product."""
    S = G.shape[2] if S is None else S
    N = base.shape[1]
    rows = G[..., :S].transpose(1, 2).to(torch.float32).contiguous()
    stat = base[:, None, :] + torch.bmm(
        rows, coefT[..., :N].to(torch.float32)) * (1.0 / J)
    return null_epilogue(stat, obs)


def _check(G, coefT, base, obs, S) -> None:
    if G.dtype not in CELL_TILE:
        raise TypeError(f"G must be float32, bfloat16 or float16, got "
                        f"{G.dtype}")
    if coefT.dtype != G.dtype:
        raise TypeError(f"coefT is {coefT.dtype}, G {G.dtype}")
    for name, x in (("base", base), ("obs", obs)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    for name, x in (("G", G), ("coefT", coefT), ("base", base),
                    ("obs", obs)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != G.device:
            raise ValueError(f"{name} lies on {x.device}, G on {G.device}")
    if G.ndim != 3 or coefT.ndim != 3:
        raise ValueError("G must be (nF, JP, S) and coefT (nF, JP, N)")
    nF, JP, ldg = G.shape
    if not 0 < S <= ldg:
        raise ValueError(f"S={S} must lie in 1..{ldg} (G's surrogate axis)")
    if G.dtype in REDUCED and ldg % ROW_ALIGN:
        raise ValueError(f"a 16-bit G's surrogate axis ({ldg}) must be a "
                         f"multiple of {ROW_ALIGN} (null_features pads it)")
    if base.ndim != 2 or tuple(obs.shape) != tuple(base.shape):
        raise ValueError(f"base {tuple(base.shape)} and obs "
                         f"{tuple(obs.shape)} must be one (nF, N) shape")
    N = base.shape[1]
    want = (nF, JP, padded_width(N, G.dtype))
    if tuple(coefT.shape) != want:
        raise ValueError(f"coefT must be {want} for G {tuple(G.shape)} and "
                         f"N = {N} ({G.dtype}), got {tuple(coefT.shape)}")
    if base.shape[0] != nF:
        raise ValueError(f"base must be ({nF}, {N}), got "
                         f"{tuple(base.shape)}")


def null_tile(G: torch.Tensor, coefT: torch.Tensor, base: torch.Tensor,
              obs: torch.Tensor, J: int, S: int | None = None):
    """Surrogate statistic tile (see module docstring).

    G: (nF, JP, ldg) phase features (:func:`null_features`) and coefT:
    (nF, JP, ldc) (:func:`prepare_null_coeffs`), both float32, bfloat16 or
    float16; base/obs: (nF, N) float32, N <= ldc; S: the real surrogates,
    the first S of G's ldg (default all).  Returns (max_stat (S,)
    float32, counts (nF, N) int32 — this chunk's exceedances, for the
    caller to add).  A CUDA float32 G launches the CUDA-core kernel, a
    16-bit one the tensor-core kernel; there is no other route.
    """
    S = G.shape[2] if S is None else int(S)
    _check(G, coefT, base, obs, S)
    if G.device.type == "cpu":
        return null_tile_plain(G, coefT, base, obs, J, S)
    if G.device.type != "cuda":
        raise ValueError(f"unsupported device {G.device}")
    nF, JP, ldg = G.shape
    N = base.shape[1]
    n_tiles = -(-N // CELL_TILE[G.dtype])
    dev = G.device
    partial = torch.empty((nF * n_tiles, S), dtype=torch.float32,
                          device=dev)
    counts = torch.empty((nF, N), dtype=torch.int32, device=dev)
    max_stat = torch.empty((S,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (G.data_ptr(), coefT.data_ptr(), base.data_ptr(),
                obs.data_ptr(), partial.data_ptr(), counts.data_ptr(),
                max_stat.data_ptr())
        if G.dtype in REDUCED:
            name = "mba_null_tile_tc"
            code = lib.mba_null_tile_tc(
                *ptrs, nF, S, ldg, JP, N, coefT.shape[2], 1.0 / J,
                int(G.dtype == torch.float16), stream)
        else:
            name = "mba_null_tile"
            code = lib.mba_null_tile(*ptrs, nF, S, ldg, JP, N, 1.0 / J,
                                     stream)
    _build.check_launch(lib, code, name)
    null_tile.launches += 1
    return max_stat, counts


null_tile.launches = 0
