"""Kernel B2: the rotation-null surrogate tile (``csrc/null_tile.cu``).

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
"""
from __future__ import annotations

import torch

from mba_tpu_torch import _build

CELL_TILE = 128      # cells per block: BN in csrc/null_tile.cu


def prepare_null_coeffs(coef_all: torch.Tensor) -> torch.Tensor:
    """One-time relayout for the kernel (``pallas_null.py:137-150``).

    coef_all: (..., J, nF, N, P) float32 → coefT (..., nF, J·P, N)
    float32, contiguous (a leading window axis of the per-window mode is
    kept).  Unlike the TPU layout, J·P is not padded: the kernel masks
    its ragged last slice.
    """
    *lead, J, nF, N, P = coef_all.shape
    return (coef_all.movedim(-1, -2).movedim(-4, -3)
            .reshape(*lead, nF, J * P, N).to(torch.float32).contiguous())


def null_features(G_jsfp: torch.Tensor) -> torch.Tensor:
    """Phase features (J, S, nF, P) → the kernel's k-major (nF, J·P, S)
    layout, flattened over (j, p) in the order of
    :func:`prepare_null_coeffs`: a J·P slice of it and of coefT is copied
    to shared memory as it lies, with no transpose."""
    J, S, nF, P = G_jsfp.shape
    return G_jsfp.permute(2, 0, 3, 1).reshape(nF, J * P, S).contiguous()


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
                    base: torch.Tensor, obs: torch.Tensor, J: int):
    """Plain PyTorch version: returns (max_stat (S,), counts (nF, N))."""
    rows = G.transpose(1, 2).contiguous()      # feature_rows' layout
    stat = base[:, None, :] + torch.bmm(rows, coefT) * (1.0 / J)
    return null_epilogue(stat, obs)


def _check(G, coefT, base, obs) -> None:
    for name, x in (("G", G), ("coefT", coefT), ("base", base),
                    ("obs", obs)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != G.device:
            raise ValueError(f"{name} lies on {x.device}, G on {G.device}")
    if G.ndim != 3 or coefT.ndim != 3:
        raise ValueError("G must be (nF, JP, S) and coefT (nF, JP, N)")
    nF, JP, S = G.shape
    if coefT.shape[:2] != (nF, JP):
        raise ValueError(f"coefT {tuple(coefT.shape)} does not match G "
                         f"{tuple(G.shape)}")
    N = coefT.shape[2]
    for name, x in (("base", base), ("obs", obs)):
        if tuple(x.shape) != (nF, N):
            raise ValueError(f"{name} must be ({nF}, {N}), got "
                             f"{tuple(x.shape)}")


def null_tile(G: torch.Tensor, coefT: torch.Tensor, base: torch.Tensor,
              obs: torch.Tensor, J: int):
    """Surrogate statistic tile (see module docstring).

    G: (nF, JP, S) float32 phase features (:func:`null_features`);
    coefT: (nF, JP, N) float32;
    base/obs: (nF, N) float32.  Returns (max_stat (S,) float32, counts
    (nF, N) int32 — this chunk's exceedances, for the caller to add).
    """
    _check(G, coefT, base, obs)
    if G.device.type == "cpu":
        return null_tile_plain(G, coefT, base, obs, J)
    if G.device.type != "cuda":
        raise ValueError(f"unsupported device {G.device}")
    nF, JP, S = G.shape
    N = coefT.shape[2]
    n_tiles = -(-N // CELL_TILE)
    dev = G.device
    partial = torch.empty((nF * n_tiles, S), dtype=torch.float32,
                          device=dev)
    counts = torch.empty((nF, N), dtype=torch.int32, device=dev)
    max_stat = torch.empty((S,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mba_null_tile(
            G.data_ptr(), coefT.data_ptr(), base.data_ptr(), obs.data_ptr(),
            partial.data_ptr(), counts.data_ptr(), max_stat.data_ptr(),
            nF, S, JP, N, 1.0 / J, stream)
    _build.check_launch(lib, code, "mba_null_tile")
    null_tile.launches += 1
    return max_stat, counts


null_tile.launches = 0
