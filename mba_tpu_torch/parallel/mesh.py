"""Mesh construction over ``torch.distributed`` (port of
``mba_tpu/parallel/mesh.py``).

JAX's single controller sees every device; here each rank is one
process of an initialised process group, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over all of the group's
ranks.  On the card, rank r uses ``cuda:(local_rank % device_count)``
(``LOCAL_RANK`` as ``torchrun`` sets it, else the global rank), so on a
one-card machine every rank shares ``cuda:0``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mba_tpu_torch._dist import flat_index

AXES = ("subjects", "windows")


def default_axis_shapes(n: int) -> dict[str, int]:
    """The widest 2-D factorisation, subjects outer and windows inner
    (``mesh.py:22-28``): 2 → (2, 1), 4 → (2, 2), 8 → (2, 4)."""
    inner = 1
    for cand in (2, 4):
        if n % cand == 0 and n // cand >= 2:
            inner = cand
    return {"subjects": n // inner, "windows": inner}


def rank_device(device_type: str) -> torch.device:
    """This rank's device: the CPU, or ``cuda:(local_rank %
    device_count)``, made the current card.  Raises without a card."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mba_tpu_torch runs on an NVIDIA card unless told otherwise, "
            "and torch.cuda.is_available() is False here; pass "
            "device_type=\"cpu\" to run the mesh on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    index = local % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def make_mesh(n_devices: int | None = None,
              axis_shapes: dict[str, int] | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A named ('subjects', 'windows') mesh over every rank of the
    initialised process group (``mba_tpu.parallel.mesh.make_mesh``).

    ``n_devices`` defaults to the world size and must equal it: each
    rank is one device of the mesh.  ``axis_shapes`` as in the JAX
    function, default :func:`default_axis_shapes`.  The mesh runs on the
    card unless ``device_type="cpu"``.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call torch.distributed.init_process_group "
                           "(with a timeout) on every rank first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh spans every rank: n_devices={n}, but the "
                         f"process group has {world} ranks")
    rank_device(device_type)
    if axis_shapes is None:
        axis_shapes = default_axis_shapes(n)
    names = tuple(axis_shapes)
    shape = tuple(int(axis_shapes[k]) for k in names)
    if int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"axis_shapes {axis_shapes} do not multiply to "
                         f"{n} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_axis(mesh: DeviceMesh, name: str) -> int:
    """Size of the named axis, 1 where the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


@dataclass(frozen=True)
class CohortSharding:
    """Where this rank's block of a (subjects, windows, ...) cohort array
    lies: its coordinate on each axis and the axes' sizes (the port's
    counterpart of the ``NamedSharding``)."""
    coordinate: tuple[int, int]
    shape: tuple[int, int]


def cohort_sharding(mesh: DeviceMesh) -> CohortSharding:
    """Sharding of cohort arrays shaped (subjects, windows, ...)."""
    names = tuple(mesh.mesh_dim_names or ())
    if names != tuple(n for n in AXES if n in names):
        raise ValueError(f"a cohort mesh has the axes {AXES} or some of "
                         f"them, in that order; this one has {names}")
    n_win = mesh_axis(mesh, "windows")
    i = flat_index(mesh)
    return CohortSharding(coordinate=(i // n_win, i % n_win),
                          shape=(mesh_axis(mesh, "subjects"), n_win))
