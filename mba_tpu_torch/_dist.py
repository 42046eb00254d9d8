"""Mesh helpers and collectives under both ``ops`` and ``parallel``.

A mesh of the port is a ``torch.distributed.device_mesh.DeviceMesh`` of
``parallel.make_mesh`` over every rank of the process group.  This module
checks one, finds this rank's device and its place in the mesh's flat
(row-major) order, and holds the three collectives of the JAX package's
``shard_map`` bodies, over every rank in that order (JAX's
``Mesh(mesh.devices.reshape(-1), ...)``):

=========================================  =================================
JAX                                        port
=========================================  =================================
``psum`` over the flat axis                :func:`psum_` (``all_reduce``)
``out_specs=P(axis)``, gathered by the     :func:`gather` (``all_gather``,
single controller on ``np.asarray``        then the mesh's flat order)
``ppermute`` to rank i − 1                 :func:`from_next_rank`
                                           (``batch_isend_irecv``)
=========================================  =================================

A mesh spans every rank of the process group (:func:`check_mesh`), so
the flat group is the default group; its ranks are reordered into the
mesh's flat order where the order matters.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself, after checking that it is a ``DeviceMesh`` over
    every rank of the process group."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh (see parallel.make_mesh), got "
                        f"{type(mesh).__name__}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh spans {mesh.size()} of the process "
                         f"group's {dist.get_world_size()} ranks; a mesh "
                         "of the port spans them all")
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank of ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def mesh_entry_device(mesh: DeviceMesh, device) -> torch.device:
    """The device of an entry point called with ``mesh``: this rank's;
    a ``device`` that names another raises."""
    dev = mesh_device(mesh)
    if device is not None:
        asked = torch.device(device)
        if asked.type != dev.type or asked.index not in (None, dev.index):
            raise ValueError(f"device={device!r}, but this rank of the "
                             f"mesh runs on {dev}")
    return dev


def flat_ranks(mesh: DeviceMesh) -> list[int]:
    """Global ranks in the mesh's flat (row-major) order, the order of
    JAX's ``mesh.devices.reshape(-1)``."""
    return [int(r) for r in mesh.mesh.flatten()]


def flat_index(mesh: DeviceMesh) -> int:
    """This rank's position in :func:`flat_ranks`."""
    return flat_ranks(mesh).index(dist.get_rank())


def _host_staged(t: torch.Tensor) -> bool:
    """Whether ``t`` must cross the process group as a host copy: a
    CUDA tensor point to point under gloo.  Gloo's all_reduce, all_gather
    and broadcast take CUDA tensors (two gloo ranks sharing an H100, torch
    2.11, gave the right sums and blocks); its send hands the device
    pointer to the socket (gloo::IoException "writev: Bad address", the
    rank aborted) and its recv raises."""
    return t.is_cuda and dist.get_backend() == dist.Backend.GLOO


def psum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every rank, in place (JAX's ``psum``)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def gather(t: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in the mesh's flat order, on
    ``t``'s device."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, t)
    return [outs[r] for r in flat_ranks(mesh)]


def from_next_rank(send: torch.Tensor, mesh) -> torch.Tensor | None:
    """Flat rank i > 0 sends ``send`` to rank i − 1; rank i < n − 1
    receives rank i + 1's (same shape and type), which it returns.  The
    last rank returns None: JAX's ``ppermute`` wraps around to it, and it
    throws that block away (``cohort.py:346-356``)."""
    ranks = flat_ranks(mesh)
    i = flat_index(mesh)
    src = send.cpu() if _host_staged(send) else send.contiguous()
    recv = torch.empty_like(src) if i < len(ranks) - 1 else None
    ops = []
    if i > 0:
        ops.append(dist.P2POp(dist.isend, src, ranks[i - 1]))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[i + 1]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return None if recv is None else recv.to(send.device)


def broadcast_object(obj, mesh):
    """Flat rank 0's ``obj`` on every rank (a picklable host object)."""
    box = [obj]
    dist.broadcast_object_list(box, src=flat_ranks(mesh)[0])
    return box[0]
