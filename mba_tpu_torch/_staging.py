"""Staged uploads: host arrays to the card through a ring of pinned buffers.

From pageable memory an array crosses to the card at the pageable rate:
CUDA copies it on one thread into pinned buffers of its own and waits
for each transfer.  :func:`stage` copies it chunk by chunk into a small
ring of reusable page-locked buffers instead, the chunks dealt to a
thread on each of the host's usable cores, and sends each chunk up with
``cudaMemcpyAsync`` on a copy stream of its own.
Each thread owns a few buffers of the ring and copies its next chunk
into one while the others cross; an event on each buffer says when the
transfer that last read it has completed, so the buffer can be
refilled, and one event after the last chunk says when the arrays are
on the card.  The ring, its stream and the threads are made once per
process (the ring once per device) on first use and reused by every
call.

The destination is allocated on the copy stream, so the allocator never
makes the copies wait for the caller's queued work; the consumer makes
its stream wait on the ready event and calls ``record_stream`` for it
(``_device.Upload.take``) before it uses a tensor.
"""
from __future__ import annotations

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

# The ring: 8-MB chunks, three buffers a thread, a thread a usable core.
# On an H100 host (8 cores) a 1.78-GB subject went up at 17.5-19.9 GB/s
# with two buffers a thread, 22.8-23.6 with three, 17.5-18.0 with 4-MB
# chunks, 12.8-15.1 on 4 threads; the pageable copy 6.2-7.4 (PERF.md §6,
# the staged upload)
CHUNK_BYTES = 8 << 20
# a thread copies into one of its buffers while the others cross
BUFFERS_PER_THREAD = 3


class Step(NamedTuple):
    """One chunk of a staged array: bytes [start, stop) go through ring
    buffer ``slot``."""
    slot: int
    start: int
    stop: int


def chunk_plan(nbytes: int, chunk_bytes: int, depth: int,
               cursor: int) -> list[Step]:
    """The chunks of an ``nbytes`` array through a ring of ``depth``
    buffers of ``chunk_bytes``, the ring's running count of chunks at
    ``cursor``: chunk number ``cursor + i`` takes buffer
    ``(cursor + i) % depth``, which chunk ``cursor + i - depth`` read
    last."""
    return [Step((cursor + i) % depth, start,
                 min(start + chunk_bytes, nbytes))
            for i, start in enumerate(range(0, nbytes, chunk_bytes))]


@functools.cache
def threads() -> int:
    """The host cores this process may run on: the staging's threads."""
    return len(os.sched_getaffinity(0))


@functools.cache
def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(threads(), thread_name_prefix="mba-stage")


def lanes(chunks: list, n: int) -> list[list]:
    """``chunks``, pairs (running count, chunk), dealt to ``n`` threads:
    chunk ``s`` to thread ``s % n``, the threads that get none left out.
    With a ring of a multiple of ``n`` buffers every buffer belongs to
    one thread, which refills it only after its own transfer from it has
    completed."""
    out = [[] for _ in range(n)]
    for seq, chunk in chunks:
        out[seq % n].append((seq, chunk))
    return [lane for lane in out if lane]


class _Ring:
    """The pinned buffers, their events and the copy stream of one
    device."""

    def __init__(self, device: torch.device):
        self.depth = BUFFERS_PER_THREAD * threads()
        self.stream = torch.cuda.Stream(device)
        self.buffers = [torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                    pin_memory=True)
                        for _ in range(self.depth)]
        self.views = [b.numpy() for b in self.buffers]
        self.events = [torch.cuda.Event() for _ in range(self.depth)]
        self.cursor = 0
        self.lock = threading.Lock()

    def run(self, lane) -> None:
        """One thread's chunks, in order: wait until the transfer that
        last read the chunk's buffer has completed, copy the chunk into
        the buffer, send it up on the copy stream, mark the buffer."""
        with torch.cuda.stream(self.stream):
            for step, src, dst in lane:
                self.events[step.slot].synchronize()
                n = step.stop - step.start
                np.copyto(self.views[step.slot][:n],
                          src[step.start:step.stop])
                dst[step.start:step.stop].copy_(
                    self.buffers[step.slot][:n], non_blocking=True)
                self.events[step.slot].record(self.stream)


_RINGS: dict[torch.device, _Ring] = {}
_RINGS_LOCK = threading.Lock()


def ring(device: torch.device) -> _Ring:
    """The ring of ``device`` (a CUDA device), made on first use."""
    device = torch.device("cuda", torch.cuda.current_device()
                          if device.index is None else device.index)
    with _RINGS_LOCK:
        if device not in _RINGS:
            _RINGS[device] = _Ring(device)
        return _RINGS[device]


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int8): torch.int8}


def stage(arrays, device: torch.device):
    """C-contiguous host arrays (float32, int16 or int8) → (their tensors
    on ``device``, the event on the copy stream after their last chunk).
    Returns once every byte is in the ring or on its way up; the caller's
    arrays are only read.  The tensors are allocated on the copy stream:
    before another stream uses them it waits on the event and calls
    ``record_stream``."""
    r = ring(device)
    with r.lock:
        with torch.cuda.stream(r.stream):
            dsts = [torch.empty(x.nbytes, dtype=torch.uint8, device=device)
                    for x in arrays]
        chunks = []
        for x, dst in zip(arrays, dsts):
            src = x.reshape(-1).view(np.uint8)
            plan = chunk_plan(x.nbytes, CHUNK_BYTES, r.depth, r.cursor)
            chunks += [(seq, (step, src, dst))
                       for seq, step in enumerate(plan, start=r.cursor)]
            r.cursor += len(plan)
        work = [[job for _, job in lane]
                for lane in lanes(chunks, threads())]
        if work:
            # the caller's thread runs the first lane, the pool the rest
            rest = [_pool().submit(r.run, lane) for lane in work[1:]]
            r.run(work[0])
            for f in rest:
                f.result()
        ready = torch.cuda.Event()
        ready.record(r.stream)
    return ([d.view(_TORCH_DTYPES[x.dtype]).view(x.shape)
             for x, d in zip(arrays, dsts)], ready)
