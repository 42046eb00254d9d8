"""Gloo CPU ranks for the mesh tests of ``mba_tpu_torch.parallel``.

:func:`run_ranks` spawns n processes that join one gloo process group
through a ``FileStore`` (no TCP), build ``make_mesh(device_type="cpu")``
and call a function of this module on it; each rank pickles what it
returns.  The process group and the join have timeouts, so a hung rank
fails the test within about a minute.  This module imports no JAX: the
ranks import only torch and the port.
"""
from __future__ import annotations

import os
import pickle
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

PG_TIMEOUT = timedelta(seconds=60)
JOIN_SEC = 300.0
FS = 256.0


def run_ranks(fn, n: int, tmp_path: Path, *args) -> list:
    """``fn(mesh, *args)`` on ``n`` gloo CPU ranks; every rank's result,
    in rank order.  A rank that raises, or a join past ``JOIN_SEC``,
    fails the call; no rank outlives it."""
    import torch.multiprocessing as mp

    tmp_path = Path(tmp_path)
    ctx = mp.start_processes(_rank_main, args=(n, str(tmp_path), fn, args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SEC
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {n} ranks did not "
                                   f"finish in {JOIN_SEC} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    out = []
    for r in range(n):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, n, tmp, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), n),
        rank=rank, world_size=n, timeout=PG_TIMEOUT)
    try:
        from mba_tpu_torch.parallel import make_mesh
        result = fn(make_mesh(device_type="cpu"), *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _error(fn, *args, **kw) -> str | None:
    """``'TypeName: message'`` of what ``fn`` raises, else None."""
    try:
        fn(*args, **kw)
    except Exception as exc:         # the test reads the type and text
        return f"{type(exc).__name__}: {exc}"
    return None


# ---- inputs, made with numpy from a seed -----------------------------------

def cohort_signals(n_subjects=3, seconds=8.0, n_eeg=3, n_emg=2, seed=0):
    """``tests/test_parallel.py:_cohort_signals``."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    shared = rng.standard_normal(n)
    eeg = np.stack([0.5 * shared[:, None] + rng.standard_normal((n, n_eeg))
                    for _ in range(n_subjects)]).astype(np.float32)
    emg = np.stack([0.5 * shared[:, None] + rng.standard_normal((n, n_emg))
                    for _ in range(n_subjects)]).astype(np.float32)
    return eeg, emg


def masks_for(eeg, seed=2, p=0.6):
    """Random per-subject window masks on the 1-s, 50 % grid, subject 1
    missing its first three windows and subject 0 keeping its first
    two."""
    W = int((eeg.shape[1] - FS) // (FS / 2) + 1)
    masks = np.random.default_rng(seed).random((eeg.shape[0], W)) < p
    masks[0, :2] = True
    masks[1, :3] = False
    return masks


def time_signals(seconds=10.0, seed=2):
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    return (rng.standard_normal((n, 2)).astype(np.float32),
            rng.standard_normal((n, 2)).astype(np.float32))


def null_pair(seed=4, seconds=12.0, couple=0.8, n_eeg=2, n_emg=4):
    """A stochastic 15-30 Hz shared drive under noise in every EEG and
    EMG channel (``tests/test_parallel.py:_signals`` with more channels:
    2 × 4 pairs give the phase null 1 032 histogram cells, enough for
    the 1e-3 share of one-bin ties its tolerance allows to mean one)."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    f = np.fft.rfftfreq(n, 1 / FS)
    spec = np.fft.rfft(rng.standard_normal(n))
    spec[(f < 15) | (f > 30)] = 0
    shared = np.fft.irfft(spec, n=n)
    shared /= shared.std() + 1e-12
    eeg = (couple * shared[:, None]
           + rng.standard_normal((n, n_eeg))).astype(np.float32)
    emg = (couple * shared[:, None]
           + rng.standard_normal((n, n_emg))).astype(np.float32)
    return eeg, emg


CMC_KW = dict(nw=3, window_length_sec=1.0, use_jackknife=True)
TIME_OVERLAPS = (0.5, 0.0, 0.75)
ROT_KW = dict(n_surrogates=48, window_length_sec=1.0, band=(8.0, 48.0),
              surrogate_chunk=16, seed=3)
PHASE_KW = dict(n_surrogates=40, window_length_sec=1.0, surrogate_chunk=8,
                quantiles=(0.9, 0.95), seed=5)


# ---- what the ranks run -----------------------------------------------------

def two_rank_cases(mesh, artifact_dir):
    """Every 2-rank case of ``tests/test_torch_parallel.py``."""
    from mba_tpu_torch.ops.cohort_null import cohort_msc_rotation_null
    from mba_tpu_torch.ops.surrogate import msc_phase_randomized_null
    from mba_tpu_torch.parallel import (cohort_multitaper_msc,
                                        cohort_sharding, time_sharded_msc)

    out = {"mesh_shape": tuple(mesh.mesh.shape),
           "mesh_names": mesh.mesh_dim_names,
           "sharding": cohort_sharding(mesh)}
    eeg, emg = cohort_signals(3)
    for emg_max in (False, True):
        out[f"cohort_emg_max={emg_max}"] = cohort_multitaper_msc(
            mesh, eeg, emg, FS, aggregate_emg_max=emg_max, **CMC_KW)
    meeg, memg = cohort_signals(3, seconds=6.0, seed=1)
    masks = masks_for(meeg)
    out["masks"] = masks
    out["masked_full"] = cohort_multitaper_msc(
        mesh, meeg, memg, FS, window_masks=masks, **CMC_KW)
    out["masked_compact"] = cohort_multitaper_msc(
        mesh, meeg, memg, FS, window_masks=masks, output="compact",
        **CMC_KW)
    out["masked_artifacts"] = cohort_multitaper_msc(
        mesh, meeg, memg, FS, window_masks=masks, output="compact",
        artifact_dir=artifact_dir, **CMC_KW)
    out["all_masked"] = cohort_multitaper_msc(
        mesh, meeg[:2], memg[:2], FS,
        window_masks=np.zeros((2, masks.shape[1]), bool), **CMC_KW)
    teeg, temg = time_signals()
    for ov in TIME_OVERLAPS:
        out[f"time_overlap={ov}"] = time_sharded_msc(
            mesh, teeg, temg, FS, overlap_frac=ov, **CMC_KW)
    out["time_halo_error"] = _error(
        time_sharded_msc, mesh, teeg[:448], temg[:448], FS,
        overlap_frac=0.75, window_chunk=1, **CMC_KW)
    reeg, remg = cohort_signals(3, seconds=8.0, seed=6)
    for engine in ("gram", "pallas"):
        out[f"rotation_{engine}"] = cohort_msc_rotation_null(
            reeg, remg, FS, mesh=mesh, coeff_engine=engine, **ROT_KW)
    out["rotation_int16_bf16"] = cohort_msc_rotation_null(
        reeg, remg, FS, mesh=mesh, transfer_dtype=np.int16,
        compute_dtype="bfloat16", **ROT_KW)
    out["rotation_per_window_error"] = _error(
        cohort_msc_rotation_null, reeg, remg, FS, mesh=mesh,
        rotation_mode="per_window", **ROT_KW)
    out["rotation_device_error"] = _error(
        cohort_msc_rotation_null, reeg, remg, FS, mesh=mesh, device="meta",
        **ROT_KW)
    peeg, pemg = null_pair()
    out["phase"] = msc_phase_randomized_null(peeg, pemg, FS, mesh=mesh,
                                             **PHASE_KW)
    out["phase_max_only"] = msc_phase_randomized_null(
        peeg, pemg, FS, mesh=mesh, max_stat_only=True, **PHASE_KW)
    return out


def four_rank_cases(mesh):
    """The (2, 2) mesh: a windows axis above 1, and 4 time shards."""
    from mba_tpu_torch.parallel import (cohort_multitaper_msc,
                                        cohort_sharding, time_sharded_msc)

    meeg, memg = cohort_signals(3, seconds=6.0, seed=1)
    masks = masks_for(meeg)
    teeg, temg = time_signals()
    return {"mesh_shape": tuple(mesh.mesh.shape),
            "sharding": cohort_sharding(mesh),
            "masks": masks,
            "cohort": cohort_multitaper_msc(mesh, meeg, memg, FS,
                                            aggregate_emg_max=True,
                                            window_masks=masks, **CMC_KW),
            "time": time_sharded_msc(mesh, teeg, temg, FS, overlap_frac=0.5,
                                     **CMC_KW)}


def phase_null_spans_on_and_off(mesh):
    """The phase null on ``mesh`` as it records, then with its spans and
    counters made no-ops (``tests/test_torch_spans.py``)."""
    from mba_tpu_torch.ops import surrogate as TS
    from mba_tpu_torch.utils import profiling as TP

    eeg, emg = null_pair(n_emg=2)
    out = {"on": TS.msc_phase_randomized_null(eeg, emg, FS, mesh=mesh,
                                              **PHASE_KW)}
    span, count = TS.span, TS.count
    TS.span, TS.count = (lambda name: TP._NO_SPAN), (lambda *a, **k: None)
    try:
        out["off"] = TS.msc_phase_randomized_null(eeg, emg, FS, mesh=mesh,
                                                  **PHASE_KW)
    finally:
        TS.span, TS.count = span, count
    return out
