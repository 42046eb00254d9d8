"""Entry points of the PyTorch port: the single-card CMC step and a
multi-rank dry run (the port's counterpart of ``__graft_entry__.py``).

    python torch_entry.py [--ranks N] [--device cpu]

runs the dry run on N gloo ranks (default 8), then the CMC step once,
both on the card unless ``--device cpu`` is given.

``entry()`` returns the fused CMC forward step (tapered rFFT, then the
jackknifed EMG-max epilogue, kernel B1 on the card) and example
arguments on the card.

``dryrun_multichip(n)`` spawns ``n`` gloo ranks, builds the
('subjects', 'windows') mesh and runs one step of each mesh path on tiny
shapes: the cohort CMC, the time-sharded CMC, the phase-randomised null
and the cohort rotation null, with the checks of ``__graft_entry__.py``.
The ranks run on the card, rank r on ``cuda:(r % device_count)`` (gloo,
unlike NCCL, lets several ranks share one card), unless
``device_type="cpu"``.  Imports nothing of JAX or of ``mba_tpu``.
"""
from __future__ import annotations

import os
import tempfile
import time
from datetime import timedelta

import numpy as np

PG_TIMEOUT = timedelta(seconds=120)
JOIN_SEC = 600.0


def _tiny_problem(n_subjects=1, n_windows=8, window_samples=128,
                  n_eeg=4, n_emg=4, fs=256.0, seed=0):
    """``__graft_entry__._tiny_problem``: framed noise, the tapers, the
    jackknife's t quantile and the PSD scale."""
    from scipy.stats import t as t_dist
    from mba_tpu_torch.ops.dpss import filtered_tapers

    rng = np.random.default_rng(seed)
    shape = (n_subjects, n_windows, window_samples)
    eeg = rng.standard_normal(shape + (n_eeg,)).astype(np.float32)
    emg = rng.standard_normal(shape + (n_emg,)).astype(np.float32)
    tapers = filtered_tapers(window_samples, nw=3,
                             eigenvalue_threshold=0.9).astype(np.float32)
    K = tapers.shape[0]
    t_crit = np.float32(t_dist.ppf(0.975, K - 1))
    inv_fs_n = np.float32(1.0 / (fs * window_samples))
    return eeg, emg, tapers, inv_fs_n, t_crit


def entry(device=None):
    """(fn, example_args): the CMC forward step and its inputs, on the
    card unless ``device="cpu"``.  ``fn(eeg_frames, emg_frames)`` takes
    (W, S, E) and (W, S, M) frames and returns the coherence and its CI
    bounds, (W, F, E) each."""
    import torch
    from mba_tpu_torch._device import entry_device
    from mba_tpu_torch.ops.coherence import tapered_rfft
    from mba_tpu_torch.ops.cuda_msc import msc_jackknife

    device = entry_device(device)
    eeg, emg, tapers, inv_fs_n, t_crit = _tiny_problem()
    tapers_t = torch.from_numpy(tapers).to(device)

    def forward(eeg_frames, emg_frames):
        out = msc_jackknife(tapered_rfft(eeg_frames, tapers_t),
                            tapered_rfft(emg_frames, tapers_t),
                            float(t_crit), emg_max=True,
                            inv_fs_n=float(inv_fs_n))
        return out["coherence"], out["ci_lower"], out["ci_upper"]

    return forward, (torch.from_numpy(eeg[0]).to(device),
                     torch.from_numpy(emg[0]).to(device))


def _dryrun_rank(rank: int, n_ranks: int, store_path: str,
                 device_type: str) -> None:
    """One rank of :func:`dryrun_multichip`."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            store=dist.FileStore(store_path, n_ranks),
                            rank=rank, world_size=n_ranks,
                            timeout=PG_TIMEOUT)
    try:
        _dryrun_paths(n_ranks, rank, device_type)
    finally:
        dist.destroy_process_group()


def _dryrun_paths(n_ranks: int, rank: int, device_type: str) -> None:
    from mba_tpu_torch.ops.cohort_null import cohort_msc_rotation_null
    from mba_tpu_torch.ops.surrogate import msc_phase_randomized_null
    from mba_tpu_torch.parallel import (cohort_multitaper_msc, make_mesh,
                                        time_sharded_msc)
    from mba_tpu_torch.parallel.mesh import mesh_axis

    mesh = make_mesh(n_ranks, device_type=device_type)
    fs = 256.0
    rng = np.random.default_rng(0)
    n_sub = mesh_axis(mesh, "subjects") + 1        # force subject padding
    n = int(fs * 4)
    eeg = rng.standard_normal((n_sub, n, 3)).astype(np.float32)
    emg = rng.standard_normal((n_sub, n, 2)).astype(np.float32)

    # 1. the production cohort engine (masked, jackknifed, chunked)
    W = int((n - fs) // (fs / 2) + 1)
    masks = rng.random((n_sub, W)) < 0.7
    res = cohort_multitaper_msc(mesh, eeg, emg, fs, nw=3,
                                window_length_sec=1.0, window_masks=masks,
                                use_jackknife=True, aggregate_emg_max=True)
    coh = res["coherence_raw"]
    assert coh.shape[:2] == (n_sub, W)
    assert np.all((coh >= 0) & (coh <= 1))
    assert np.all(coh[~masks] == 0)
    assert res["cohort_mean"].shape == coh.shape[1:]

    # 2. time-axis halo sharding
    ts = time_sharded_msc(mesh, eeg[0], emg[0], fs, nw=3,
                          window_length_sec=1.0, overlap_frac=0.5,
                          use_jackknife=True)
    assert ts["coherence_raw"].shape[0] == W
    assert ts["metadata"]["n_time_shards"] == n_ranks

    # 3. the phase-randomised null, surrogate axis sharded
    null = msc_phase_randomized_null(
        eeg[0][:, :1], emg[0][:, :1], fs, n_surrogates=2 * n_ranks,
        window_length_sec=0.5, surrogate_chunk=2, max_stat_only=True,
        mesh=mesh)
    assert null["max_stat"].shape == (2 * n_ranks,)
    assert np.all((null["max_stat"] >= 0) & (null["max_stat"] <= 1))

    # 4. the cohort rotation null, subjects and surrogates sharded
    rot = cohort_msc_rotation_null(
        eeg, emg, fs, n_surrogates=2 * n_ranks, window_length_sec=0.5,
        band=(8.0, 48.0), surrogate_chunk=2, mesh=mesh)
    assert rot["max_stat"].shape == (2 * n_ranks,)
    assert 0 < rot["p_fwe"] <= 1

    if rank == 0:
        print(f"dryrun_multichip OK on {n_ranks} {device_type} ranks (mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}); "
              f"cohort CMC {coh.shape}, halo CMC "
              f"{ts['coherence_raw'].shape}, phase null "
              f"{null['max_stat'].shape}, rotation null "
              f"{rot['max_stat'].shape}", flush=True)


def dryrun_multichip(n_ranks: int, device_type: str = "cuda") -> None:
    """Run :func:`_dryrun_paths` on ``n_ranks`` gloo ranks (spawned,
    joined through a ``FileStore`` in a temporary directory), on the card
    unless ``device_type="cpu"``.  Raises before spawning where it names
    the card and there is none, and if a rank fails or the ranks outlast
    ``JOIN_SEC``."""
    import torch.multiprocessing as mp
    from mba_tpu_torch._device import entry_device

    device_type = entry_device(device_type).type
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _dryrun_rank,
            args=(n_ranks, os.path.join(tmp, "store"), device_type),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + JOIN_SEC
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dryrun_multichip({n_ranks}) did "
                                       f"not finish in {JOIN_SEC} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)


def main(argv=None) -> None:
    """The command line: the dry run, then the CMC step, both on
    ``--device`` (default the card)."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    cli = parser.parse_args(argv)
    dryrun_multichip(cli.ranks, device_type=cli.device)
    fn, args = entry(cli.device)
    out = fn(*args)
    print(f"entry() OK ({args[0].device}):", [tuple(o.shape) for o in out])


if __name__ == "__main__":
    main()
