"""The production CMC engine over a device mesh (port of
``mba_tpu/parallel/cohort.py``).

Both functions run SPMD: every rank of the mesh calls them with the same
host arrays, as JAX's single controller holds them, computes its own
block with the single-device window engine ``ops.coherence.
_msc_all_windows`` (kernel B1 on the card whenever ``use_jackknife`` is
set, its plain version on the CPU), and the blocks are all-gathered, so
every rank returns the JAX function's whole result.

- :func:`cohort_multitaper_msc`: rank (s, w) of the ('subjects',
  'windows') mesh computes its subjects × its slice of each subject's
  active windows;
- :func:`time_sharded_msc`: one recording split along time over the
  mesh's flat ranks, each block extended by the ``window − hop`` samples
  of its right neighbour (the halo), so every window is computed once.

The phase and rotation nulls take ``mesh=`` in ``ops.surrogate`` and
``ops.cohort_null``.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from mba_tpu_torch import _dist
from mba_tpu_torch._dist import check_mesh, flat_index, mesh_device
from mba_tpu_torch.ops.coherence import (_auto_chunk, _msc_all_windows,
                                         jackknife_t_crit)
from mba_tpu_torch.ops.dpss import filtered_tapers
from mba_tpu_torch.ops.framing import window_grid
from mba_tpu_torch.parallel.mesh import cohort_sharding
from mba_tpu_torch.utils import file_management as filemgmt


def _window_setup(window_length_sec, sampling_freq, overlap_frac, nw,
                  taper_eigenvalue_threshold, use_jackknife):
    """(window_samples, hop, tapers, K), with the engine's checks."""
    window_samples = int(window_length_sec * sampling_freq)
    hop = int(window_samples * (1 - overlap_frac))
    if hop <= 0:
        raise ValueError("overlap_frac too high: hop_samples becomes <= 0")
    tapers = filtered_tapers(window_samples, nw, taper_eigenvalue_threshold)
    K = int(tapers.shape[0])
    if use_jackknife and K < 2:
        raise ValueError("jackknife requires at least 2 tapers")
    return window_samples, hop, tapers, K


def _gather_blocks(local: dict, mesh, n_sub: int, n_win: int) -> dict:
    """All ranks' (jl, wl, ...) blocks → (n_sub·jl, n_win·wl, ...) on this
    rank's device, placed by each rank's (subjects, windows) coordinate
    (JAX's ``out_specs=P('subjects', 'windows')``)."""
    out = {}
    for key, block in local.items():
        parts = _dist.gather(block, mesh)
        rows = [torch.cat(parts[s * n_win:(s + 1) * n_win], dim=1)
                for s in range(n_sub)]
        out[key] = torch.cat(rows, dim=0)
    return out


def cohort_multitaper_msc(
        mesh,
        eeg_cohort,
        emg_cohort,
        sampling_freq: float,
        nw: float = 3,
        window_length_sec: float = 1.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        use_jackknife: bool = True,
        jackknife_alpha: float = 0.05,
        window_masks: np.ndarray | None = None,
        aggregate_emg_max: bool = False,
        window_chunk: int | None = None,
        output: str = "full",
        artifact_dir=None,
) -> dict:
    """Cohort CMC: the production engine under a device mesh.

    Same arguments and result dictionary as
    ``mba_tpu.parallel.cohort.cohort_multitaper_msc``, arrays as numpy:
    eeg_cohort (J, n, E) / emg_cohort (J, n, M); optional per-subject
    boolean ``window_masks`` (J, W) on the "cmc" grid (masked-out
    windows are exact zeros); ``cohort_mean`` averages each window over
    the subjects active in it; ``output="compact"`` returns each
    subject's active windows only, copied off the card one subject at a
    time, and with ``artifact_dir`` flat rank 0 writes them as ``.npz``
    files whose paths every rank returns.

    The subjects are padded to a multiple of the 'subjects' axis by
    repeating the last subject (the pad rows are computed and dropped),
    and each subject's active windows to a multiple of the 'windows'
    axis by repeating its first active start.  ``mesh`` comes from
    ``parallel.make_mesh``; the computation runs on its device.
    """
    if output not in ("full", "compact"):
        raise ValueError(f"output must be 'full' or 'compact', "
                         f"got {output!r}")
    if artifact_dir is not None and output != "compact":
        raise ValueError("artifact_dir requires output='compact'")
    check_mesh(mesh)
    device = mesh_device(mesh)
    eeg = np.asarray(eeg_cohort, np.float32)
    emg = np.asarray(emg_cohort, np.float32)
    if eeg.ndim != 3 or emg.ndim != 3 or eeg.shape[:2] != emg.shape[:2]:
        raise ValueError("cohort arrays must be (J, n_samples, n_channels) "
                         "with matching (J, n_samples)")
    J, n_samples, n_eeg = eeg.shape
    n_emg = emg.shape[2]
    window_samples, hop, tapers, K = _window_setup(
        window_length_sec, sampling_freq, overlap_frac, nw,
        taper_eigenvalue_threshold, use_jackknife)
    starts, time_centers = window_grid(
        n_samples, window_samples, hop, sampling_freq, convention="cmc")
    W = len(starts)
    freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)

    if window_masks is None:
        actives = [np.arange(W)] * J
    else:
        window_masks = np.asarray(window_masks, bool)
        if window_masks.shape != (J, W):
            raise ValueError(f"window_masks must be (J, {W}), "
                             f"got {window_masks.shape}")
        actives = [np.nonzero(m)[0] for m in window_masks]

    sharding = cohort_sharding(mesh)
    n_sub, n_win = sharding.shape
    s, w = sharding.coordinate
    w_act_max = max((len(a) for a in actives), default=0)
    tail = (freqs.shape[0], n_eeg) if aggregate_emg_max \
        else (freqs.shape[0], n_eeg, n_emg)
    keys = ["coherence"] + (["ci_lower", "ci_upper"] if use_jackknife
                            else [])
    dense = None
    if w_act_max > 0:
        wl = math.ceil(w_act_max / n_win)
        jl = math.ceil(J / n_sub)
        fused = use_jackknife and device.type == "cuda"
        chunk = int(min(window_chunk or _auto_chunk(
            window_samples, K, n_eeg, n_emg, use_jackknife, fused), wl))
        tapers_t = torch.as_tensor(tapers, dtype=torch.float32,
                                   device=device)
        t_crit = jackknife_t_crit(K, jackknife_alpha)
        inv_fs_n = float(np.float32(1.0 / (sampling_freq * window_samples)))
        local: dict[str, list] = {k: [] for k in keys}
        for j in range(s * jl, (s + 1) * jl):
            src = min(j, J - 1)        # pad subjects repeat the last one
            act = actives[src]
            row = np.full(n_win * wl, starts[act[0]] if len(act)
                          else starts[0], np.int64)
            row[:len(act)] = starts[act]
            out = _msc_all_windows(
                torch.from_numpy(eeg[src]).to(device),
                torch.from_numpy(emg[src]).to(device),
                torch.from_numpy(row[w * wl:(w + 1) * wl]).to(device),
                tapers_t, inv_fs_n, t_crit, window_samples, chunk,
                use_jackknife, aggregate_emg_max)
            for k in keys:
                local[k].append(out[k])
        dense = _gather_blocks({k: torch.stack(v) for k, v in local.items()},
                               mesh, n_sub, n_win)

    # cross-subject mean over the subjects active in each window
    counts = np.zeros(W, np.float32)
    for act in actives:
        counts[act] += 1.0
    denom = np.maximum(counts, 1.0).reshape((W,) + (1,) * len(tail))
    metadata = {
        "K_tapers": K,
        "n_subjects": J,
        "n_windows": W,
        "window_length_sec": window_length_sec,
        "overlap_frac": overlap_frac,
        "use_jackknife": use_jackknife,
        "mesh": {"subjects": n_sub, "windows": n_win},
        "output": output,
    }

    if output == "compact":
        cohort_sum = np.zeros((W,) + tail, np.float32)
        subjects = []
        writes = artifact_dir is not None and flat_index(mesh) == 0
        for j in range(J):
            act = actives[j]
            sub = {"active_windows": act}
            for k in keys:
                sub[k] = (dense[k][j, :len(act)].cpu().numpy()
                          if dense is not None and len(act)
                          else np.zeros((len(act),) + tail, np.float32))
            cohort_sum[act] += sub["coherence"]   # act indices unique
            if artifact_dir is None:
                subjects.append(sub)
                continue
            path = None
            if writes:
                adir = Path(artifact_dir)
                filemgmt.assert_dir(adir)
                path = adir / filemgmt.file_title(
                    f"Cohort CMC subject_{j:02} compact", ".npz")
                np.savez(path, time_centers=time_centers, freqs=freqs,
                         **sub)
                path = str(path)
            subjects.append({"path": path, "active_windows": act})
            del sub
        if artifact_dir is not None:
            paths = _dist.broadcast_object([d["path"] for d in subjects],
                                          mesh)
            for d, path in zip(subjects, paths):
                d["path"] = path
        return {
            "subjects": subjects,
            "cohort_mean": (cohort_sum / denom).astype(np.float32),
            "time_centers": time_centers,
            "freqs": freqs,
            "metadata": metadata,
        }

    full = {k: np.zeros((J, W) + tail, np.float32) for k in keys}
    if dense is not None:
        for k in keys:
            host = dense[k][:J].cpu().numpy()
            for j in range(J):
                act = actives[j]
                full[k][j][act] = host[j, :len(act)]
    cohort_mean = full["coherence"].sum(axis=0) / denom
    result = {
        "coherence_raw": full["coherence"],
        "cohort_mean": cohort_mean.astype(np.float32),
        "time_centers": time_centers,
        "freqs": freqs,
        "metadata": metadata,
    }
    if use_jackknife:
        result["coherence_ci_lower"] = full["ci_lower"]
        result["coherence_ci_upper"] = full["ci_upper"]
    return result


def time_sharded_msc(
        mesh,
        eeg,
        emg,
        sampling_freq: float,
        nw: float = 3,
        window_length_sec: float = 1.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        use_jackknife: bool = True,
        jackknife_alpha: float = 0.05,
        aggregate_emg_max: bool = False,
        window_chunk: int | None = None,
) -> dict:
    """CMC of ONE recording sharded along time with a halo exchange.

    Same arguments and result dictionary as
    ``mba_tpu.parallel.cohort.time_sharded_msc``.  The signal is cut
    into blocks of ``w_loc · hop`` samples over the mesh's flat ranks
    (zero-padded past its end); flat rank i receives the first ``window
    − hop`` samples of rank i + 1's block, and the last rank takes them
    from the recording's tail, so each window crossing a block edge is
    computed once, locally.  A block shorter than the halo raises
    ``ValueError`` (the JAX function fails there too, in broadcasting).
    """
    check_mesh(mesh)
    device = mesh_device(mesh)
    eeg = np.asarray(eeg, np.float32)
    emg = np.asarray(emg, np.float32)
    if eeg.ndim != 2 or emg.ndim != 2 or eeg.shape[0] != emg.shape[0]:
        raise ValueError("eeg/emg must be (n_samples, n_channels) with "
                         "equal n_samples")
    n_samples, n_eeg = eeg.shape
    n_emg = emg.shape[1]
    window_samples, hop, tapers, K = _window_setup(
        window_length_sec, sampling_freq, overlap_frac, nw,
        taper_eigenvalue_threshold, use_jackknife)
    halo = window_samples - hop
    starts, time_centers = window_grid(
        n_samples, window_samples, hop, sampling_freq, convention="cmc")
    W = len(starts)
    freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)

    n_dev = mesh.size()
    i = flat_index(mesh)
    fused = use_jackknife and device.type == "cuda"
    chunk = window_chunk or _auto_chunk(window_samples, K, n_eeg, n_emg,
                                        use_jackknife, fused)
    w_loc = math.ceil(W / n_dev)
    chunk = int(min(chunk, w_loc))
    w_loc = chunk * math.ceil(w_loc / chunk)
    block = w_loc * hop
    if halo > block:
        raise ValueError(f"each of the {n_dev} time shards holds {block} "
                         f"samples, fewer than the {halo}-sample halo; use "
                         "fewer ranks or a longer recording")

    # every rank holds `block` samples; the last one also the tail
    # beyond the sharded extent (its halo)
    n_shard = n_dev * block
    n_ext = n_shard + halo

    def piece(x, lo, hi):
        out = np.zeros((hi - lo, x.shape[1]), np.float32)
        got = x[lo:min(hi, n_samples)]
        out[:len(got)] = got
        return torch.from_numpy(out).to(device)

    ext = []
    for x in (eeg, emg):
        local = piece(x, i * block, (i + 1) * block)
        if halo:
            recv = _dist.from_next_rank(local[:halo], mesh)
            h = piece(x, n_shard, n_ext) if i == n_dev - 1 else recv
            local = torch.cat([local, h])
        ext.append(local)
    local_starts = torch.arange(w_loc, dtype=torch.int64,
                                device=device) * hop
    out = _msc_all_windows(
        ext[0], ext[1], local_starts,
        torch.as_tensor(tapers, dtype=torch.float32, device=device),
        float(np.float32(1.0 / (sampling_freq * window_samples))),
        jackknife_t_crit(K, jackknife_alpha), window_samples, chunk,
        use_jackknife, aggregate_emg_max)
    out = {k: torch.cat(_dist.gather(v, mesh))[:W].cpu().numpy()
           for k, v in out.items()}

    result = {
        "coherence_raw": out["coherence"],
        "time_centers": time_centers,
        "freqs": freqs,
        "metadata": {
            "K_tapers": K,
            "n_windows": W,
            "window_length_sec": window_length_sec,
            "overlap_frac": overlap_frac,
            "use_jackknife": use_jackknife,
            "halo_samples": halo,
            "n_time_shards": n_dev,
            "samples_per_shard": block,
        },
    }
    if use_jackknife:
        result["coherence_ci_lower"] = out["ci_lower"]
        result["coherence_ci_upper"] = out["ci_upper"]
    return result
