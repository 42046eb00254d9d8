#!/usr/bin/env python3
"""One-off measurements on an NVIDIA card, outside ``chip_smoke.py``'s
permanent run.

    python3 chip_probe.py reml-profile
    python3 chip_probe.py fft-null [--tree DIR] [--repeats N]
    python3 chip_probe.py null-tile-split [--repeats N]
    python3 chip_probe.py mesh-reference
    python3 chip_probe.py coeff-dispatch --parent DIR [--repeats N]
    python3 chip_probe.py coeff-split [--parent DIR] [--repeats N]

``reml-profile``: one ``lme._REML_BLOCK``-response block of the power
grid's RQ-A Level-1 design (``chip_smoke.make_statistics_frame``) under
``torch.profiler``, after a warm block: the block's wall, the card's
kernel time and the number of kernels, so the share of the wall the card
is busy says whether launches bound the grid.

``fft-null``: ``chip_smoke.run_fft_null`` of the ``chip_smoke.py`` in
DIR (this checkout by default), after building that tree's kernels, N
times in one process on one cohort; the first call is cold, as in
``chip_smoke.py``'s run.  Run it on two trees in turns to compare them.

``null-tile-split``: where B2's 16-bit kernel (``csrc/null_tile_tc.cu``)
spends its time.  The library is built from edited copies of the source
(``NULL_TC_FORMS``), each timed in bf16 on ``chip_smoke``'s 500-surrogate
chunk at the main path's shapes: as it is; without the epilogue; the
tensor cores alone (no epilogue, and no loads or barrier waits after
each ring's first fill, so the products run on stale slices); and
without the warpgroups' turns.  Only the first form computes the
statistic: the others are timings, not results.

``mesh-reference``: which side of ``chip_smoke.py``'s two-rank small
mesh check moves from host to host (ROADMAP C15).  Two gloo ranks on the
card, spawned as the check spawns them, once for each MKL setting of
their environment (none; the AVX2 and the SSE4.2 code paths a host
without AVX-512, or older, takes; ``chip_smoke.MESH_RANK_ENV``, alone
and with AVX2): each rank runs the four small calls on the card once
and on the CPU at 1, 2, 4 and ``os.cpu_count()`` threads.  Reports
whether the card's results are bit for bit the same in every spawn and
rank, how far each CPU result lies from the first one (no setting, one
thread), and whether each passes ``chip_smoke.small_mesh_close``
against the card.

``coeff-dispatch``: where B3's runtime-K instance (``csrc/coeff_pairs.cu``,
``cuda_coeffs.coeff_pairs_runtime_k``) beats the compile-time instances
of the tree in DIR (its ``mba_tpu_torch/csrc/coeff_pairs.cu``
built alone into ``_build/probe_parent/`` and called through its
``mba_coeff_pairs``), on ``chip_smoke``'s main-path chunk at K = 12 to 17
(nw 6.5 to 9): both forms (plain and ``out=``) of each, N times, and
this tree's ``coeff_pairs`` (whatever its dispatch picks).

``coeff-split``: where B3's runtime-K instance spends its time at K = 17
on ``chip_smoke``'s main-path chunk.  ``csrc/coeff_pairs.cu`` is built
alone, once as it is and once for each edit of ``COEFF_FORMS`` (into
``_build/probe_coeff_*``, all nvcc processes at once, with ``-Xptxas
-v``), and each library's ``mba_coeff_pairs_rt`` timed: as it is; with
at most 12 or 8 warps a block (up to 168 or 255 registers a thread,
where 16 warps leave 128; two passes over the windows at K = 17's 15
tiles);
without the tiles' sums (the FMA work); without forming the products y;
without staging the spectra (the products then read stale slots);
without storing the sums; and, given ``--parent DIR``, DIR's source as
it is.  The first three forms and DIR's compute the sums, the others are
timings, not results.  Each form reports the registers and spills ptxas
gives ``coeff_pairs_rt_kernel``.

Each prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

_EPILOGUE = [("        if (r0 - (lane >> 2) + 16 <= S)", "        if (S < 0)"),
             ("        else\n          epilogue<false>",
              "        else if (S < 0)\n          epilogue<false>")]
# form: edits of csrc/null_tile_tc.cu, (old, new), each old text once
NULL_TC_FORMS = {
    "as_is": [],
    "no_epilogue": _EPILOGUE,
    "tensor_cores_alone": _EPILOGUE + [
        ("mbar_wait(&sh.empty_b[slot], ((ib / B_STAGES) & 1) ^ 1);",
         "if (ib >= (uint32_t)B_STAGES) return;"),
        ("mbar_wait(&sh.empty_a[g][slot], ((ia / A_STAGES) & 1) ^ 1);",
         "if (ia >= (uint32_t)A_STAGES) return;"),
        ("mbar_wait(&sh.full_b[sb], (jb / B_STAGES) & 1);",
         "if (jb < (uint32_t)B_STAGES) mbar_wait(&sh.full_b[sb], 0);"),
        ("mbar_wait(&sh.full_a[g][sa], (ia / A_STAGES) & 1);",
         "if (ia < (uint32_t)A_STAGES) mbar_wait(&sh.full_a[g][sa], 0);"),
        ("mbar_arrive(&sh.empty_a[g][(ia0 + k) % A_STAGES]);", ";"),
        ("if (free_b) mbar_arrive(&sh.empty_b[(jb0 + k) % B_STAGES]);", ";")],
    "no_turns": [("if (resident && (g == 1 || !first))", "if (false)"),
                 ("if (resident) mbar_arrive(&sh.turn[1 - g]);", "")],
}


def reml_profile(smoke) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mba_tpu_torch.models import lme as TL
    device = torch.device("cuda")
    design, _, groups = smoke.level1_design(smoke.make_statistics_frame())
    Y = 0.9 + np.random.default_rng(0).normal(
        0.0, smoke.STAT_RESID_SD, (TL._REML_BLOCK, len(groups)))
    TL.batched_lme_pvalues(design, Y, groups, device=device)
    torch.cuda.synchronize()
    diag = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        TL.batched_lme_pvalues(design, Y, groups, device=device,
                               diagnostics=diag)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    return {"probe": "reml-profile", "responses": TL._REML_BLOCK,
            "design_columns": design.shape[1], "wall_sec": wall,
            "solve_sec": diag["solve_sec"][0], "device_busy_sec": busy,
            "device_busy_share": busy / wall,
            "kernels": sum(e.count for e in events)}


def fft_null(smoke, repeats: int) -> dict:
    import torch
    smoke._build.build()
    smoke._build.load_library()
    device = torch.device("cuda")
    cohort = smoke.make_cohort(smoke.FFT_SUBJECTS, smoke.FFT_SECONDS,
                               smoke.PW_CHANNELS, smoke.PW_CHANNELS)
    runs = [smoke.run_fft_null(cohort, device) for _ in range(repeats)]
    return {"probe": "fft-null", "tree": str(Path(smoke.__file__).parent),
            "null_sec": [r["null_sec"] for r in runs],
            "wall_sec": [r["wall_sec"] for r in runs]}


def null_tile_split(smoke, repeats: int) -> dict:
    import torch
    from mba_tpu_torch.ops import cuda_null
    build, device = smoke._build, torch.device("cuda")
    src = (build.CSRC_DIR / "null_tile_tc.cu").read_text()
    csrc, build_dir = build.CSRC_DIR, build.BUILD_DIR
    state, key, K = smoke.null_check_state(device, dtype=torch.bfloat16,
                                           seed=1)
    J, S, nF = state.n_subjects, smoke.SURROGATE_CHUNK, state.coefT.shape[0]
    G = cuda_null.null_features(smoke.TN.phase_features(smoke.TN.draw_phases(
        smoke.prng.split(key)[1], J, S, K, nF, device)), torch.bfloat16)
    args = (G, state.coefT, state.base_flat, state.observed_flat, J, S)
    out = {}
    for form, edits in NULL_TC_FORMS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{form}: the source lacks {old!r}")
            text = text.replace(old, new)
        tree = build_dir / f"probe_{form}"
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(csrc, tree / "csrc")
        (tree / "csrc" / "null_tile_tc.cu").write_text(text)
        build.CSRC_DIR, build.BUILD_DIR = tree / "csrc", tree / "build"
        build.load_library.cache_clear()
        try:
            build.load_library()
            out[form] = [smoke.cuda_ms(lambda: cuda_null.null_tile(*args), 20)
                         for _ in range(repeats)]
        finally:
            build.CSRC_DIR, build.BUILD_DIR = csrc, build_dir
            build.load_library.cache_clear()
    return {"probe": "null-tile-split", "dtype": "bfloat16",
            "shape": [nF, S, G.shape[1], state.base_flat.shape[1]],
            "ms": out}


# name: (whether chip_smoke.MESH_RANK_ENV is set, what else is)
MESH_MKL_SETTINGS = {
    "none": (False, {}),
    "mkl_avx2": (False, {"MKL_ENABLE_INSTRUCTIONS": "AVX2"}),
    "mkl_sse4_2": (False, {"MKL_ENABLE_INSTRUCTIONS": "SSE4_2"}),
    "mesh_rank_env": (True, {}),
    "mesh_rank_env_avx2": (True, {"MKL_ENABLE_INSTRUCTIONS": "AVX2"}),
}


def _mesh_reference_rank(rank, n_ranks, work, thread_counts) -> None:
    """One spawned rank of ``mesh-reference``: the small calls on the
    card, then on the CPU at each of ``thread_counts``."""
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    import chip_smoke as smoke
    from mba_tpu_torch.parallel import make_mesh
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), n_ranks),
        rank=rank, world_size=n_ranks,
        timeout=datetime.timedelta(seconds=smoke.MESH_PG_TIMEOUT_SEC))
    try:
        smoke._build.load_library()
        mesh, cpu_mesh = make_mesh(), make_mesh(device_type="cpu")
        out = {"card": smoke._small_mesh_results(mesh), "cpu": {},
               "cpu_info": {}}
        torch.cuda.synchronize()
        for t in thread_counts:
            torch.set_num_threads(t)
            out["cpu"][t] = smoke._small_mesh_results(cpu_mesh)
            out["cpu_info"][t] = smoke.cpu_info()
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _flat(results) -> dict:
    import numpy as np
    return {f"{call}/{key}": np.asarray(v)
            for call, d in results.items() for key, v in d.items()
            if isinstance(v, (np.ndarray, float, int, np.generic))}


def _max_diffs(a, b) -> dict:
    """Per key of two flat results: the largest |a − b| (NaN where both
    are NaN counts as equal) and the number of elements that differ."""
    import numpy as np
    out = {}
    for k in a:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        same = (x == y) | (np.isnan(x) & np.isnan(y))
        d = np.where(same, 0.0, np.abs(x - y))
        out[k] = [float(np.nan_to_num(d, nan=np.inf).max(initial=0.0)),
                  int((~same).sum())]
    return out


def mesh_reference(smoke) -> dict:
    import numpy as np
    smoke._build.build()
    counts = sorted({1, 2, 4, os.cpu_count() or 1})
    runs = {}
    for name, (rank_env, extra) in MESH_MKL_SETTINGS.items():
        env = {**(smoke.MESH_RANK_ENV if rank_env else {}), **extra}
        wall, ranks = smoke.spawn_mesh_ranks(_mesh_reference_rank,
                                             (counts,), env)
        runs[name] = {"env": env, "wall_sec": wall, "ranks": ranks}
    card0 = _flat(runs["none"]["ranks"][0]["card"])
    cpu0 = _flat(runs["none"]["ranks"][0]["cpu"][1])
    out = {"parent_cpu_info": smoke.cpu_info(), "thread_counts": counts,
           "settings": {}}
    for name, run in runs.items():
        ranks = run["ranks"]
        card_same = all(
            all(v[1] == 0 for v in _max_diffs(card0, _flat(r["card"]))
                .values()) for r in ranks)
        per_t = {}
        for t in counts:
            cpu = ranks[0]["cpu"][t]
            d = _max_diffs(cpu0, _flat(cpu))
            try:
                errs = smoke.small_mesh_close(ranks[0]["card"], cpu,
                                              f"{name} t={t}")
                verdict = "pass"
            except AssertionError as exc:
                errs, verdict = None, f"fail: {exc}"
            per_t[t] = {
                "cpu_vs_first": {k: v for k, v in d.items() if v[1]},
                "ranks_cpu_equal": all(
                    all(v[1] == 0 for v in _max_diffs(
                        _flat(cpu), _flat(r["cpu"][t])).values())
                    for r in ranks),
                "card_vs_cpu": verdict, "card_vs_cpu_max_abs_err": errs,
                "cpu_info": ranks[0]["cpu_info"][t]}
        out["settings"][name] = {"env": run["env"],
                                 "wall_sec": run["wall_sec"],
                                 "card_equal_to_first_spawn": card_same,
                                 "threads": per_t}
    return out


DISPATCH_NWS = (6.5, 7, 7.5, 8, 8.5, 9)      # K = 12 .. 17
# coeff-split: form -> [(text in csrc/coeff_pairs.cu, replacement)]
COEFF_FORMS = {
    "as_is": [],
    "warps12": [("constexpr int RT_MAX_WARPS = 16;",
                 "constexpr int RT_MAX_WARPS = 12;")],
    "warps8": [("constexpr int RT_MAX_WARPS = 16;",
                "constexpr int RT_MAX_WARPS = 8;")],
    "no_sums": [("      if (i < na && tile < g.n_tiles) sums(i);",
                 "      if (i < na && tile < 0) sums(i);")],
    "no_products": [("      if (i < np) products(i);",
                     "      if (i < 0) products(i);")],
    "no_staging": [("    stage(it + 2);\n", "    cp_async_commit();\n")],
    "no_stores": [("    if (it == 0 || l.grp != g.groups - 1) continue;",
                   "    if (it == 0 || l.grp != g.groups - 1 || l.f >= 0) "
                   "continue;")],
}


def coeff_dispatch(smoke, parent: Path, repeats: int) -> dict:
    import ctypes
    import subprocess
    import torch
    from mba_tpu_torch.ops import cuda_coeffs
    build, device = smoke._build, torch.device("cuda")
    build.build()
    build.load_library()
    out_dir = build.BUILD_DIR / "probe_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libparent_coeff_pairs.so"
    src = parent / "mba_tpu_torch" / "csrc" / "coeff_pairs.cu"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(src)], check=True)
    parent_fn = ctypes.CDLL(str(lib_path)).mba_coeff_pairs
    # the parent's entry: eeg, emg, weights, diag, pr, pi, wc, K, F, E, M,
    # accumulate, stream
    parent_fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    parent_fn.restype = ctypes.c_int
    cohort = smoke.make_cohort(1, smoke.SECONDS, smoke.N_EEG, smoke.N_EMG)
    rows = []
    for nw in DISPATCH_NWS:
        (e, m, w), second = smoke.coeff_chunks(cohort, device, nw)
        wc, K, nF, nE = e.shape
        nM = m.shape[-1]
        sums = cuda_coeffs.coeff_pairs(e, m, w)

        def parent_call(chunk, accumulate):
            ce, cm, cw = chunk
            stream = torch.cuda.current_stream().cuda_stream
            code = parent_fn(
                torch.view_as_real(ce).data_ptr(),
                torch.view_as_real(cm).data_ptr(), cw.data_ptr(),
                *(x.data_ptr() for x in sums), wc, K, nF, nE, nM,
                int(accumulate), stream)
            if code != 0:
                raise RuntimeError(f"parent mba_coeff_pairs: error {code}")
        row = {"K": K, "shape": [wc, K, nF, nE, nM]}
        for name, plain, acc in (
                ("parent", lambda: parent_call((e, m, w), False),
                 lambda: parent_call(second, True)),
                ("runtime_k",
                 lambda: cuda_coeffs.coeff_pairs_runtime_k(e, m, w),
                 lambda: cuda_coeffs.coeff_pairs_runtime_k(*second,
                                                           out=sums)),
                ("dispatched", lambda: cuda_coeffs.coeff_pairs(e, m, w),
                 lambda: cuda_coeffs.coeff_pairs(*second, out=sums))):
            row[f"{name}_ms"] = [smoke.cuda_ms(plain, 5)
                                 for _ in range(repeats)]
            row[f"{name}_accumulate_ms"] = [smoke.cuda_ms(acc, 5)
                                            for _ in range(repeats)]
        rows.append(row)
        del sums, e, m, w, second
        torch.cuda.empty_cache()
    return {"probe": "coeff-dispatch", "parent": str(parent), "rows": rows}


def _rt_ptxas(text: str) -> dict:
    """Registers and spill bytes of ``coeff_pairs_rt_kernel`` in the
    ``-Xptxas -v`` output ``text``."""
    import re
    out, ours = {}, False
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            ours = "coeff_pairs_rt_kernel" in entry.group(1)
        elif ours and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            out["spill_stores"], out["spill_loads"] = map(int, m.groups())
        elif ours and (m := re.search(r"Used (\d+) registers", line)):
            out["registers"] = int(m.group(1))
    return out


def coeff_split(smoke, repeats: int, parent: Path | None) -> dict:
    import ctypes
    import subprocess
    import torch
    build, device = smoke._build, torch.device("cuda")
    src = (build.CSRC_DIR / "coeff_pairs.cu").read_text()
    sources = {}
    for form, edits in COEFF_FORMS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{form}: the source lacks {old!r}")
            text = text.replace(old, new)
        sources[form] = text
    if parent is not None:
        sources["parent"] = (parent / "mba_tpu_torch" / "csrc"
                             / "coeff_pairs.cu").read_text()
    procs = {}
    for form, text in sources.items():
        tree = build.BUILD_DIR / f"probe_coeff_{form}"
        tree.mkdir(parents=True, exist_ok=True)
        (tree / "coeff_pairs.cu").write_text(text)
        procs[form] = (tree / "libcoeff.so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(tree / "libcoeff.so"),
             str(tree / "coeff_pairs.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns, ptxas = {}, {}
    for form, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {form}:\n{text[-4000:]}")
        ptxas[form] = _rt_ptxas(text)
        fn = ctypes.CDLL(str(lib)).mba_coeff_pairs_rt
        fn.argtypes = list(build._SIGNATURES["mba_coeff_pairs_rt"])
        fn.restype = ctypes.c_int
        fns[form] = fn
    cohort = smoke.make_cohort(1, smoke.SECONDS, smoke.N_EEG, smoke.N_EMG)
    (e, m, w), _ = smoke.coeff_chunks(cohort, device, 9)
    wc, K, nF, nE = e.shape
    nM = m.shape[-1]
    P2 = K * (K - 1) // 2
    outs = [torch.empty(s, device=device) for s in
            ((nF, nE * nM), (P2, nF, nE * nM), (P2, nF, nE * nM),
             (wc * nF * (nE + nM),))]

    def call(fn):
        code = fn(torch.view_as_real(e).data_ptr(),
                  torch.view_as_real(m).data_ptr(), w.data_ptr(),
                  *(x.data_ptr() for x in outs), wc, K, nF, nE, nM, 0,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"mba_coeff_pairs_rt: error {code}")
    ms = {form: [smoke.cuda_ms(lambda: call(fn), 5) for _ in range(repeats)]
          for form, fn in fns.items()}
    # the forms that compute the sums: bit for bit the first's?
    same, ref = {}, None
    for form in ("as_is", "warps12", "warps8", "parent"):
        if form in fns:
            call(fns[form])
            got = [x.clone() for x in outs[:3]]
            if ref is None:
                ref = got
            else:
                same[form] = all(torch.equal(x, y) for x, y in zip(got, ref))
    return {"probe": "coeff-split", "shape": [wc, K, nF, nE, nM], "ms": ms,
            "ptxas": ptxas, "sums_equal_to_as_is": same}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("probe", choices=("reml-profile", "fft-null",
                                          "null-tile-split",
                                          "mesh-reference",
                                          "coeff-dispatch", "coeff-split"))
    parser.add_argument("--tree", type=Path,
                        default=Path(__file__).resolve().parent)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--parent", type=Path,
                        help="coeff-dispatch: the tree whose compile-time "
                             "B3 instances are timed; coeff-split: a tree "
                             "whose runtime-K B3 is timed beside")
    args = parser.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    smoke = importlib.import_module("chip_smoke")
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA card", file=sys.stderr)
        return 1
    card = smoke.card_name_and_power()
    if args.probe == "reml-profile":
        out = reml_profile(smoke)
    elif args.probe == "fft-null":
        out = fft_null(smoke, args.repeats)
    elif args.probe == "null-tile-split":
        out = null_tile_split(smoke, min(args.repeats, 3))
    elif args.probe == "mesh-reference":
        out = mesh_reference(smoke)
    elif args.probe == "coeff-dispatch":
        out = coeff_dispatch(smoke, args.parent.resolve(),
                             min(args.repeats, 3))
    else:
        out = coeff_split(smoke, min(args.repeats, 3),
                          args.parent.resolve() if args.parent else None)
    print(json.dumps({"card": card, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
