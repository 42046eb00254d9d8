#!/usr/bin/env python3
"""One-off measurements on an NVIDIA card, outside ``chip_smoke.py``'s
permanent run.

    python3 chip_probe.py reml-profile
    python3 chip_probe.py fft-null [--tree DIR] [--repeats N]
    python3 chip_probe.py null-tile-split [--repeats N]

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

Each prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("probe", choices=("reml-profile", "fft-null",
                                          "null-tile-split"))
    parser.add_argument("--tree", type=Path,
                        default=Path(__file__).resolve().parent)
    parser.add_argument("--repeats", type=int, default=10)
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
    else:
        out = null_tile_split(smoke, min(args.repeats, 3))
    print(json.dumps({"card": card, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
