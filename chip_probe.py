#!/usr/bin/env python3
"""One-off measurements on an NVIDIA card, outside ``chip_smoke.py``'s
permanent run.

    python3 chip_probe.py reml-profile
    python3 chip_probe.py fft-null [--tree DIR] [--repeats N]

``reml-profile``: one ``lme._REML_BLOCK``-response block of the power
grid's RQ-A Level-1 design (``chip_smoke.make_statistics_frame``) under
``torch.profiler``, after a warm block: the block's wall, the card's
kernel time and the number of kernels, so the share of the wall the card
is busy says whether launches bound the grid.

``fft-null``: ``chip_smoke.run_fft_null`` of the ``chip_smoke.py`` in
DIR (this checkout by default), after building that tree's kernels, N
times in one process on one cohort; the first call is cold, as in
``chip_smoke.py``'s run.  Run it on two trees in turns to compare them.

Each prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("probe", choices=("reml-profile", "fft-null"))
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
    out = (reml_profile(smoke) if args.probe == "reml-profile"
           else fft_null(smoke, args.repeats))
    print(json.dumps({"card": card, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
