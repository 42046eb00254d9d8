"""Readings for the limits of a cell's check, on the card.

    python3 benchmarks/tools/calibrate.py --workload <cell> \
        --seeds 11 12 ... [--control-seeds 3] [--timed-calls 4]

For each seed, in one process: the cell's inputs from the seed, a warm
call, then the calls that a run checks (one on each input) held to the
reference (``program``), and on the first ``--control-seeds`` seeds the
cell's control held to the same reference (``control``: the reference
in the precision below the configuration's, or the program's own
lower-precision path).  On those seeds the reads that the cell's entry
lists in ``READS`` of ``tests/entries/<entry>.py`` are made too, for the
record (the null's program at ``compute_dtype=bfloat16``,
``program_bf16``).
``--also ARGS`` (JSON keyword arguments, repeatable) reads the program
with those arguments too (``program_also``), against the same reference:
one reference per call serves every cell that shares the configuration
and the inputs, such as the two null cells.  Prints one JSON line per
reading, with the reference's seconds, and the seconds of
``--timed-calls`` calls.
"""
import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from benchmarks.harness.catalog import Catalog  # noqa: E402
from benchmarks.harness.runner import merged  # noqa: E402
from benchmarks.tests import tiny  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--timed-calls", type=int, default=4)
    ap.add_argument("--also", type=json.loads, action="append", default=[],
                    help="JSON keyword arguments of a further program read")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", type=json.loads, default={},
                    help="JSON {config: {...}, traffic: {...}} (rehearsal)")
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cat = Catalog()
    traffic = merged(cat.traffic(args.workload),
                     args.overrides.get("traffic"))
    config = merged(cat.config(cat.cell(args.workload)["config"]),
                    args.overrides.get("config"))
    Entry = cat.entry(traffic["entry"]).Entry
    asked = list(tiny.reads(cat, traffic["entry"]).items())
    quiet = open(os.devnull, "w")

    def emit(**kw):
        print(json.dumps({"workload": args.workload, **kw}),
              file=sys.__stdout__, flush=True)

    for n, seed in enumerate(args.seeds):
        entry = Entry(config, traffic, seed, args.device)
        with contextlib.redirect_stdout(quiet):
            entry.call(0, False)
            if n == 0:
                walls = []
                for i in range(args.timed_calls):
                    t0 = time.perf_counter()
                    entry.call(i, False)
                    if cuda:
                        torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                emit(seed=seed, kind="walls", walls=walls)
            for i in range(len(entry.inputs)):
                reads = [("program", {})] + [("program_also", a)
                                             for a in args.also]
                if n < args.control_seeds:
                    reads += asked
                kepts = [(kind, a, entry.keep(entry.call(i, False, **a)[0]))
                         for kind, a in reads]
                t0 = time.perf_counter()
                ref = entry.reference(i) if hasattr(entry, "reference") \
                    else None
                ref_s = time.perf_counter() - t0

                def check(kept, i=i, ref=ref):
                    return entry.check(i, kept) if ref is None \
                        else entry.check(i, kept, ref)
                for kind, a, kept in kepts:
                    extra = {"ref_s": ref_s}
                    if "p_fwe" in kept:
                        extra["margin"] = float(kept["observed"].max()
                                                - kept["max_stat"].max())
                    if a:
                        extra["args"] = {k: str(v) for k, v in a.items()}
                    t0 = time.perf_counter()
                    nums = check(kept)
                    emit(seed=seed, call=i, kind=kind, **nums, **extra,
                         check_s=time.perf_counter() - t0)
                del kepts, ref
                if n < args.control_seeds:
                    t0 = time.perf_counter()
                    emit(seed=seed, call=i, kind="control",
                         **entry.check(i, entry.control(i)),
                         control_s=time.perf_counter() - t0)
        del entry
        if cuda:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
