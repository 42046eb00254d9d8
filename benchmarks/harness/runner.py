"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's inputs from the seed and makes one warm call at
the cell's own shapes, so that every kernel is built and every plan made
before the window.  The window is a closed loop with one caller: calls
run back to back, on the cell's inputs in turn, and a call is started
while the window's ``seconds`` have not run out, so the window ends with
the last call and holds all its work.  A reservoir sample drawn from the
seed keeps ``calls_per_input`` results of each input; once the window has
closed, the peak memory read and the program's state freed, the
reference checks each kept result, and each number compared is held to
its limit in the cell's traffic file.
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import random
import sys
import time
import traceback

import torch

from benchmarks.harness.catalog import Catalog
from benchmarks.harness.trace import DeviceTrace


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


class Reservoir:
    """A uniform sample of ``k`` calls of each input, drawn from the
    seed, over however many calls the window completes."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.seen: dict[int, int] = {}
        self.kept: dict[int, list] = {}

    def offer(self, r: int, i: int, make) -> None:
        n = self.seen[r] = self.seen.get(r, 0) + 1
        slots = self.kept.setdefault(r, [])
        if n <= self.k:
            slots.append((i, make()))
        else:
            j = self.rng.randrange(n)
            if j < self.k:
                slots[j] = (i, make())

    def items(self):
        return [item for r in sorted(self.kept) for item in self.kept[r]]


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def _worst(values: list[float]) -> float:
    """The largest; NaN where any is NaN."""
    return float("nan") if any(math.isnan(v) for v in values) \
        else max(values)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, catalog: Catalog | None = None,
             overrides: dict | None = None, log=sys.stderr) -> dict:
    """The result of one run (the keys of the result line; ``checks``
    last).  ``overrides``: {"config": {...}, "traffic": {...}} merged
    into the cell's files (the tests' small sizes)."""
    catalog = catalog or Catalog()
    cell = catalog.cell(name)
    traffic = merged(catalog.traffic(name), (overrides or {}).get("traffic"))
    config = merged(catalog.config(cell["config"]),
                    (overrides or {}).get("config"))
    cuda = torch.device(device).type == "cuda"
    quiet = open(os.devnull, "w")
    try:
        torch.zeros(1, device=device)
        print(f"setup: card ready at {time.perf_counter() - t_start:.3f} s",
              file=log)
        entry = catalog.entry(traffic["entry"]).Entry(config, traffic, seed,
                                                      device)
        print(f"setup: inputs made at {time.perf_counter() - t_start:.3f} s",
              file=log)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(quiet):
            entry.call(0, trace)
        _sync(cuda)
        setup_s = time.perf_counter() - t_start
        print(f"setup: warm call done at {setup_s:.3f} s", file=log)
        reservoir = Reservoir(traffic["check"]["calls_per_input"], seed)
        calls, failed, n_inputs = [], 0, len(entry.inputs)
        tracer = DeviceTrace(trace, cuda)
        with tracer, contextlib.redirect_stdout(quiet), \
                torch.profiler.record_function("bench.window"):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            i = 0
            while i == 0 or time.perf_counter() < deadline:
                with torch.profiler.record_function("bench.handoff"):
                    res, spans = None, {}
                with torch.profiler.record_function("bench.call"):
                    c0 = time.perf_counter()
                    try:
                        res, spans = entry.call(i, trace)
                    except Exception:           # counted, and reported
                        failed += 1
                        traceback.print_exc(file=log)
                    r1 = time.perf_counter()
                    _sync(cuda)
                    c1 = time.perf_counter()
                with torch.profiler.record_function("bench.result"):
                    if res is not None:
                        reservoir.offer(i % n_inputs, i,
                                        lambda r=res: entry.keep(r))
                    calls.append({"input": i % n_inputs, "wall_s": c1 - c0,
                                  "returned_s": r1 - c0,
                                  "spans": dict(spans)})
                    del res
                i += 1
            window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        walls = [c["wall_s"] for c in calls]
        half = len(walls) // 2
        print(f"calls: {len(walls)} in {window_s:.3f} s; wall s min "
              f"{min(walls):.4f} max {max(walls):.4f}; mean of the first "
              f"half {sum(walls[:half]) / max(half, 1):.4f}, of the second "
              f"{sum(walls[half:]) / (len(walls) - half):.4f}", file=log)
        summary = tracer.summary()
        del tracer
    finally:
        quiet.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers: dict[str, list[float]] = {}
    for i, kept in reservoir.items():
        for k, v in entry.check(i, kept).items():
            numbers.setdefault(k, []).append(float(v))
    limits = traffic["check"]["limits"]
    checks = {k: {"value": _worst(numbers[k]) if k in numbers
                  else float("nan"), "limit": float(limits[k])}
              for k in limits}
    correct = (failed == 0 and bool(numbers)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    run = {"calls": calls, "window_s": window_s, "setup_s": setup_s,
           "units": entry.units(), "work": entry.work(), "trace": summary}
    specs = catalog.per_layer(name) if trace else catalog.end_to_end(name)
    metrics = {}
    for m in specs:
        value = catalog.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result
