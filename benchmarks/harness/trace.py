"""The device trace of a traced run (``--trace 1``).

``torch.profiler`` (CPU and CUDA activities) records the measured
window; the harness marks it and its own regions with
``record_function`` (``bench.window``; per call ``bench.handoff``,
``bench.call``, ``bench.result``).  From the exported trace:

- ``busy_s``: the union of the device's kernel, memcpy and memset
  intervals inside the window; ``window_s``: the window's length on the
  same clock; ``idle_share`` = 1 − busy_s / window_s;
- ``device_ops``: the 10 device operations (kernels by name, copies by
  kind) that took most time;
- ``idle_gaps``: idle device time summed by what the host's thread was
  doing meanwhile (the harness region and the innermost host operation,
  or ``python`` between operations), the 10 largest;
- ``calls``: for each ``bench.call`` region in order, its kernels' and
  memsets' device intervals [start, end] in seconds from the region's
  start (the harness reads its clock first thing in the region, so a
  call's host times line up with them to microseconds).
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COMPUTE_CATS = ("kernel", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "bench.window"
REGIONS = ("bench.handoff", "bench.call", "bench.result")
TOP = 10
NAME_CHARS = 160     # a kernel's name is cut to this many characters


class DeviceTrace:
    """Context manager: profiles its body when ``enabled``."""

    def __init__(self, enabled: bool, cuda: bool):
        self.prof = None
        if enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict | None:
        if self.prof is None:
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return summarize(events)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list[dict]) -> dict | None:
    """Busy time, window, top device operations and named idle gaps from
    a Chrome trace's events (times in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in spans if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        return None
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev, ops = [], defaultdict(float)
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b))
                ops[e["name"][:NAME_CHARS]] += (b - a) * 1e-6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    out = {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
           "device_ops": sorted(([k, v] for k, v in ops.items()),
                                key=lambda kv: -kv[1])[:TOP]}
    out["idle_share"] = (1.0 - busy_s / out["window_s"]) if busy else None
    out["idle_gaps"] = (_named_gaps(spans, busy, w0, w1,
                                    window[0].get("tid")) if busy else [])
    out["calls"] = _call_kernels(spans, w0, w1, window[0].get("tid"))
    return out


def _call_kernels(spans, w0, w1, tid) -> list:
    """Per ``bench.call`` region of the window, in order: the union of
    its kernel and memset intervals, in seconds from the region's
    start."""
    regions = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in spans if e.get("name") == "bench.call"
                     and e.get("cat") == "user_annotation"
                     and e.get("tid") == tid and w0 <= float(e["ts"]) <= w1)
    work = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in spans if e.get("cat") in COMPUTE_CATS)
    out, k = [], 0
    for r0, r1 in regions:
        while k < len(work) and work[k][1] <= r0:
            k += 1
        inside, j = [], k
        while j < len(work) and work[j][0] < r1:
            a, b = max(work[j][0], r0), min(work[j][1], r1)
            if b > a:
                inside.append(((a - r0) * 1e-6, (b - r0) * 1e-6))
            j += 1
        out.append([list(iv) for iv in _union(inside)])
    return out


def _host_segments(host) -> list:
    """Nested host spans (start, end, name), sorted by start and then by
    end descending, → contiguous segments (start, end, name) named by the
    harness region around them and the innermost span, or ``python``
    where no span but a region is open."""
    segs, stack, t = [], [], None

    def close_to(to):
        nonlocal t
        while stack and stack[-1][0] <= to:
            end, _ = stack[-1]
            if end > t:
                segs.append((t, end, _label(stack)))
                t = end
            stack.pop()
        if to > t:
            segs.append((t, to, _label(stack)))
            t = to

    for a, b, name in host:
        if t is None:
            t = a
        close_to(a)
        stack.append((b, name))
    if stack:
        close_to(max(end for end, _ in stack))
    return segs


def _label(stack) -> str:
    region = next((n for _, n in stack if n in REGIONS), "bench.loop")
    inner = stack[-1][1] if stack and stack[-1][1] not in REGIONS \
        else "python"
    return f"{region} > {inner}"


def _named_gaps(spans, busy, w0, w1, tid) -> list:
    """Idle device time inside [w0, w1] summed by what the host's thread
    ``tid`` was doing meanwhile."""
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in spans
                   if e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e["name"] != WINDOW),
                  key=lambda h: (h[0], -h[1]))
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    named = defaultdict(float)
    segs = _host_segments(host)
    k = 0
    for g0, g1 in gaps:
        while k < len(segs) and segs[k][1] <= g0:
            k += 1
        j, covered = k, 0.0
        while j < len(segs) and segs[j][0] < g1:
            overlap = min(g1, segs[j][1]) - max(g0, segs[j][0])
            if overlap > 0:
                named[segs[j][2]] += overlap * 1e-6
                covered += overlap
            j += 1
        if g1 - g0 > covered:
            named["bench.loop > python"] += (g1 - g0 - covered) * 1e-6
    return sorted(([k, v] for k, v in named.items()),
                  key=lambda kv: -kv[1])[:TOP]
