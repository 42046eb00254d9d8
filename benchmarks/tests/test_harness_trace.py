"""The traced run's readings: each call's kernels from the trace, the
device time of a call or of a span of it, the rooflines over that time,
and the study's task windows."""
import numpy as np
import pytest

from benchmarks.entries.rotation_null import task_windows
from benchmarks.harness.catalog import Catalog
from benchmarks.harness.trace import summarize
from benchmarks.metrics._spans import device_seconds, roofline_share
from benchmarks.reference.null import disjoint


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def _trace():
    """A window of two calls (µs): the first with kernels at 100-300 and
    250-400 (overlapping) and a copy at 500-900; the second with a kernel
    that runs past its region's end."""
    return [
        _ev("bench.window", "user_annotation", 0, 10_000),
        _ev("bench.call", "user_annotation", 0, 1_000),
        _ev("k1", "kernel", 100, 200, tid=7),
        _ev("k2", "kernel", 250, 150, tid=8),
        _ev("Memcpy HtoD", "gpu_memcpy", 500, 400, tid=7),
        _ev("bench.call", "user_annotation", 2_000, 1_000),
        _ev("set", "gpu_memset", 2_100, 100, tid=7),
        _ev("k3", "kernel", 2_800, 500, tid=7),
    ]


def test_calls_hold_their_kernels_and_memsets():
    calls = summarize(_trace())["calls"]
    want = [[[100e-6, 400e-6]], [[100e-6, 200e-6], [800e-6, 1000e-6]]]
    assert len(calls) == 2
    for got, exp in zip(calls, want):
        assert np.allclose(got, exp, rtol=0, atol=1e-12)


def test_device_seconds_of_a_call_and_of_a_span():
    run = {"calls": [{"wall_s": 1e-3, "returned_s": 1e-3,
                      "spans": {"s": 0.0002}},
                     {"wall_s": 1e-3, "returned_s": 1e-3,
                      "spans": {"s": 0.0003}}],
           "trace": summarize(_trace()), "work": {"step": (0.0, 335.0)}}
    assert device_seconds(run) == pytest.approx((300e-6 + 300e-6) / 2)
    # the span is [returned − seconds − half a millisecond, returned]:
    # [300, 1000] µs holds 100 µs of the first call's kernels, [200,
    # 1000] µs 200 µs of the second's
    assert device_seconds(run, "s") == pytest.approx((100e-6 + 200e-6) / 2)
    run["calls"][0]["returned_s"] = 0.9e-3          # [200, 900] µs: 200
    assert device_seconds(run, "s") == pytest.approx((200e-6 + 200e-6) / 2)
    # 335 bytes at 3.35e12 B/s take 1e-10 s
    assert roofline_share(run, "step", "s") == pytest.approx(
        100 * 1e-10 / 200e-6)
    run["calls"][1]["spans"] = {}                   # a call without it
    assert device_seconds(run, "s") is None


def test_no_trace_or_no_kernels_reads_nothing():
    run = {"calls": [{"wall_s": 1.0, "returned_s": 1.0, "spans": {}}],
           "trace": None, "work": {"step": (1.0, 1.0)}}
    assert roofline_share(run, "step") is None
    run["trace"] = {"calls": [[]]}
    assert roofline_share(run, "step") is None
    run["trace"] = {"calls": [[[0.0, 1.0]], [[0.0, 1.0]]]}   # miscounted
    assert device_seconds(run) is None


def test_task_windows_at_study_scale():
    cfg = Catalog().config("cohort12")
    rec = {"sampling_hz": cfg["sampling_hz"], "trials": cfg["trials"]}
    ws = int(cfg["window_sec"] * cfg["sampling_hz"])
    starts = task_windows(rec, ws, ws // 2)
    assert len(starts) == 30 * 44
    hop = int((cfg["trials"]["seconds"] + cfg["trials"]["silence_seconds"])
              * cfg["sampling_hz"])
    assert starts[44] == hop and starts[43] + ws <= 45 * 2048
    assert disjoint(starts, ws).sum() == 30 * 22
    assert np.all(np.diff(starts) > 0)
