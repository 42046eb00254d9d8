"""The spans and counters of ``utils.profiling`` inside the port's two
recorded entry points, ``ops.coherence.multitaper_msc`` and
``ops.cohort_null.cohort_msc_rotation_null``, on the CPU at small sizes:
the recorder itself, the span trees, the counters against the shapes
and padding that decide them, the ``*_sec`` timings as sums of their
spans, the ranges a ``torch.profiler`` trace holds, and the synchronises
and ranges a call makes with recording on and off."""
import contextlib
import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mba_tpu_torch import _device as TD
from mba_tpu_torch.ops import coherence as TC
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.ops.gram_coeffs import GRAM_CHUNK
from mba_tpu_torch.utils import profiling as TP

torch.set_num_threads(1)

# ---- small inputs ------------------------------------------------------

CMC_FS = 256.0
CMC_KW = dict(window_length_sec=1.0, window_chunk=4, device="cpu")
CMC_WINDOWS = 15             # 8 s at 256 Hz, 1-s windows at the half hop

NULL_FS = 128.0
NULL_J = 2
NULL_KW = dict(window_length_sec=0.5, band=(13.0, 40.0), n_surrogates=40,
               surrogate_chunk=16, window_chunk=8, device="cpu")
NULL_CHUNKS = 3              # 40 surrogates in chunks of 16


def _cmc_inputs(seed=0):
    rng = np.random.default_rng(seed)
    n = int(8 * CMC_FS)
    drive = rng.standard_normal(n)
    eeg = rng.standard_normal((n, 3)) + 0.5 * drive[:, None]
    emg = rng.standard_normal((n, 2)) + 0.5 * drive[:, None]
    return eeg.astype(np.float32), emg.astype(np.float32)


def _cohort(n_sec=12.0, seed=1):
    rng = np.random.default_rng(seed)
    n = int(n_sec * NULL_FS)
    drive = rng.standard_normal((NULL_J, n, 1))
    eeg = rng.standard_normal((NULL_J, n, 2)) + 0.5 * drive
    emg = rng.standard_normal((NULL_J, n, 2)) + 0.5 * drive
    return eeg.astype(np.float32), emg.astype(np.float32)


def _null(**kw):
    eeg, emg = _cohort()
    return TN.cohort_msc_rotation_null(eeg, emg, NULL_FS,
                                       **{**NULL_KW, **kw})


def _cmc(**kw):
    eeg, emg = _cmc_inputs()
    return TC.multitaper_msc(eeg, emg, CMC_FS, **{**CMC_KW, **kw})


# ---- the tree of records -----------------------------------------------

def _names(records, parent=None):
    return [r[0] for r in records if parent is None or r[1] == parent]


def _assert_tree(records, root):
    """One root at index 0; every record closed and inside its parent's
    interval; parents open before their children."""
    assert records[0][:3] == [root, -1, 0.0]
    assert [r[1] for r in records].count(-1) == 1
    for i, (name, parent, start, end) in enumerate(records):
        assert isinstance(name, str) and end is not None and start <= end
        if parent >= 0:
            assert parent < i
            p_start, p_end = records[parent][2:]
            assert p_start <= start and end <= p_end, (name, records[parent])


def test_recorder_nests_spans_and_sums_counters():
    with TP.recording() as rec, TP.span("root"):
        with TP.span("a"):
            with TP.span("a.inner"):
                TP.count("n", 2)
        with TP.span("a"):
            TP.count("n", 3)
        TP.count("m")
    assert _names(rec.records) == ["root", "a", "a.inner", "a"]
    assert [r[1] for r in rec.records] == [-1, 0, 1, 0]
    _assert_tree(rec.records, "root")
    assert rec.counters == {"n": 5, "m": 1}
    a = [r[3] - r[2] for r in rec.records if r[0] == "a"]
    assert rec.seconds("a") == pytest.approx(sum(a))
    assert rec.seconds("missing") == 0.0
    assert rec.end("a") == rec.records[3][3]       # the last one named
    assert rec.timings() == {"spans": rec.records,
                             "counters": rec.counters}


def test_no_recorder_costs_a_lookup_and_nothing_else():
    assert TP.span("x") is TP.span("y")           # one shared no-op
    with TP.span("x"):
        TP.count("x", 4)
    with TP.recording(False) as rec:
        assert rec is None
        assert TP.span("x") is TP.span("y")


def test_recording_off_hides_an_outer_recorder_and_restores_it():
    with TP.recording() as outer, TP.span("outer"):
        with TP.recording(False):
            with TP.span("hidden"):
                TP.count("hidden")
        with TP.recording() as inner, TP.span("inner"):
            TP.count("inner")
        TP.count("outer")
    assert _names(outer.records) == ["outer"]
    assert outer.counters == {"outer": 1}
    assert _names(inner.records) == ["inner"]
    assert inner.counters == {"inner": 1}


def test_a_raising_block_closes_its_spans_and_the_recorder():
    with pytest.raises(RuntimeError):
        with TP.recording() as rec, TP.span("root"):
            with TP.span("fails"):
                raise RuntimeError("boom")
    assert all(r[3] is not None for r in rec.records)
    assert TP._RECORDER.get() is None


@pytest.mark.parametrize("mask,chunks,threshold,runs", [
    (None, 4, False, 1),                   # 15 windows in chunks of 4
    ("half", 2, True, 8),                  # 8 active windows, threshold
])
def test_cmc_span_tree(mask, chunks, threshold, runs):
    window_mask = None
    if mask == "half":
        window_mask = np.arange(CMC_WINDOWS) % 2 == 0
    res = _cmc(collect_timings=True, window_mask=window_mask,
               apply_independence_threshold=threshold)
    recs = res["timings"]["spans"]
    _assert_tree(recs, "cmc")
    assert _names(recs, 0) == ["cmc.plan", "cmc.upload", "cmc.compute",
                               "cmc.download", "cmc.scatter"] \
        + (["cmc.threshold"] if threshold else [])
    compute = _names(recs).index("cmc.compute")
    assert _names(recs, compute) == ["cmc.chunk"] * chunks
    n_active = res["metadata"]["n_active_windows"]
    # one copy a result (coherence and the two CI bounds) and run
    assert res["timings"]["counters"] == {"cmc.download_copies": 3 * runs}
    assert chunks == math.ceil(n_active / CMC_KW["window_chunk"])


def test_cmc_with_no_active_window_records_no_pass():
    res = _cmc(collect_timings=True,
               window_mask=np.zeros(CMC_WINDOWS, bool))
    t = res["timings"]
    assert _names(t["spans"], 0) == ["cmc.plan", "cmc.upload",
                                     "cmc.scatter", "cmc.threshold"]
    assert t["counters"] == {}
    assert t["compute_sec"] == t["download_sec"] == 0.0
    assert t["download_bytes"] == 0


@pytest.mark.parametrize("overlap_upload", [True, False])
@pytest.mark.parametrize("rotation_mode", ["shared", "per_window"])
def test_null_span_tree(overlap_upload, rotation_mode):
    res = _null(overlap_upload=overlap_upload, rotation_mode=rotation_mode)
    t = res["metadata"]["timings"]
    recs = t["spans"]
    _assert_tree(recs, "null")
    # the per-window mode uploads the whole cohort first, as before
    per_subject = overlap_upload and rotation_mode == "shared"
    n = NULL_J if per_subject else 1
    assert _names(recs, 0) == (["null.plan", "null.upload"]
                               + ["null.coeffs"] * n
                               + ["null.epilogue", "null.surrogates"])
    # one upload and one pass a subject; subject j + 1's upload nested in
    # subject j's pass, which it runs under
    assert _names(recs).count("null.upload") == n
    passes = [i for i, r in enumerate(recs) if r[0] == "null.coeffs"]
    assert [_names(recs, i) for i in passes] == \
        [["null.upload"]] * (n - 1) + [[]]
    surr = _names(recs).index("null.surrogates")
    assert _names(recs, surr) == ["null.chunk"] * NULL_CHUNKS
    assert res["metadata"]["n_surrogates_drawn"] == NULL_CHUNKS * 16
    assert set(t["counters"]) == {"coeffs.windows_framed",
                                  "coeffs.windows_weighted"}


def test_null_precompute_only_stops_after_the_epilogue():
    t = _null(precompute_only=True)["metadata"]["timings"]
    _assert_tree(t["spans"], "null")
    assert _names(t["spans"], 0) == ["null.plan", "null.upload"] \
        + ["null.coeffs"] * NULL_J + ["null.epilogue"]
    assert _names(t["spans"]).count("null.upload") == NULL_J
    assert "null.chunk" not in _names(t["spans"])


# ---- the counters ------------------------------------------------------

# 520 windows at a quarter-window hop (16 samples of 64), every eighth
# of weight 0 (455 of weight 1).  The greedy disjoint subset skips the
# first and keeps every fourth start from the second: 130 a subject.
# Gram frames them in chunks of GRAM_CHUNK (512 → 1024 with padding),
# the chunked pass in chunks of 32 (→ 544)
COUNT_WINDOWS = 520
COUNT_HOP = 16


@pytest.mark.parametrize("engine,framed", [
    ("gram", 2 * GRAM_CHUNK), ("pallas", 544), ("xla", 544)])
@pytest.mark.parametrize("p_value_windows,weighted", [
    ("disjoint", 130), ("all", 455)])
def test_window_counters(engine, framed, p_value_windows, weighted):
    ws = int(NULL_KW["window_length_sec"] * NULL_FS)
    starts = np.tile(np.arange(COUNT_WINDOWS)[None] * COUNT_HOP,
                     (NULL_J, 1))
    weights = np.ones(starts.shape, np.float32)
    weights[:, ::8] = 0.0
    n_sec = (starts.max() + ws) / NULL_FS
    eeg, emg = _cohort(n_sec=n_sec)
    res = TN.cohort_msc_rotation_null(
        eeg, emg, NULL_FS, coeff_engine=engine, window_starts=starts,
        window_weights=weights, p_value_windows=p_value_windows,
        **{**NULL_KW, "window_chunk": 32, "n_surrogates": 16})
    c = res["metadata"]["timings"]["counters"]
    if p_value_windows == "disjoint":
        keep = TN.disjoint_window_weights(starts, weights, ws)
        assert int(np.count_nonzero(keep[0])) == weighted
    assert c["coeffs.windows_framed"] == NULL_J * framed
    assert c["coeffs.windows_weighted"] == NULL_J * weighted


@pytest.mark.parametrize("overlap_upload", [True, False])
@pytest.mark.parametrize("transfer_dtype", [None, np.int16])
def test_upload_bytes_counter(overlap_upload, transfer_dtype):
    eeg, emg = _cohort()
    t = _null(overlap_upload=overlap_upload,
              transfer_dtype=transfer_dtype)["metadata"]["timings"]
    size = 4 if transfer_dtype is None else 2
    assert t["upload_bytes"] == (eeg.size + emg.size) * size


@pytest.mark.cuda
@pytest.mark.parametrize("overlap_upload", [True, False])
def test_upload_counters_on_the_card(overlap_upload):
    """Each subject's arrays at 2048 Hz × 64 channels × 40 s (21 MB,
    over the staging threshold) all go through the staging ring: the
    staged bytes are the uploaded bytes and the ``upload_bytes`` key."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: nothing is staged on the CPU")
    rng = np.random.default_rng(4)
    eeg, emg = (rng.standard_normal((NULL_J, 40 * 2048, 64),
                                    dtype=np.float32) for _ in range(2))
    assert eeg[0].nbytes >= TD.STAGE_MIN_BYTES
    t = TN.cohort_msc_rotation_null(
        eeg, emg, 2048.0, overlap_upload=overlap_upload,
        **{**NULL_KW, "device": "cuda"})["metadata"]["timings"]
    c = t["counters"]
    assert c["upload.staged_bytes"] == c["upload.bytes"] == \
        t["upload_bytes"] == eeg.nbytes + emg.nbytes
    assert _names(t["spans"]).count("null.upload") == \
        (NULL_J if overlap_upload else 1)


# ---- the legacy timings as sums of spans -------------------------------

def _span_sum(records, *names, parent=None):
    return sum(r[3] - r[2] for r in records if r[0] in names
               and (parent is None or r[1] == parent))


@pytest.mark.parametrize("kw", [
    dict(), dict(overlap_upload=False), dict(transfer_dtype=np.int16),
    dict(precompute_only=True)])
def test_null_timings_are_sums_of_spans(kw):
    t = _null(**kw)["metadata"]["timings"]
    recs = t["spans"]
    assert t["upload_sec"] == _span_sum(recs, "null.upload")
    assert t["quantize_sec"] == _span_sum(recs, "null.quantize")
    assert t["coeffs_sec"] == _span_sum(recs, "null.coeffs", "null.gather")
    # from the end of the plan (the window set's upload follows it) to
    # the end of the epilogue, the gaps between the spans included
    plan, epilogue = (next(r for r in recs if r[0] == name)
                      for name in ("null.plan", "null.epilogue"))
    assert t["precompute_sec"] == epilogue[3] - plan[3]
    # (an upload nested in a pass counted once)
    assert t["precompute_sec"] >= _span_sum(
        recs, "null.upload", "null.coeffs", "null.gather", "null.epilogue",
        parent=0)
    if "transfer_dtype" in kw:
        assert _names(recs).count("null.quantize") == 2 * NULL_J
        assert 0.0 < t["quantize_sec"] < t["upload_sec"]
    if kw.get("precompute_only"):
        assert "null_sec" not in t
    else:
        assert t["null_sec"] == _span_sum(recs, "null.surrogates") > 0.0
    for key in ("upload_sec", "coeffs_sec", "precompute_sec"):
        assert t[key] > 0.0 and t[key] != round(t[key], 3), key


def test_cmc_timings_are_sums_of_spans():
    t = _cmc(collect_timings=True)["timings"]
    recs = t["spans"]
    for key, name in (("upload_sec", "cmc.upload"),
                      ("compute_sec", "cmc.compute"),
                      ("download_sec", "cmc.download")):
        assert t[key] == _span_sum(recs, name) > 0.0, key
    eeg, emg = _cmc_inputs()
    assert t["upload_bytes"] == eeg.nbytes + emg.nbytes
    json.dumps(t)                                  # the result line's form


# ---- the profiler's trace ----------------------------------------------

def _annotations(path):
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _inside(events, child, parent):
    parents = [e for e in events if e["name"] == parent]
    kids = [e for e in events if e["name"] == child]
    assert parents and kids, (child, parent)
    for k in kids:
        assert any(p["ts"] <= k["ts"] and k["ts"] + k["dur"]
                   <= p["ts"] + p["dur"] for p in parents), child
    return kids


@pytest.mark.parametrize("entry", ["cmc", "null"])
def test_profiler_trace_names_the_spans(entry, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if entry == "cmc":
            _cmc(collect_timings=True)
        else:
            _null()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = _annotations(path)
    if entry == "cmc":
        _inside(events, "cmc.scatter", "cmc")
        assert len(_inside(events, "cmc.chunk", "cmc.compute")) == 4
    else:
        assert len(_inside(events, "null.chunk", "null.surrogates")) \
            == NULL_CHUNKS
        assert len(_inside(events, "null.upload", "null")) == NULL_J


# ---- what recording costs the card: no synchronise, no range -----------

class _Counts:
    """Counts the entry points' synchronises (``_device.synchronize`` as
    each module holds it, and ``torch.cuda.synchronize``) and the ranges
    entered (``torch.profiler.record_function``)."""

    def __init__(self, monkeypatch):
        self.sync = self.cuda_sync = self.ranges = 0
        for module in (TC, TN):
            monkeypatch.setattr(module, "synchronize", self._sync)
        real_cuda_sync = torch.cuda.synchronize
        real_range = torch.profiler.record_function

        def cuda_sync(*a, **k):
            self.cuda_sync += 1
            return real_cuda_sync(*a, **k)

        def record_function(*a, **k):
            self.ranges += 1
            return real_range(*a, **k)

        monkeypatch.setattr(torch.cuda, "synchronize", cuda_sync)
        monkeypatch.setattr(torch.profiler, "record_function",
                            record_function)

    def _sync(self, device):
        self.sync += 1


def _profiled(on):
    return profile(activities=[ProfilerActivity.CPU]) if on \
        else contextlib.nullcontext()


@pytest.mark.parametrize("profiler", [False, True])
@pytest.mark.parametrize("collect_timings,syncs", [(False, 0), (True, 2)])
def test_cmc_synchronises_and_ranges(monkeypatch, profiler,
                                     collect_timings, syncs):
    """As before recording: no synchronise without ``collect_timings``,
    the upload's and the compute's with it; ranges only while both the
    profiler and ``collect_timings`` are on."""
    counts = _Counts(monkeypatch)
    with _profiled(profiler):
        res = _cmc(collect_timings=collect_timings)
    assert counts.sync == syncs and counts.cuda_sync == 0
    assert ("timings" in res) == collect_timings
    n_spans = len(res["timings"]["spans"]) if collect_timings else 0
    assert counts.ranges == (n_spans if profiler else 0)


@pytest.mark.parametrize("profiler", [False, True])
@pytest.mark.parametrize("overlap_upload,syncs", [
    (True, 1),                    # after the last pass (the copy's events
                                  # and the stream close each subject)
    (False, 2)])                  # after the cohort's upload and passes
def test_null_synchronises_and_ranges(monkeypatch, profiler,
                                      overlap_upload, syncs):
    counts = _Counts(monkeypatch)
    with _profiled(profiler):
        res = _null(overlap_upload=overlap_upload)
    assert counts.sync == syncs and counts.cuda_sync == 0
    n_spans = len(res["metadata"]["timings"]["spans"])
    assert counts.ranges == (n_spans if profiler else 0)
