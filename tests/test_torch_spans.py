"""The spans and counters of ``utils.profiling`` inside the port's
recorded entry points, ``ops.coherence.multitaper_msc``,
``ops.cohort_null.cohort_msc_rotation_null`` and
``ops.surrogate.msc_phase_randomized_null``, on the CPU at small sizes:
the recorder itself, the span trees, the counters against the shapes
and padding that decide them, the ``*_sec`` timings as sums of their
spans, the ranges a ``torch.profiler`` trace holds, and the synchronises
and ranges a call makes with recording on and off; the phase null's
results bit for bit with its spans made no-ops, on a gloo mesh too."""
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
from mba_tpu_torch.ops import surrogate as TS
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


PHASE_FS = 128.0
PHASE_KW = dict(window_length_sec=1.0, n_surrogates=40, surrogate_chunk=16,
                seed=3, device="cpu")
PHASE_CHUNKS = 3             # 40 surrogates in chunks of 16
PHASE_WIDTH = 6              # surrogates a batch: 6 + 6 + 4 a chunk


def _phase(monkeypatch=None, **kw):
    """The phase null on 2 × 3 channels of 8 s; with ``monkeypatch``,
    batches of PHASE_WIDTH surrogates."""
    if monkeypatch is not None:
        monkeypatch.setattr(TS, "_auto_vmap_width",
                            lambda *a, **k: PHASE_WIDTH)
    rng = np.random.default_rng(5)
    n = int(8 * PHASE_FS)
    drive = rng.standard_normal((n, 1))
    eeg = rng.standard_normal((n, 2)) + 0.5 * drive
    emg = rng.standard_normal((n, 3)) + 0.5 * drive
    return TS.msc_phase_randomized_null(
        eeg.astype(np.float32), emg.astype(np.float32), PHASE_FS,
        **{**PHASE_KW, **kw})


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


@pytest.mark.parametrize("transfer_dtype", [None, np.int16])
@pytest.mark.parametrize("rotation_mode", ["shared", "per_window"])
def test_null_span_tree(rotation_mode, transfer_dtype):
    res = _null(rotation_mode=rotation_mode, transfer_dtype=transfer_dtype)
    t = res["metadata"]["timings"]
    recs = t["spans"]
    _assert_tree(recs, "null")
    n = NULL_J
    assert _names(recs, 0) == (["null.plan", "null.upload"]
                               + ["null.coeffs"] * n
                               + ["null.epilogue", "null.surrogates"])
    # one upload and one pass a subject in either mode; subject j + 1's
    # upload nested in subject j's pass, which it runs under
    assert _names(recs).count("null.upload") == n
    passes = [i for i, r in enumerate(recs) if r[0] == "null.coeffs"]
    assert [_names(recs, i) for i in passes] == \
        [["null.upload"]] * (n - 1) + [[]]
    # the host's conversion of each of the subject's two arrays inside
    # its upload
    uploads = [i for i, r in enumerate(recs) if r[0] == "null.upload"]
    quantized = ["null.quantize"] * 2 if transfer_dtype else []
    assert [_names(recs, i) for i in uploads] == [quantized] * n
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


@pytest.mark.parametrize("rotation_mode", ["shared", "per_window"])
@pytest.mark.parametrize("transfer_dtype", [None, np.int16])
def test_upload_bytes_counter(rotation_mode, transfer_dtype):
    eeg, emg = _cohort()
    t = _null(rotation_mode=rotation_mode,
              transfer_dtype=transfer_dtype)["metadata"]["timings"]
    size = 4 if transfer_dtype is None else 2
    assert t["upload_bytes"] == (eeg.size + emg.size) * size


@pytest.mark.cuda
@pytest.mark.parametrize("transfer_dtype", [None, np.int16])
@pytest.mark.parametrize("rotation_mode", ["shared", "per_window"])
def test_upload_counters_on_the_card(rotation_mode, transfer_dtype):
    """Each subject's arrays at 2048 Hz × 64 channels × 80 s (42 MB in
    float32, 21 MB quantized to int16: over the staging threshold either
    way) all go through the staging ring: the staged bytes are the
    uploaded bytes and the ``upload_bytes`` key.  Twenty windows a
    subject keep the per-window coefficients small."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: nothing is staged on the CPU")
    rng = np.random.default_rng(4)
    n = 80 * 2048
    eeg, emg = (rng.standard_normal((NULL_J, n, 64), dtype=np.float32)
                for _ in range(2))
    size = np.dtype(transfer_dtype or np.float32).itemsize
    assert eeg[0].size * size >= TD.STAGE_MIN_BYTES
    starts = np.tile(np.arange(20)[None] * 8192, (NULL_J, 1))
    t = TN.cohort_msc_rotation_null(
        eeg, emg, 2048.0, rotation_mode=rotation_mode,
        transfer_dtype=transfer_dtype, window_starts=starts,
        **{**NULL_KW, "device": "cuda"})["metadata"]["timings"]
    c = t["counters"]
    assert c["upload.staged_bytes"] == c["upload.bytes"] == \
        t["upload_bytes"] == (eeg.size + emg.size) * size
    assert _names(t["spans"]).count("null.upload") == NULL_J


# ---- the legacy timings as sums of spans -------------------------------

def _span_sum(records, *names, parent=None):
    return sum(r[3] - r[2] for r in records if r[0] in names
               and (parent is None or r[1] == parent))


@pytest.mark.parametrize("kw", [
    dict(), dict(rotation_mode="per_window"), dict(transfer_dtype=np.int16),
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
@pytest.mark.parametrize("rotation_mode", ["shared", "per_window"])
def test_null_synchronises_and_ranges(monkeypatch, profiler, rotation_mode):
    """One synchronise, after the last pass, in either mode (the copy's
    events and the stream close each subject)."""
    counts = _Counts(monkeypatch)
    with _profiled(profiler):
        res = _null(rotation_mode=rotation_mode)
    assert counts.sync == 1 and counts.cuda_sync == 0
    n_spans = len(res["metadata"]["timings"]["spans"])
    assert counts.ranges == (n_spans if profiler else 0)


# ---- the phase null ----------------------------------------------------

@pytest.mark.parametrize("max_stat_only", [False, True])
def test_phase_null_span_tree_and_counters(monkeypatch, max_stat_only):
    t = _phase(monkeypatch, max_stat_only=max_stat_only)["timings"]
    recs = t["spans"]
    _assert_tree(recs, "phase_null")
    assert _names(recs, 0) == ["phase_null.upload", "phase_null.observed",
                               "phase_null.surrogates",
                               "phase_null.epilogue"]
    surr = _names(recs).index("phase_null.surrogates")
    assert _names(recs, surr) == ["phase_null.chunk"] * PHASE_CHUNKS
    chunks = [i for i, r in enumerate(recs) if r[0] == "phase_null.chunk"]
    assert [_names(recs, i) for i in chunks] == [
        ["phase_null.draw"] + ["phase_null.batch"] * 3
        + ["phase_null.hist"]] * PHASE_CHUNKS
    # every surrogate drawn, the last chunk's 8 of surplus included
    assert t["counters"] == {"phase_null.surrogates_drawn": 48,
                             "phase_null.batches": 3 * PHASE_CHUNKS}


def test_phase_null_timings_are_sums_of_spans():
    t = _phase()["timings"]
    recs = t["spans"]
    for key, name in (("upload_sec", "phase_null.upload"),
                      ("observed_sec", "phase_null.observed"),
                      ("null_sec", "phase_null.surrogates")):
        assert t[key] == _span_sum(recs, name) > 0.0, key
        assert t[key] != round(t[key], 3), key
    assert t["upload_bytes"] == int(8 * PHASE_FS) * 5 * 4
    # one batch a chunk at the budget's width
    assert t["counters"]["phase_null.batches"] == PHASE_CHUNKS
    json.dumps(t)                                  # the result line's form


def _assert_results_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "timings":
            continue
        if k == "null_quantiles":
            assert set(a[k]) == set(b[k])
            for q in a[k]:
                np.testing.assert_array_equal(a[k][q], b[k][q], err_msg=k)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("profiler", [False, True])
@pytest.mark.parametrize("max_stat_only", [False, True])
def test_phase_null_results_with_and_without_spans(monkeypatch, profiler,
                                                   max_stat_only):
    """Every result bit for bit with the spans and counters made no-ops,
    under the profiler too; one synchronise (the upload's) either way,
    and a range a span only while the profiler runs."""
    syncs = []
    monkeypatch.setattr(TS, "synchronize", lambda d: syncs.append(d))
    with _profiled(profiler):
        on = _phase(monkeypatch, max_stat_only=max_stat_only)
    monkeypatch.setattr(TS, "span", lambda name: TP._NO_SPAN)
    monkeypatch.setattr(TS, "count", lambda *a, **k: None)
    off = _phase(monkeypatch, max_stat_only=max_stat_only)
    assert len(syncs) == 2
    _assert_results_equal(on, off)
    assert off["timings"]["spans"] == [] and off["timings"]["counters"] == {}


def test_phase_null_results_with_and_without_spans_on_a_mesh(tmp_path):
    """Two gloo ranks: rank r's chunk from split(sub, 2)[r], the
    histogram increments summed; the results bit for bit with the spans
    made no-ops, and each rank's counters its own draws."""
    import _torch_mesh as M
    ranks = M.run_ranks(M.phase_null_spans_on_and_off, 2, tmp_path)
    for r in ranks:
        _assert_results_equal(r["on"], r["off"])
        _assert_results_equal(r["on"], ranks[0]["on"])
        t = r["on"]["timings"]
        _assert_tree(t["spans"], "phase_null")
        n_rounds = -(-M.PHASE_KW["n_surrogates"] // (2 * 8))
        assert _names(t["spans"]).count("phase_null.chunk") == n_rounds
        assert t["counters"]["phase_null.surrogates_drawn"] == 8 * n_rounds
        assert r["off"]["timings"]["spans"] == []
