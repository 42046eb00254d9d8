"""The study's task-wise CMC through the port's pipeline entry,
``pipeline.signal_features.compute_task_wise_aggregated_cmc``, fed the
enriched frame of a raw experiment log, on the CPU at a small size:
against the benchmark's plain reference (``benchmarks/reference/
task_cmc.py``: its own task mask, channel subset and float64 jackknife),
the one tree of records a traced call yields, and the recorder's
joining, which leaves ``multitaper_msc`` and the cohort null, called
alone, recording as before.  Imports no JAX."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.entries import task_cmc as entry_mod
from benchmarks.harness.runner import merged
from benchmarks.reference import task_cmc as ref
from mba_tpu_torch.channel_layout import EEG_CHANNEL_IND_DICT
from mba_tpu_torch.ops import coherence as TC
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.pipeline import signal_features as TF
from mba_tpu_torch.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET
from mba_tpu_torch.utils import profiling as TP
from mba_tpu_torch.workflows.subject_feature_extraction_workflow import \
    extract_cmc_features

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
CELL = "subject64_session.task_cmc"

# 64 EEG channels (the subset indexes the montage), 3 a grid, 256 Hz;
# three 12-s trials with 8-s silences: 43 of 51 windows in 3 runs
SMALL = {"sampling_hz": 256,
         "trials": {"count": 3, "seconds": 12.0, "silence_seconds": 8.0}}
GRID = 3


def _config(**over):
    cfg = json.loads((BENCH / "configs" / "subject64_session.json")
                     .read_text())
    return merged(cfg, {**SMALL, **over})


def _traffic():
    traffic = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    return merged(traffic, {"recording": {"arrays": {
        "eeg": 64, "emg_flexor": GRID, "emg_extensor": GRID}}})


@pytest.fixture(scope="module")
def entry():
    return entry_mod.Entry(_config(), _traffic(), 2**31 + 7, "cpu")


def _call(entry, i, eeg=None, subset=CMC_EEG_CHANNEL_SUBSET, **kw):
    """The entry on input i (or on ``eeg`` with input i's EMG), with the
    study's ``subset``."""
    eeg_i, emg, spec = entry.inputs[i]
    m = entry.mask
    return TF.compute_task_wise_aggregated_cmc(
        eeg_i if eeg is None else eeg, emg, 256, spec["muscle"],
        log_frame=entry.log_frames[spec["recording"]],
        eeg_channel_subset=subset, window_size_sec=2.0,
        window_overlap_ratio=0.5, use_jackknife=True,
        pre_trial_computation_buffer_sec=m["pre_buffer_sec"],
        post_trial_computation_buffer_sec=m["post_buffer_sec"],
        task_latency_assumption_sec=m["latency_sec"],
        task_end_cutoff_sec=m["end_cutoff_sec"], device="cpu", **kw)


def _limits():
    traffic = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    return traffic["check"]["limits"]


# ---- the configuration -------------------------------------------------

def test_subset_is_the_studys_by_name_and_by_index():
    sub = _config()["eeg_channel_subset"]
    assert sub["names"] == CMC_EEG_CHANNEL_SUBSET
    assert sub["indices"] == [EEG_CHANNEL_IND_DICT[c]
                              for c in CMC_EEG_CHANNEL_SUBSET]


def test_session_mask_at_full_scale():
    """The whole session: each task spans its 45-s trial (less the
    cut-off), 1697 windows, the tasks' 1465 in 30 runs, the same by the
    reference's rules as by the port's from the log frame."""
    cfg = json.loads((BENCH / "configs" / "subject64_session.json")
                     .read_text())
    rows = entry_mod.raw_log(cfg)
    p = {"fs": cfg["sampling_hz"], "window_sec": 2.0, "overlap": 0.5}
    n = cfg["session_seconds"] * cfg["sampling_hz"]
    spans = ref.task_spans(rows, cfg["task_mask"])
    m = cfg["task_mask"]
    assert len(spans) == 30
    for (a, b), t0 in zip(spans, np.arange(30) * 57.0):
        assert a == t0 + m["latency_sec"] - m["trigger_latency_sec"]
        assert b - a == 45.0 - m["end_cutoff_sec"]
    want = ref.active_windows(n, p, spans, m)
    assert (len(want), int(want.sum()), ref.runs(want)) == (1697, 1465, 30)
    ws, hop = 4096, 2048
    centres = (np.arange(len(want)) * hop + ws / 2) / cfg["sampling_hz"]
    got = TF._build_task_window_mask(
        centres, entry_mod.log_frame(rows), m["pre_buffer_sec"],
        m["post_buffer_sec"], verbose=False,
        task_latency_assumption_sec=m["latency_sec"],
        task_end_cutoff_sec=m["end_cutoff_sec"])
    assert np.array_equal(got, want)


# ---- the port against the reference ------------------------------------

@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_port_against_the_reference(entry, i):
    """Each input (two recordings × flexor, extensor): the active
    windows within the cell's gaps, the masked ones exactly 0, the
    same mask."""
    values, lower, upper, _, _ = _call(entry, i)
    assert values.shape == (51, 257, 11) == lower.shape == upper.shape
    assert int(entry.active.sum()) == 43 and ref.runs(entry.active) == 3
    eeg, emg, _ = entry.inputs[i]
    got = ref.compare({"coherence": values, "lower": lower,
                       "upper": upper}, eeg, emg, entry.subset["indices"],
                      entry.active, entry.params, "cpu")
    limits = _limits()
    assert list(got) == list(limits)
    assert got["masked_nonzero"] == got["mask_mismatch"] == 0
    for k in ("coherence_gap", "ci_gap"):
        assert got[k] <= limits[k] / 10, (k, got[k])
    assert (values[~entry.active] == 0).all()
    assert (lower <= values).all() and (values <= upper).all()


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_the_subset_is_the_parents_bit_for_bit(entry, i):
    """The channels taken on their way to the device give what taking
    them on the host first (``np.take``, then the CMC on the subset, with
    no subset left to take) gave, bit for bit, mask included."""
    eeg, _, _ = entry.inputs[i]
    inds = [EEG_CHANNEL_IND_DICT[c] for c in CMC_EEG_CHANNEL_SUBSET]
    got = _call(entry, i)
    want = _call(entry, i, eeg=np.take(eeg, inds, axis=1), subset=None)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("fault", ["drop", "add"])
def test_reference_counts_a_wrong_mask(entry, fault):
    values, lower, upper, _, _ = _call(entry, 0)
    res = {"coherence": values, "lower": lower, "upper": upper}
    active = entry.active.copy()
    w = np.flatnonzero(active)[3] if fault == "drop" \
        else np.flatnonzero(~active)[3]
    active[w] = not active[w]
    eeg, emg, _ = entry.inputs[0]
    got = ref.compare(res, eeg, emg, entry.subset["indices"], active,
                      entry.params, "cpu")
    assert got["mask_mismatch"] == 1
    assert got["masked_nonzero"] == (1 if fault == "drop" else 0)


def test_workflow_saves_what_the_entry_returns(entry, tmp_path):
    """``extract_cmc_features``, save included, writes the flexor's and
    the extensor's grids that the entry's calls return."""
    eeg, flexor, _ = entry.inputs[0]
    _, extensor, _ = entry.inputs[1]
    m = entry.mask
    extract_cmc_features(tmp_path, eeg, flexor, extensor, 256,
                         entry.log_frames[0], buffer_sec=m["pre_buffer_sec"],
                         device="cpu")
    for i, muscle in ((0, "Flexor"), (1, "Extensor")):
        saved = sorted(tmp_path.glob(f"*{muscle} CMC*Spectrograms*.npy"))
        assert len(saved) == 1, saved
        np.testing.assert_array_equal(np.load(saved[0]), _call(entry, i)[0])


# ---- one tree of records -----------------------------------------------

def _names(records, parent=None):
    return [r[0] for r in records if parent is None or r[1] == parent]


def _span_sum(records, name):
    return sum(r[3] - r[2] for r in records if r[0] == name)


def test_traced_call_is_one_tree(entry):
    timings = {}
    _call(entry, 0, timings_out=timings)
    recs = timings["spans"]
    assert recs[0][:3] == ["task_cmc", -1, 0.0]
    assert [r[1] for r in recs].count(-1) == 1
    assert _names(recs, 0) == ["task_cmc.subset", "task_cmc.mask", "cmc"]
    cmc = _names(recs).index("cmc")
    assert _names(recs, cmc) == ["cmc.plan", "cmc.upload", "cmc.compute",
                                 "cmc.download", "cmc.scatter"]
    for i, (name, parent, start, end) in enumerate(recs):
        assert end is not None and start <= end
        if parent >= 0:
            assert parent < i
            assert recs[parent][2] <= start and end <= recs[parent][3]
    eeg, emg, _ = entry.inputs[0]
    # the subset is counted as asked of the upload; on the CPU nothing
    # is gathered by the staging ring
    assert timings["counters"] == {
        "cmc.download_copies": 3 * ref.runs(entry.active),
        "upload.subset_bytes": eeg.nbytes * 11 // 64}
    for key, name in (("subset_sec", "task_cmc.subset"),
                      ("mask_sec", "task_cmc.mask"),
                      ("upload_sec", "cmc.upload"),
                      ("compute_sec", "cmc.compute"),
                      ("download_sec", "cmc.download")):
        assert timings[key] == _span_sum(recs, name) > 0.0, key
    assert timings["upload_bytes"] == (eeg.nbytes * 11 // 64 + emg.nbytes)
    assert timings["download_bytes"] == 3 * 43 * 257 * 11 * 4
    assert timings["K_tapers"] == 5
    json.dumps(timings)                           # the result line's form


def test_untraced_call_opens_no_span(entry, monkeypatch):
    def no_span(*a, **k):
        raise AssertionError("a span opened in an untraced call")
    monkeypatch.setattr(TP, "_Span", no_span)
    _call(entry, 1)


# ---- the recorder's joining ---------------------------------------------

def test_a_joining_recording_nests_in_the_open_one():
    with TP.recording() as outer, TP.span("outer"):
        with TP.recording(join=True) as joined, TP.span("inner") as inner:
            TP.count("n")
            with TP.span("inner.part"):
                pass
        with TP.recording(False, join=True) as off:
            assert off is None
            with TP.span("hidden"):
                TP.count("hidden")
        with TP.recording() as fresh, TP.span("fresh"):
            TP.count("n")
    assert joined is outer and inner.index == 1
    assert _names(outer.records) == ["outer", "inner", "inner.part"]
    assert [r[1] for r in outer.records] == [-1, 0, 1]
    assert outer.counters == {"n": 1}
    assert _names(fresh.records) == ["fresh"]
    assert TP._RECORDER.get() is None


def test_a_joining_recording_alone_opens_its_own():
    with TP.recording(join=True) as rec, TP.span("root"):
        pass
    assert _names(rec.records) == ["root"] and rec.records[0][1] == -1


def _cmc_alone():
    rng = np.random.default_rng(0)
    eeg = rng.standard_normal((2048, 3)).astype(np.float32)
    emg = rng.standard_normal((2048, 2)).astype(np.float32)
    return TC.multitaper_msc(eeg, emg, 256.0, window_length_sec=1.0,
                             window_chunk=4, collect_timings=True,
                             device="cpu")["timings"]


def _null_alone():
    rng = np.random.default_rng(1)
    eeg = rng.standard_normal((2, 1536, 2)).astype(np.float32)
    emg = rng.standard_normal((2, 1536, 2)).astype(np.float32)
    return TN.cohort_msc_rotation_null(
        eeg, emg, 128.0, window_length_sec=0.5, band=(13.0, 40.0),
        n_surrogates=40, surrogate_chunk=16, window_chunk=8,
        device="cpu")["metadata"]["timings"]


@pytest.mark.parametrize("entry_point", ["cmc", "null"])
def test_entry_points_alone_record_as_before(entry_point):
    """Called alone, each entry point's records form its own tree, root
    at index 0, with the names, parents and keys it had."""
    t = _cmc_alone() if entry_point == "cmc" else _null_alone()
    recs = t["spans"]
    assert recs[0][:3] == [entry_point, -1, 0.0]
    assert [r[1] for r in recs].count(-1) == 1
    if entry_point == "cmc":
        assert _names(recs, 0) == ["cmc.plan", "cmc.upload", "cmc.compute",
                                   "cmc.download", "cmc.scatter",
                                   "cmc.threshold"]
        assert _names(recs, 3) == ["cmc.chunk"] * 4
        assert set(t) == {"upload_sec", "upload_bytes", "compute_sec",
                          "download_sec", "download_bytes", "spans",
                          "counters"}
        assert t["counters"] == {"cmc.download_copies": 3}
    else:
        # subject 1's upload runs under subject 0's pass, nested in it
        assert _names(recs, 0) == ["null.plan", "null.upload"] \
            + ["null.coeffs"] * 2 + ["null.epilogue", "null.surrogates"]
        assert _names(recs).count("null.upload") == 2
        assert {"upload_sec", "coeffs_sec", "null_sec", "spans",
                "counters"} <= set(t)


def test_the_null_inside_a_recording_keeps_its_own_tree():
    """The null does not join: under a caller's recording it records its
    own tree, and the caller's holds only its own span."""
    with TP.recording() as rec, TP.span("caller"):
        t = _null_alone()
    assert _names(rec.records) == ["caller"] and rec.counters == {}
    assert t["spans"][0][:3] == ["null", -1, 0.0]


# ---- on the card --------------------------------------------------------

@pytest.mark.cuda
def test_the_gathered_subset_is_the_parents_on_the_card():
    """At a size whose subset the staging ring gathers on its way to the
    card (2000 s at 256 Hz: 22.5 MB of the 131-MB array), the entry
    gives what the CMC on the host's ``np.take`` gives, bit for bit, and
    counts the subset as gathered whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the staging ring gathers the "
                    "subset on its way to it")
    rng = np.random.default_rng(5)
    n = 2000 * 256
    eeg = rng.standard_normal((n, 64), dtype=np.float32)
    emg = rng.standard_normal((n, 3), dtype=np.float32)
    mask = rng.random((n - 512) // 256 + 1) < 0.8
    inds = [EEG_CHANNEL_IND_DICT[c] for c in CMC_EEG_CHANNEL_SUBSET]
    kw = {"window_mask": mask, "device": "cuda"}
    timings = {}
    got = TF.compute_task_wise_aggregated_cmc(
        eeg, emg, 256, "flexor", eeg_channel_subset=CMC_EEG_CHANNEL_SUBSET,
        timings_out=timings, **kw)
    want = TF.compute_task_wise_aggregated_cmc(
        np.take(eeg, inds, axis=1), emg, 256, "flexor", **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert timings["counters"]["upload.gathered_bytes"] == \
        timings["counters"]["upload.subset_bytes"] == n * 11 * 4
