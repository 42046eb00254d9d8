"""The readers of the task-wise CMC's own spans, ``task_cmc.subset_s``
and ``task_cmc.mask_s``: their mean per call on synthetic runs, nothing
read from a program without the spans (an untraced call, a program whose
pipeline entry records only the CMC's tree), and both, with the CMC's
copies counted, in a traced run of the cell, small; and the comparison's
weighing of a cell by its leave-one-out conditioning."""
import time

import pytest
import scipy.stats
import torch

from benchmarks.harness.catalog import Catalog
from benchmarks.harness.runner import run_cell
from benchmarks.reference import task_cmc
from benchmarks.reference.cmc import jackknife
from benchmarks.tests.tiny import tiny

CAT = Catalog()
CELL = "subject64_session.task_cmc"
NEW = ("task_cmc.subset_s", "task_cmc.mask_s")


def _read(metric, run):
    return CAT.reader(metric).read(run)


def _call(subset, mask):
    recs = [["task_cmc", -1, 0.0, 0.5],
            ["task_cmc.subset", 0, 0.0, subset],
            ["task_cmc.mask", 0, subset, subset + mask],
            ["cmc", 0, subset + mask, 0.5]]
    return {"wall_s": 0.5, "returned_s": 0.5,
            "spans": {"spans": recs, "counters": {}}}


def test_mean_per_call():
    run = {"calls": [_call(0.1, 0.02), _call(0.2, 0.04)], "trace": None}
    assert _read("task_cmc.subset_s", run) == pytest.approx(0.15)
    assert _read("task_cmc.mask_s", run) == pytest.approx(0.03)


@pytest.mark.parametrize("spans", [
    {},                                              # an untraced call
    {"spans": [["cmc", -1, 0.0, 0.3], ["cmc.upload", 0, 0.0, 0.1]],
     "counters": {"cmc.download_copies": 90}},       # no task_cmc spans
])
@pytest.mark.parametrize("metric", NEW)
def test_nothing_read_without_the_spans(metric, spans):
    run = {"calls": [_call(0.1, 0.02),
                     {"wall_s": 0.5, "returned_s": 0.5, "spans": spans}],
           "trace": None}
    assert _read(metric, run) is None


def test_listed_on_the_task_cmc_cell():
    assert set(NEW) <= {m["name"] for m in CAT.per_layer(CELL)}


def _entry(over):
    return CAT.entry("task_cmc").Entry(
        {**CAT.config("subject64_session"), **over["config"]},
        {**CAT.traffic(CELL), **over["traffic"]}, 1, "cpu")


def test_each_pass_meets_each_recording_with_a_fresh_log():
    """As in the workflow, which fetches a subject's log once for its two
    grids: in each pass over the inputs, the first call on a recording
    gets a copy of its log frame that the program's span table has not
    seen, the next call on that recording the same copy."""
    from mba_tpu_torch.pipeline import data_integration as DI
    entry = _entry(tiny(CAT, CELL))
    recs = [spec["recording"] for _, _, spec in entry.inputs]
    assert recs == [0, 0, 1, 1]
    frames, hits = [], []
    for i in range(3 * len(recs)):
        frame = entry.frame(i)
        hits.append(id(frame) in DI._SPAN_TABLE_CACHE)
        DI._span_table(frame)                  # as the call's mask does
        frames.append(frame)
        assert frame.equals(entry.log_frames[recs[i % len(recs)]])
    assert hits == [False, True] * (len(hits) // 2)
    assert frames[0] is frames[1] and frames[0] is not frames[4]


def test_read_in_a_traced_run_of_the_tiny_cell():
    over = tiny(CAT, CELL)
    res = run_cell(CELL, 2**31 + 5, 0.3, True, "cpu", time.perf_counter(),
                   CAT, overrides=over)
    assert res["correct"], res["checks"]
    for metric in NEW:
        assert res["metrics"][metric]["value"] > 0.0
    entry = _entry(over)
    assert res["metrics"]["cmc.download_copies"]["value"] == \
        3 * task_cmc.runs(entry.active) == 9


def test_loo_kappa_of_equal_and_of_one_dominant_taper():
    X = torch.ones(1, 5, 2, 1, dtype=torch.complex128)
    X[0, 0, 1, 0] = 1000.0          # at the second frequency, taper 0
    kappa = task_cmc.loo_kappa(X)
    assert kappa[0, 0, 0] == pytest.approx(5 / 4)
    assert kappa[0, 1, 0] == pytest.approx((1e6 + 4) / 4)


def _real_cells(n, seed):
    """(1, K, n, 1) EEG and (1, K, n, 4) EMG spectra, real as at 0 Hz, the
    EMG coupled to the EEG at 0.8, each taper's scale drawn apart (e^±1),
    so that one taper often carries most of a cell's power; rounded to
    float32 as the program's input is."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.exp(torch.randn(1, 5, n, 1, generator=g,
                                  dtype=torch.float64))
    xe = torch.randn(1, 5, n, 1, generator=g, dtype=torch.float64) * scale
    xm = 0.8 * xe.expand(1, 5, n, 4) + 0.6 * scale * torch.randn(
        1, 5, n, 4, generator=g, dtype=torch.float64)
    return [torch.complex(x.float().double(), torch.zeros_like(x))
            for x in (xe, xm)]


def test_float32_rounding_where_a_taper_dominates_is_weighed_out(
        monkeypatch):
    """The reference's own float32 arithmetic, max-pooled, against its
    float64: over cells where a taper dominates, its unweighted gaps pass
    a limit, its weighed gaps lie far inside both, and its results
    rounded to bfloat16 (the cell's control) still fail both."""
    limits = CAT.traffic(CELL)["check"]["limits"]
    Xe, Xm = _real_cells(50_000, 2)
    t_crit = float(scipy.stats.t.ppf(0.975, 4))
    r32 = jackknife(Xe.to(torch.complex64), Xm.to(torch.complex64), t_crit)
    pick = r32["coherence"].argmax(-1, keepdim=True)
    f32 = {k: r32[k].gather(-1, pick)[..., 0].double()
           for k in ("coherence", "lower", "upper")}
    weighed = task_cmc.gaps(Xe, Xm, f32, t_crit)
    bf16 = task_cmc.gaps(Xe, Xm, {k: v.bfloat16().double()
                                  for k, v in f32.items()}, t_crit)
    monkeypatch.setattr(task_cmc, "KAPPA", float("inf"))
    whole = task_cmc.gaps(Xe, Xm, f32, t_crit)
    assert whole["coherence_gap"] > limits["coherence_gap"]
    for k in ("coherence_gap", "ci_gap"):
        assert weighed[k] < limits[k] / 10
        assert bf16[k] > limits[k]
