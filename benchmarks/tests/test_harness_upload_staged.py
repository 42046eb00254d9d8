"""The reader of the null's counters ``upload.staged_bytes`` and
``upload.bytes``: the staged share over the window's calls on synthetic
runs, nothing read where a call lacks the counters (a program that does
not count them, as before the staging ring; a failed call) or uploaded
nothing, and nothing in a traced run of the tiny null cell on the CPU,
where the program stages and counts nothing."""
import time

import pytest

from benchmarks.harness.catalog import Catalog
from benchmarks.harness.runner import run_cell
from benchmarks.tests.tiny import tiny

CAT = Catalog()
CELLS = ("cohort12.null_default", "cohort12.null_coeff_b3")
METRIC = "null.upload_staged_share"


def _read(run):
    return CAT.reader(METRIC).read(run)


def _call(counters):
    spans = {} if counters is None else {
        "spans": [["null", -1, 0.0, 2.0]],
        "counters": {"coeffs.windows_framed": 1536,
                     "coeffs.windows_weighted": 660, **counters}}
    return {"wall_s": 2.0, "returned_s": 2.0, "spans": spans}


def _bytes(staged, total):
    return {"upload.staged_bytes": staged, "upload.bytes": total}


@pytest.mark.parametrize("calls,share", [
    ([_bytes(100, 100), _bytes(300, 300)], 100.0),
    ([_bytes(0, 100), _bytes(300, 300)], 75.0),
    ([_bytes(0, 100)], 0.0),
])
def test_share_over_the_window(calls, share):
    run = {"calls": [_call(c) for c in calls], "trace": None}
    assert _read(run) == pytest.approx(share)


@pytest.mark.parametrize("calls", [
    [{}],                                         # a program that counts
    [{"upload.bytes": 100}],                      # neither, or one
    [_bytes(100, 100), None],                     # a call without counters
    [_bytes(100, 100), {}],
    [_bytes(0, 0)],                               # nothing uploaded
])
def test_nothing_read_without_the_counters(calls):
    assert _read({"calls": [_call(c) for c in calls], "trace": None}) \
        is None


def test_listed_in_the_null_cells_only():
    for cell in CELLS:
        assert METRIC in {m["name"] for m in CAT.per_layer(cell)}
    for cell in ("subject64.cmc_120s", "subject64_session.task_cmc"):
        assert METRIC not in {m["name"] for m in CAT.per_layer(cell)}
    spec = next(m for m in CAT.per_layer(CELLS[0]) if m["name"] == METRIC)
    assert (spec["layer"], spec["moves"], spec["unit"]) == \
        ("transfers", "call_s", "%")


def test_nothing_read_in_a_traced_run_of_the_tiny_cell_on_the_cpu():
    res = run_cell(CELLS[0], 2**31 + 9, 0.3, True, "cpu",
                   time.perf_counter(), CAT, overrides=tiny(CAT, CELLS[0]))
    assert res["correct"], res["checks"]
    assert "null.coeffs_useful_share" in res["metrics"]
    assert METRIC not in res["metrics"]
