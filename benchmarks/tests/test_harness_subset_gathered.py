"""The reader of the task-wise CMC's counters ``upload.gathered_bytes``
and ``upload.subset_bytes``: the gathered share over the window's calls
on synthetic runs, nothing read where a call lacks the counters (a
program that copies the subset on the host first, as before the staging
ring gathered it; a failed call) or selected nothing, and nothing in a
traced run of the tiny task-CMC cell on the CPU, where the program
counts the subset but gathers nothing."""
import time

import pytest

from benchmarks.harness.catalog import Catalog
from benchmarks.harness.runner import run_cell
from benchmarks.tests.tiny import tiny

CAT = Catalog()
CELL = "subject64_session.task_cmc"
METRIC = "task_cmc.subset_gathered_share"


def _read(run):
    return CAT.reader(METRIC).read(run)


def _call(counters):
    spans = {} if counters is None else {
        "spans": [["task_cmc", -1, 0.0, 0.5]],
        "counters": {"cmc.download_copies": 90, **counters}}
    return {"wall_s": 0.5, "returned_s": 0.5, "spans": spans}


def _bytes(gathered, subset):
    return {"upload.gathered_bytes": gathered, "upload.subset_bytes": subset}


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
    [{"upload.subset_bytes": 100}],               # neither, or one
    [_bytes(100, 100), None],                     # a call without counters
    [_bytes(100, 100), {}],
    [_bytes(0, 0)],                               # nothing selected
])
def test_nothing_read_without_the_counters(calls):
    assert _read({"calls": [_call(c) for c in calls], "trace": None}) \
        is None


def test_listed_in_the_task_cmc_cell_only():
    assert METRIC in {m["name"] for m in CAT.per_layer(CELL)}
    for cell in ("subject64.cmc_120s", "cohort12.null_default",
                 "cohort12.null_coeff_b3"):
        assert METRIC not in {m["name"] for m in CAT.per_layer(cell)}
    spec = next(m for m in CAT.per_layer(CELL) if m["name"] == METRIC)
    assert (spec["layer"], spec["moves"], spec["unit"], spec["source"]) == \
        ("transfers", "cmc_spectra_per_s", "%", "program_counter")


def test_nothing_read_in_a_traced_run_of_the_tiny_cell_on_the_cpu():
    res = run_cell(CELL, 2**31 + 11, 0.3, True, "cpu", time.perf_counter(),
                   CAT, overrides=tiny(CAT, CELL))
    assert res["correct"], res["checks"]
    assert "task_cmc.subset_s" in res["metrics"]
    assert METRIC not in res["metrics"]
