"""The reader of the CMC's counter ``cmc.download_copies``: its mean per
call on synthetic runs, nothing read where a call lacks the counter (a
program that does not count it, a failed call), and 3 a call (one run of
windows, three results) in a traced run of the CMC cell, small."""
import time

import pytest

from benchmarks.harness.catalog import Catalog
from benchmarks.harness.runner import run_cell
from benchmarks.tests.tiny import tiny

CAT = Catalog()
CELL = "subject64.cmc_120s"


def _read(run):
    return CAT.reader("cmc.download_copies").read(run)


def _call(counters):
    spans = {} if counters is None else {
        "spans": [["cmc", -1, 0.0, 0.2]], "counters": counters}
    return {"wall_s": 0.2, "returned_s": 0.2, "spans": spans}


def test_mean_per_call():
    run = {"calls": [_call({"cmc.download_copies": 3}),
                     _call({"cmc.download_copies": 3}),
                     _call({"cmc.download_copies": 24})], "trace": None}
    assert _read(run) == pytest.approx(10.0)


@pytest.mark.parametrize("calls", [
    [{}],                                    # a program that counts nothing
    [{"cmc.download_copies": 3}, None],      # a call without counters
    [{"cmc.download_copies": 3}, {}],
])
def test_nothing_read_without_the_counter(calls):
    assert _read({"calls": [_call(c) for c in calls], "trace": None}) \
        is None


def test_listed_in_the_cmc_cell_only():
    assert "cmc.download_copies" in {m["name"]
                                     for m in CAT.per_layer(CELL)}
    for cell in ("cohort12.null_default", "cohort12.null_coeff_b3"):
        assert "cmc.download_copies" not in {m["name"]
                                             for m in CAT.per_layer(cell)}


def test_read_in_a_traced_run_of_the_tiny_cell():
    res = run_cell(CELL, 2**31 + 5, 0.3, True, "cpu", time.perf_counter(),
                   CAT, overrides=tiny(CAT, CELL))
    assert res["correct"], res["checks"]
    assert res["metrics"]["cmc.download_copies"] == {"value": 3.0,
                                                     "unit": "copies"}
