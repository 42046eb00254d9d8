"""The check fails what it must: each cell's control, and a run whose
timed path is broken underneath (every other step of a run as the
benchmark makes it, on the CPU at small sizes)."""
import time

import pytest
import torch

from benchmarks.harness.catalog import Catalog
from benchmarks.harness.runner import merged, run_cell
from benchmarks.tests.tiny import entry_file, faults, reads, tiny

CAT = Catalog()
CELLS = [c["name"] for c in CAT.spec["workloads"]]
ENTRY = {c: CAT.traffic(c)["entry"] for c in CELLS}


def _entry(cat, cell, seed, device):
    over = tiny(cat, cell)
    traffic = merged(cat.traffic(cell), over["traffic"])
    config = merged(cat.config(traffic["config"]), over["config"])
    return cat.entry(traffic["entry"]).Entry(config, traffic, seed, device), \
        traffic["check"]["limits"]


def control_fails(cell, seed, device) -> list:
    """For each input, the numbers the control fails."""
    cat = Catalog()
    entry, limits = _entry(cat, cell, seed, device)
    failed = []
    for i in range(len(entry.inputs)):
        nums = entry.check(i, entry.control(i))
        failed.append([k for k, v in nums.items() if not v <= limits[k]])
    return failed


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    assert all(control_fails(cell, 2**31 + 17, "cpu"))


@pytest.mark.parametrize("entry", sorted(set(ENTRY.values())))
def test_entry_brings_its_faults(entry):
    assert faults(CAT, entry), f"{entry_file(CAT, entry)} lists no fault"


# a cell whose entry has no file of its own has no case here, and
# test_entry_brings_its_faults fails on that entry
CASES = [(c, f) for c in CELLS if entry_file(CAT, ENTRY[c]).is_file()
         for f in faults(CAT, ENTRY[c])]


@pytest.mark.parametrize("cell, fault", CASES)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib
    mod_name, attr, wrap = faults(CAT, ENTRY[cell])[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    cat = Catalog()
    res = run_cell(cell, 5, 0.3, False, "cpu", time.perf_counter(), cat,
                   overrides=tiny(cat, cell))
    assert not res["correct"], res["checks"]
    assert res["failed"] == 0          # a wrong answer, not a crash


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card(cell, cuda_device):
    """On the card, small: the port is correct, its control is not, and
    the traced run reads the device."""
    cat = Catalog()
    res = run_cell(cell, 11, 1.0, True, cuda_device, time.perf_counter(),
                   cat, overrides=tiny(cat, cell))
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert res["breakdown"]["device_ops"]
    assert all(control_fails(cell, 12, cuda_device))
    torch.cuda.empty_cache()


@pytest.mark.parametrize("cell", ["cohort12.null_default",
                                  "subject64.cmc_120s"])
def test_calibration_tool(cell):
    """tools/calibrate.py reads the program under every limit and the
    control over at least one, as the limits in PERF.md were read."""
    import json
    import subprocess
    import sys
    from benchmarks.harness.catalog import ROOT
    cat = Catalog()
    # the args of each other cell on the same configuration and entry,
    # against the same reference, as both null cells' limits were read
    mine = cat.traffic(cell)
    also = [a for c in CELLS if c != cell
            and (cat.traffic(c)["config"], ENTRY[c]) ==
            (mine["config"], mine["entry"])
            for a in ("--also", json.dumps(cat.traffic(c)["args"]))]
    out = subprocess.run(
        [sys.executable, "benchmarks/tools/calibrate.py", "--workload", cell,
         "--seeds", "3", "4", "--control-seeds", "1", "--timed-calls", "1",
         "--device", "cpu", "--overrides", json.dumps(tiny(cat, cell))]
        + also, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    limits = cat.traffic(cell)["check"]["limits"]
    kinds = {r["kind"] for r in rows}
    assert {"walls", "program", "control"} <= kinds
    assert ("program_also" in kinds) == bool(also)
    assert set(reads(cat, mine["entry"])) <= kinds
    for r in rows:
        over = [k for k in limits if k in r and not r[k] <= limits[k]]
        assert (not over) if r["kind"] in ("program", "program_also") else \
            (over or r["kind"] == "walls"), r
