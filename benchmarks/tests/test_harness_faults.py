"""The check fails what it must: each cell's control, and a run whose
timed path is broken underneath (every other step of a run as the
benchmark makes it, on the CPU at small sizes)."""
import time

import pytest
import torch

from benchmarks.harness.catalog import Catalog
from benchmarks.harness.runner import merged, run_cell
from benchmarks.tests.tiny import tiny

CELLS = [c["name"] for c in Catalog().spec["workloads"]]


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


def _altered_msc(orig):
    def fn(*a, **k):
        out = orig(*a, **k)
        out["coherence"][0, 3, 0] += 1e-3
        return out
    return fn


def _half_tapers(orig):
    def fn(eeg_fft, emg_fft, *a, **k):
        h = eeg_fft.shape[1] // 2 + 1
        return orig(eeg_fft[:, :h].contiguous(), emg_fft[:, :h].contiguous(),
                    *a, **k)
    return fn


def _altered_null(orig):
    def fn(*a, **k):
        ms, counts = orig(*a, **k)
        ms[0] += 1e-3
        return ms, counts
    return fn


def _half_subjects(orig):
    def fn(bases, coefs):
        h = len(bases) // 2
        base, _, observed = orig(bases[:h], coefs[:h])
        return base, orig(bases, coefs)[1], observed
    return fn


FAULTS = {
    # an answer altered where it is produced
    "cmc_answer": ("mba_tpu_torch.ops.cuda_msc", "msc_jackknife_plain",
                   _altered_msc),
    # half of the batch (the tapers) left out, the mean over the rest
    "cmc_half": ("mba_tpu_torch.ops.cuda_msc", "msc_jackknife_plain",
                 _half_tapers),
    "null_answer": ("mba_tpu_torch.ops.cuda_null", "null_tile_plain",
                    _altered_null),
    # half of the batch (the subjects) left out of the cohort mean
    "null_half": ("mba_tpu_torch.ops.cohort_null", "cohort_epilogue",
                  _half_subjects),
}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f.startswith("null") == ("null" in c)]


@pytest.mark.parametrize("cell, fault", CASES)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib
    mod_name, attr, wrap = FAULTS[fault]
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
    # the null's second engine against the same reference, as both null
    # cells' limits were read
    also = ["--also", '{"coeff_engine": "pallas"}'] if "null" in cell else []
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
    for r in rows:
        over = [k for k in limits if k in r and not r[k] <= limits[k]]
        assert (not over) if r["kind"] in ("program", "program_also") else \
            (over or r["kind"] == "walls"), r
