"""The harness finds every cell, configuration, entry and metric by name,
BENCHMARK.json keeps to the benchmark's contract, and a cell, a
configuration and a metric are added as files alone."""
import hashlib
import json
import re
import shutil
import time

import pytest

from benchmarks.harness.catalog import BENCH_DIR, ROOT, Catalog
from benchmarks.harness.runner import run_cell
from benchmarks.tests.tiny import tiny

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmarks"]
    assert SPEC["command"][1] == "benchmarks/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert sum(c["chips"] == 4 for c in SPEC["workloads"]) <= 1


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (Catalog().reader(m["name"]).read) is not None
    if m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        e2e = {e["name"]: e for e in SPEC["end_to_end"]}
        assert m["moves"] in e2e
        cells = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(cells)
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    cat = Catalog()
    spec = cat.cell(cell)
    assert NAME.match(cell) and spec["chips"] == 1
    assert cell == f"{spec['config']}.{spec['traffic']}"
    traffic = cat.traffic(cell)
    assert traffic["config"] == spec["config"]
    assert hasattr(cat.entry(traffic["entry"]), "Entry")
    assert cat.config(spec["config"])["name"] == spec["config"]
    e2e = [m["name"] for m in cat.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cat.per_layer(cell)


@pytest.mark.parametrize("cfg", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_config_file(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert all(k in data for k in cfg["reduced"])
    assert any(c["config"] == cfg["name"] for c in SPEC["workloads"])


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_cell_config_and_metric_added_as_files(tmp_path):
    bench = tmp_path / "benchmarks"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec_path = tmp_path / "BENCHMARK.json"
    shutil.copy(ROOT / "BENCHMARK.json", spec_path)
    before = _digests(bench)

    cfg = json.loads((bench / "configs" / "subject64.json").read_text())
    cfg.update(name="subject32", eeg_channels=32)
    (bench / "configs" / "subject32.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "workloads" / "subject64.cmc_120s.json")
                         .read_text())
    traffic["config"] = "subject32"
    (bench / "workloads" / "subject32.cmc_60s.json").write_text(
        json.dumps(traffic))
    (bench / "metrics" / "cmc.calls.py").write_text(
        "def read(run):\n    return len(run['calls'])\n")
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "subject32", "source": "s",
                            "file": "benchmarks/configs/subject32.json",
                            "reduced": [], "why": "w"})
    spec["workloads"].append({"name": "subject32.cmc_60s",
                              "config": "subject32", "traffic": "cmc_60s",
                              "chips": 1, "why": "w"})
    for m in spec["end_to_end"]:
        if m["name"] == "cmc_spectra_per_s":
            m["workloads"].append("subject32.cmc_60s")
    spec["per_layer"].append({"name": "cmc.calls", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry points",
                              "moves": "cmc_spectra_per_s",
                              "workloads": ["subject32.cmc_60s"]})
    spec_path.write_text(json.dumps(spec))

    after = _digests(bench)
    assert {k: after[k] for k in before} == before     # nothing edited
    cat = Catalog(spec_path, bench)
    over = tiny(Catalog(), "subject64.cmc_120s")
    for trace, want in ((False, "cmc_spectra_per_s"), (True, "cmc.calls")):
        res = run_cell("subject32.cmc_60s", 7, 0.3, trace, "cpu",
                       time.perf_counter(), cat, overrides=over)
        assert res["correct"], res["checks"]
        assert want in res["metrics"]
