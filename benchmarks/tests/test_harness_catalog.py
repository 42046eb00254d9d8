"""The harness finds every cell, configuration, entry and metric by name,
BENCHMARK.json keeps to the benchmark's contract, and a cell, a
configuration, an entry and a metric are added as files alone, the
tests' small sizes and broken paths with them."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from xml.etree import ElementTree

import pytest

from benchmarks.harness.catalog import BENCH_DIR, ROOT, Catalog
from benchmarks.harness.runner import run_cell
from benchmarks.tests.tiny import faults, tiny

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


@pytest.mark.parametrize("cell", CELLS)
def test_cell_brings_its_small_sizes(cell):
    over = tiny(Catalog(), cell)
    assert set(over) == {"config", "traffic"}


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def _kept(root, before):
    """The digests now of the files in ``before``."""
    now = _digests(root)
    return {k: now.get(k) for k in before}


def _copy(tmp_path):
    """A copy of the benchmark in ``tmp_path``: its directory and spec."""
    bench = tmp_path / "benchmarks"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return bench, tmp_path / "BENCHMARK.json"


def _add_cell(bench, spec_path, cell, entry, sizes=None, tests=None):
    """The cell ``<config>.<traffic>`` added as files: the traffic of
    ``subject64.cmc_120s`` on ``entry``; where the configuration is new,
    ``subject64`` at 32 EEG channels with ``sizes`` as its small sizes,
    and where the entry is new, a copy of ``multitaper_msc`` with
    ``tests`` as the source of its tests' file (each only where given)."""
    config, traffic_name = cell.split(".")
    spec = json.loads(spec_path.read_text())
    if not (bench / "configs" / f"{config}.json").exists():
        cfg = json.loads((bench / "configs" / "subject64.json").read_text())
        cfg.update(name=config, eeg_channels=32)
        (bench / "configs" / f"{config}.json").write_text(json.dumps(cfg))
        if sizes is not None:
            (bench / "tests" / "configs" / f"{config}.json").write_text(
                json.dumps(sizes))
        spec["configs"].append({"name": config, "source": cfg["source"],
                                "file": f"benchmarks/configs/{config}.json",
                                "reduced": cfg["reduced"], "why": "w"})
    if not (bench / "entries" / f"{entry}.py").exists():
        shutil.copy(bench / "entries" / "multitaper_msc.py",
                    bench / "entries" / f"{entry}.py")
        if tests is not None:
            (bench / "tests" / "entries" / f"{entry}.py").write_text(tests)
    traffic = json.loads((bench / "workloads" / "subject64.cmc_120s.json")
                         .read_text())
    traffic.update(config=config, entry=entry)
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps(traffic))
    spec["workloads"].append({"name": cell, "config": config,
                              "traffic": traffic_name, "chips": 1,
                              "why": "w"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "cmc_spectra_per_s" in (m["name"], m.get("moves")) or \
                m["name"] == "call_p95_s":
            m["workloads"].append(cell)
    spec_path.write_text(json.dumps(spec))


def _pytest_in(root, keyword) -> dict:
    """The benchmark's own tests, run in the copy at ``root`` on the CPU
    on the tests that ``keyword`` selects: {test id: (outcome, message)}."""
    xml = root / "report.xml"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(root), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmarks/tests", "-q", "-k",
         keyword, "-p", "no:cacheprovider", f"--junitxml={xml}"],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    assert xml.is_file(), out.stdout[-3000:] + out.stderr[-3000:]
    results = {}
    for case in ElementTree.parse(xml).iter("testcase"):
        name = f"{case.get('classname').split('.')[-1]}::{case.get('name')}"
        kids = [k for k in case if k.tag in ("failure", "error", "skipped")]
        results[name] = (kids[0].tag, kids[0].get("message", "")) if kids \
            else ("passed", "")
    return results


def test_cell_config_and_metric_added_as_files(tmp_path):
    """A new configuration with its own small sizes, a new entry with its
    own sizes and broken paths, a cell on both, a cell on a configuration
    and an entry that are there (which brings no test file) and a metric:
    added as files, with no file edited, and the per-cell tests take both
    cells as they stand."""
    bench, spec_path = _copy(tmp_path)
    before = _digests(bench)
    cell, plain = "subject32.cmc_60s", "subject64.cmc_60s"
    own = (bench / "tests" / "entries" / "multitaper_msc.py").read_text()
    assert '"eeg": 4, "emg": 3' in own
    _add_cell(bench, spec_path, cell, "cmc_copy",
              {"sampling_hz": 256, "recording_seconds": 10},
              own.replace('"eeg": 4, "emg": 3', '"eeg": 3, "emg": 2'))
    tests_before = set((bench / "tests").rglob("*"))
    _add_cell(bench, spec_path, plain, "multitaper_msc")
    assert set((bench / "tests").rglob("*")) == tests_before
    (bench / "metrics" / "cmc.calls.py").write_text(
        "def read(run):\n    return len(run['calls'])\n")
    spec = json.loads(spec_path.read_text())
    spec["per_layer"].append({"name": "cmc.calls", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry points",
                              "moves": "cmc_spectra_per_s",
                              "workloads": [cell]})
    spec_path.write_text(json.dumps(spec))

    assert _kept(bench, before) == before              # nothing edited
    cat = Catalog(spec_path, bench)
    over = tiny(cat, cell)
    assert over == {"config": {"sampling_hz": 256, "recording_seconds": 10},
                    "traffic": {"recording": {"arrays": {"eeg": 3,
                                                         "emg": 2}}}}
    assert tiny(cat, plain) == tiny(Catalog(), "subject64.cmc_120s")
    for trace, want in ((False, "cmc_spectra_per_s"), (True, "cmc.calls")):
        res = run_cell(cell, 7, 0.3, trace, "cpu", time.perf_counter(), cat,
                       overrides=over)
        assert res["correct"], res["checks"]
        assert want in res["metrics"]

    got = _pytest_in(tmp_path, "subject32 or subject64.cmc_60s or cmc_copy "
                               "or cmc.calls")
    ran = {
        "test_harness_catalog::test_metric_entry[cmc.calls]",
        "test_harness_catalog::test_config_file[subject32]",
        "test_harness_faults::test_entry_brings_its_faults[cmc_copy]",
        "test_harness_imports::test_no_jax_import_in_sources"
        "[entries/cmc_copy.py]",
        "test_harness_imports::test_no_jax_import_in_sources"
        "[metrics/cmc.calls.py]",
    }
    for c in (cell, plain):
        ran |= {
            f"test_harness_catalog::test_cell_found_by_name[{c}]",
            f"test_harness_catalog::test_cell_brings_its_small_sizes[{c}]",
            f"test_harness_reference::test_port_cpu_path_is_correct[{c}]",
            f"test_harness_faults::test_control_fails[{c}]",
            f"test_harness_faults::test_broken_timed_path_is_not_correct"
            f"[{c}-cmc_answer]",
            f"test_harness_faults::test_broken_timed_path_is_not_correct"
            f"[{c}-cmc_half]",
        }
    card = {f"test_harness_faults::test_on_the_card[{c}]": "skipped"
            for c in (cell, plain)}
    assert {k: v[0] for k, v in got.items()} == dict.fromkeys(
        ran, "passed") | card
    assert _kept(bench, before) == before


def test_a_cell_without_its_files_fails_naming_them(tmp_path):
    """A new configuration with no sizes file and a new entry with no
    file of its own: what needs them raises, naming the file; an entry
    whose file lists no fault has falsy faults, which
    test_entry_brings_its_faults fails."""
    bench, spec_path = _copy(tmp_path)
    _add_cell(bench, spec_path, "subject32.bare", "bare_entry")
    _add_cell(bench, spec_path, "subject64.empty", "empty_entry",
              tests='SIZES = {}\nFAULTS = {}\n')
    cat = Catalog(spec_path, bench)
    with pytest.raises(FileNotFoundError, match="tests/configs/subject32.json"):
        tiny(cat, "subject32.bare")
    (bench / "tests" / "configs" / "subject32.json").write_text("{}")
    for look in (lambda: tiny(cat, "subject32.bare"),
                 lambda: faults(cat, "bare_entry")):
        with pytest.raises(FileNotFoundError,
                           match="tests/entries/bare_entry.py"):
            look()
    assert tiny(cat, "subject64.empty") == {"config": tiny(
        Catalog(), "subject64.cmc_120s")["config"], "traffic": {}}
    assert not faults(cat, "empty_entry")
