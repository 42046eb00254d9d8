"""Everything the harness runs, found by name.

``BENCHMARK.json`` lists the cells, configurations and metrics; each
has files of its own, found by its name alone:

- a cell's traffic: ``workloads/<cell>.json`` (its ``entry``,
  parameters, inputs and the limits of its check);
- a configuration: ``configs/<config>.json``;
- an entry point: ``entries/<entry>.py``, a class ``Entry``;
- a metric: ``metrics/<metric>.py``, a function ``read(run)`` that
  returns the metric's value, or None where the run holds nothing to
  read it from.

So a later cell, configuration or metric is added as files and
entries of ``BENCHMARK.json``, with no file here edited.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _load_module(path: Path, prefix: str):
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Catalog:
    def __init__(self, spec_path: Path = ROOT / "BENCHMARK.json",
                 bench_dir: Path = BENCH_DIR):
        self.spec = json.loads(Path(spec_path).read_text())
        self.dir = Path(bench_dir)

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "workloads" / f"{name}.json")
                          .read_text())

    def config(self, name: str) -> dict:
        return json.loads((self.dir / "configs" / f"{name}.json")
                          .read_text())

    def entry(self, name: str):
        return _load_module(self.dir / "entries" / f"{name}.py",
                            "benchmarks_entry_")

    def reader(self, metric: str):
        return _load_module(self.dir / "metrics" / f"{metric}.py",
                            "benchmarks_metric_")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics of ``cell``: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]
