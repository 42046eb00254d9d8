"""What the tests run each cell at on the CPU, and how they break it,
in files found by name alone under the catalog's directory (so that a
catalog in a copy finds its own):

- a configuration's small sizes, ``tests/configs/<config>.json``,
  merged into ``configs/<config>.json``;
- an entry's, ``tests/entries/<entry>.py``: ``SIZES``, merged into the
  traffic of each cell on it; ``FAULTS``, its broken timed paths
  {name: (module, attribute, wrap)}; and optionally ``READS``, further
  reads of the program for ``tools/calibrate.py``.

So a new cell on a configuration and an entry that the benchmark has
brings no file here. ``run.py`` reads none of them.
"""
import json

from benchmarks.harness.catalog import _load_module


def config_file(catalog, config: str):
    return catalog.dir / "tests" / "configs" / f"{config}.json"


def entry_file(catalog, entry: str):
    return catalog.dir / "tests" / "entries" / f"{entry}.py"


def _entry(catalog, entry: str):
    return _load_module(entry_file(catalog, entry), "benchmarks_tests_")


def tiny(catalog, cell: str) -> dict:
    """The overrides that run ``cell`` small; FileNotFoundError, naming
    the file, where its configuration or entry has none."""
    traffic = catalog.traffic(cell)
    return {"config": json.loads(config_file(catalog, traffic["config"])
                                 .read_text()),
            "traffic": _entry(catalog, traffic["entry"]).SIZES}


def faults(catalog, entry: str) -> dict:
    """The broken timed paths of ``entry``; FileNotFoundError, naming
    the file, where it has none."""
    return _entry(catalog, entry).FAULTS


def reads(catalog, entry: str) -> dict:
    """Further reads of the program that ``entry`` asks calibration
    for: {kind: keyword arguments}."""
    return getattr(_entry(catalog, entry), "READS", {})
