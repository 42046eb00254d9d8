"""Nothing the benchmark runs loads JAX or the JAX package (``mba_tpu``),
compared by whole top-level names since ``mba_tpu_torch`` begins with
``mba_tpu``; the reference loads nothing of ``mba_tpu_torch``."""
import ast
import subprocess
import sys
import tempfile
import textwrap

import pytest

from benchmarks.harness.catalog import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mba_tpu"}
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py")
                 if "tests" not in p.relative_to(BENCH_DIR).parts)


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH_DIR)) for p in SOURCES])
def test_no_jax_import_in_sources(path):
    tops = _imported_tops(path)
    assert not tops & FORBIDDEN
    if "reference" in path.relative_to(BENCH_DIR).parts:
        assert "mba_tpu_torch" not in tops


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin",
                                           "HOME": tempfile.gettempdir(),
                                           "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    """A whole small run of every cell on the CPU, then the run's own
    look at sys.modules."""
    last = _run("""
        import sys, time
        sys.path.insert(0, ".")
        from benchmarks.harness.runner import run_cell
        from benchmarks.run import forbidden_modules
        from benchmarks.harness.catalog import Catalog
        from benchmarks.tests.tiny import tiny
        cat = Catalog()
        for c in cat.spec["workloads"]:
            for trace in (False, True):
                r = run_cell(c["name"], 3, 0.2, trace, "cpu",
                             time.perf_counter(), cat,
                             overrides=tiny(cat, c["name"]))
                assert r["correct"], (c["name"], r["checks"])
        assert "mba_tpu_torch" in sys.modules
        print(forbidden_modules())
    """)
    assert last == "[]"


def test_the_reference_loads_nothing_of_the_program():
    last = _run("""
        import sys
        sys.path.insert(0, ".")
        import benchmarks.reference.cmc, benchmarks.reference.null
        import benchmarks.work.peaks, benchmarks.work.null_surrogate
        import benchmarks.work.msc_epilogue
        print(sorted({m.split(".")[0] for m in sys.modules}
                     & {"mba_tpu_torch", "mba_tpu", "jax", "jaxlib"}))
    """)
    assert last == "[]"


def test_forbidden_names_compare_whole():
    from benchmarks.run import forbidden_modules
    assert "mba_tpu_torch" not in forbidden_modules()
    sys.modules["mba_tpu"] = sys.modules["sys"]
    try:
        assert forbidden_modules() == ["mba_tpu"]
    finally:
        del sys.modules["mba_tpu"]
