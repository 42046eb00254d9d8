"""Benchmark of mba_tpu_torch on NVIDIA cards: one run of one cell.

    python3 benchmarks/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, as ``BENCHMARK.json`` lists them), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the check
compared with its limit, which also end standard error.  Exits non-zero
and prints no result without enough cards, or where the process holds
JAX or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mba_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``mba_tpu_torch`` is not ``mba_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmarks.harness.catalog import Catalog
    from benchmarks.harness.runner import run_cell

    catalog = Catalog()
    chips = catalog.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START, catalog)
    found = forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark measures "
              "mba_tpu_torch alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
        if not math.isfinite(c["value"]):   # JSON has no NaN
            c["value"] = None
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
