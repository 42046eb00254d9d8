"""``chip_smoke.py``'s two-rank mesh check holds the card's small calls to
a CPU reference computed in the same spawned ranks.  That reference must
come out the same on every host (ROADMAP C15): MKL, torch's CPU FFT and
BLAS, picks its code path by the host's instruction set, and the AVX-512,
AVX2 and SSE4.2 paths round the FFT differently (the small cohort CMC's
lower CI moved by up to 2.4e-5 between them, against a 5e-5 bound).  The
ranks therefore run with ``chip_smoke.MESH_RANK_ENV`` (MKL's conditional
numerical reproducibility mode) at ``chip_smoke.MESH_CPU_THREADS``
threads.  These tests run the check's CPU half in fresh processes, as the
spawned ranks do, and pin that it no longer depends on the host's
instruction set, that its CMC does not depend on the thread count, and
that a failed check keeps both ranks' arrays.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke

REPO = Path(__file__).resolve().parents[1]

# the small calls on a world-1 gloo CPU mesh, once per thread count
_REFERENCE = """
import os, pickle, sys, tempfile
import torch
import torch.distributed as dist
sys.path.insert(0, {repo!r})
import chip_smoke
from mba_tpu_torch.parallel import make_mesh
work = tempfile.mkdtemp()
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(work, "store"), 1), rank=0, world_size=1)
mesh = make_mesh(device_type="cpu")
out = {{}}
for t in {threads!r}:
    torch.set_num_threads(t)
    out[t] = chip_smoke._small_mesh_results(mesh)
dist.destroy_process_group()
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
"""


def _flat(results) -> dict:
    return {f"{call}/{key}": np.asarray(v)
            for call, d in results.items() for key, v in d.items()
            if isinstance(v, (np.ndarray, float, int, np.generic))}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The check's CPU reference in two fresh processes with the ranks'
    environment: at 1 and MESH_CPU_THREADS threads on the host's own
    instruction set, and at MESH_CPU_THREADS with MKL held to AVX2 (a
    host without AVX-512)."""
    tmp = tmp_path_factory.mktemp("mesh_reference")
    runs = {"host": (chip_smoke.MESH_RANK_ENV,
                     [1, chip_smoke.MESH_CPU_THREADS]),
            "avx2": ({**chip_smoke.MESH_RANK_ENV,
                      "MKL_ENABLE_INSTRUCTIONS": "AVX2"},
                     [chip_smoke.MESH_CPU_THREADS])}
    procs = {}
    for name, (env, threads) in runs.items():
        path = tmp / f"{name}.pkl"
        code = _REFERENCE.format(repo=str(REPO), threads=threads,
                                 path=str(path))
        procs[name] = (path, subprocess.Popen(
            [sys.executable, "-c", code], env={**os.environ, **env},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (path, proc) in procs.items():
        text, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, text[-3000:]
        with open(path, "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_mesh_reference_is_the_same_on_any_instruction_set(references):
    """At MESH_CPU_THREADS threads, bit for bit the same reference with
    MKL's AVX2 path in place of the host's own: every array of the four
    calls."""
    threads = chip_smoke.MESH_CPU_THREADS
    base = _flat(references["host"][threads])
    got = _flat(references["avx2"][threads])
    assert base["cohort_cmc/coherence_ci_lower"].size > 0
    assert set(got) == set(base)
    for key in base:
        np.testing.assert_array_equal(got[key], base[key], err_msg=key)


def test_mesh_reference_cmc_is_the_same_at_any_thread_count(references):
    """The CMC calls (whose lower CI failed the check) give the same bits
    at 1 thread as at MESH_CPU_THREADS.  The phase null's sums do not:
    torch splits them by thread count (a few float32 ulps of max_stat),
    which is why the ranks run at a fixed count."""
    base = _flat(references["host"][chip_smoke.MESH_CPU_THREADS])
    got = _flat(references["host"][1])
    keys = [k for k in base if k.split("/")[0] in ("cohort_cmc",
                                                   "time_sharded_cmc")]
    assert len(keys) >= 6
    for key in keys:
        np.testing.assert_array_equal(got[key], base[key], err_msg=key)


def test_failed_mesh_check_keeps_both_ranks_arrays(references, tmp_path,
                                                   monkeypatch):
    """A card result off the CPU's by 1e-3 in one CI fails the check,
    whose error names an ``.npz`` holding every array of both ranks'
    card and CPU results; equal results pass it."""
    cpu = references["host"][chip_smoke.MESH_CPU_THREADS]
    info = {"threads": chip_smoke.MESH_CPU_THREADS}
    good = [{"card": cpu, "cpu": cpu, "cpu_info": info} for _ in range(2)]
    errs = chip_smoke._require_small_mesh_close(good, "test")
    assert errs["cohort_cmc:coherence_ci_lower"] == 0.0
    card = {call: dict(d) for call, d in cpu.items()}
    lower = card["cohort_cmc"]["coherence_ci_lower"].copy()
    lower[1, 3, 2] += 1e-3
    card["cohort_cmc"]["coherence_ci_lower"] = lower
    bad = [{"card": card, "cpu": cpu, "cpu_info": info},
           {"card": cpu, "cpu": cpu, "cpu_info": info}]
    monkeypatch.setattr(chip_smoke, "REPO", tmp_path)
    with pytest.raises(AssertionError, match="coherence_ci_lower") as exc:
        chip_smoke._require_small_mesh_close(bad, "test")
    path = Path(str(exc.value).rsplit(": ", 1)[1].rstrip(")"))
    assert path.parent.parent == tmp_path / "chip_smoke_out"
    saved = np.load(path)
    flat = _flat(cpu)
    assert set(saved.files) == {f"rank{r}/{side}/{key}" for r in (0, 1)
                                for side in ("card", "cpu") for key in flat}
    np.testing.assert_array_equal(
        saved["rank0/card/cohort_cmc/coherence_ci_lower"], lower)
    np.testing.assert_array_equal(
        saved["rank1/cpu/cohort_cmc/coherence_ci_lower"],
        flat["cohort_cmc/coherence_ci_lower"])
