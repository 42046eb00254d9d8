"""The work counts give PERF.md's bounds at the main path's shapes (NVIDIA
H100 float32 peak 67 TFLOP/s, 3.35 TB/s)."""
import pytest

from benchmarks.work import msc_epilogue, null_surrogate
from benchmarks.work.peaks import least_seconds


@pytest.mark.parametrize("work, ms, by", [
    # B2: one 500-surrogate chunk, 175 band bins, J·P = 12·20, 64×64
    (null_surrogate.chunk_work(500, 175, 240, 4096), 2.568, "operations"),
    # the whole surrogate pass: 20 such chunks
    (null_surrogate.pass_work(10_000, 500, 175, 240, 4096), 51.35,
     "operations"),
    # B1's EMG-max epilogue: a 17-window chunk, K = 5, 2049 bins, 64×64
    (msc_epilogue.epilogue_work(17, 5, 2049, 64, 64), 0.1767, "operations"),
])
def test_bound_at_main_path_shapes(work, ms, by):
    t, bound_by = least_seconds(*work)
    assert t * 1e3 == pytest.approx(ms, rel=2e-3)
    assert bound_by == by


def test_step_adds_the_spectra_to_the_epilogue():
    W, K, S, E, M, n = 119, 5, 4096, 64, 64, 245_760
    step = msc_epilogue.step_work(W, K, S, E, M, n)
    epi = msc_epilogue.epilogue_work(W, K, S // 2 + 1, E, M)
    assert epi[0] < step[0] < 1.2 * epi[0]
    # the signal read once and the three (W, F, E) results written once
    assert step[1] == 4 * n * (E + M) + 12 * W * (S // 2 + 1) * E


def test_pass_counts_whole_chunks():
    one = null_surrogate.chunk_work(100, 3, 20, 12)
    assert null_surrogate.pass_work(250, 100, 3, 20, 12) == (
        3 * one[0], 3 * one[1])
