"""The pieces the two cells of the phase null and of the 16-bit null
bring: their work counts at the main path's shapes, their readers on
synthetic runs (nothing read from a program that records nothing, as
the parent's phase null), and the reference's rule and control."""
import numpy as np
import pytest
import torch

from benchmarks.harness.catalog import Catalog
from benchmarks.reference import null, null_16bit, phase_null
from benchmarks.work import null_surrogate, null_surrogate_16bit
from benchmarks.work import phase_null as phase_work
from benchmarks.work.peaks import PEAKS, least_seconds

CAT = Catalog()
PHASE = ("phase_null.null_s", "phase_null.observed_s",
         "phase_null.batch_width", "phase_null.roofline")


def _read(metric, run):
    return CAT.reader(metric).read(run)


def test_16bit_pass_at_main_path_shapes():
    """B2's 16-bit instance: one 500-surrogate chunk, 175 band bins,
    J·P = 12·20, 64×64, 0.1739 ms on the tensor cores' 16-bit peak; the
    same operations as the float32 count, half its operand bytes."""
    one = null_surrogate_16bit.chunk_work(500, 175, 240, 4096)
    t, by = least_seconds(*one, PEAKS["bf16_flops"])
    assert t * 1e3 == pytest.approx(0.1739, rel=2e-3) and by == "operations"
    f32 = null_surrogate.chunk_work(500, 175, 240, 4096)
    assert one[0] == f32[0]
    assert one[1] == pytest.approx(
        f32[1] / 2 + 2 * (3 * 175 * 4096 + 500))
    whole = null_surrogate_16bit.pass_work(10_000, 500, 175, 240, 4096)
    assert whole == (20 * one[0], 20 * one[1])


def test_phase_step_counts_whole_chunks_and_ffts():
    one = phase_work.step_work(1, 4096, 512, 15, 5, 1, 1)
    two = phase_work.step_work(2, 4096, 512, 15, 5, 1, 1)
    per_surrogate = two[0] - one[0]
    ffts = phase_work.fft_flops(4096) + 75 * phase_work.fft_flops(512)
    assert ffts < per_surrogate < 1.5 * ffts
    # a surrogate's signal written and read once, its phases read once
    assert two[1] - one[1] == pytest.approx(8 * 4096 + 4 * 2049 + 4)


def _phase_call(drawn=250, batches=3, observed=0.01, surrogates=0.7):
    recs = [["phase_null", -1, 0.0, 1.0],
            ["phase_null.observed", 0, 0.01, 0.01 + observed],
            ["phase_null.surrogates", 0, 0.1, 0.1 + surrogates]]
    return {"wall_s": 1.0, "returned_s": 1.0,
            "spans": {"null_sec": surrogates, "spans": recs,
                      "counters": {"phase_null.surrogates_drawn": drawn,
                                   "phase_null.batches": batches}}}


def test_phase_readers():
    run = {"calls": [_phase_call(), _phase_call(250, 2, 0.03, 0.5)],
           "trace": {"calls": [[[0.0, 0.8]], [[0.1, 0.5]]]},
           "work": {"phase_null": (67e12 * 0.012, 1.0)}}
    assert _read("phase_null.null_s", run) == pytest.approx(0.6)
    assert _read("phase_null.observed_s", run) == pytest.approx(0.02)
    assert _read("phase_null.batch_width", run) == pytest.approx(100.0)
    # 12 ms of least time over a mean 0.6 s of device time
    assert _read("phase_null.roofline", run) == pytest.approx(2.0)


@pytest.mark.parametrize("metric", PHASE[:3])
def test_phase_readers_read_nothing_from_rounded_clocks(metric):
    """The parent's phase null keeps only its rounded ``*_sec`` clocks:
    no span or counter metric is read from it."""
    run = {"calls": [{"wall_s": 1.0, "returned_s": 1.0,
                      "spans": {"upload_sec": 0.001, "observed_sec": 0.01,
                                "null_sec": 0.7, "upload_bytes": 8}}],
           "trace": {"calls": [[[0.0, 1.0]]]}, "work": {}}
    assert _read(metric, run) is None


def test_16bit_roofline_reads_its_own_count_only():
    call = {"wall_s": 2.0, "returned_s": 2.0, "spans": {"null_sec": 0.1}}
    trace = {"calls": [[[1.9, 1.95], [1.96, 2.0]]]}
    run = {"calls": [call], "trace": trace,
           "work": {"surrogate_16bit": (989e12 * 0.0045, 1.0)}}
    # 4.5 ms over the 90 ms of kernels inside the span
    assert _read("null.surrogate_roofline_16bit", run) == pytest.approx(5.0)
    # the float32 roofline finds no float32 count in the 16-bit cell
    assert _read("null.surrogate_roofline", run) is None
    run["work"] = {"surrogate": run["work"]["surrogate_16bit"]}
    assert _read("null.surrogate_roofline_16bit", run) is None


def test_16bit_cell_is_off_the_float32_roofline():
    names = {m["name"] for m in CAT.per_layer("cohort12.null_bf16")}
    assert "null.surrogate_roofline" not in names
    assert {"null.surrogate_roofline_16bit", "null.surrogate_s",
            "device.idle_share.null"} <= names
    names = {m["name"] for m in CAT.per_layer("pair.phase_null_cfg4")}
    assert names == set(PHASE) | {"device.idle_share.null"}


def test_e4m3_rounding():
    x = torch.tensor([1.0, 1 + 2**-4, 1 + 3 * 2**-4, 1 + 2**-5, -0.3])
    want = torch.tensor([1.0, 1.0, 1 + 2**-2, 1.0, -0.3125])
    assert torch.equal(null_16bit.round_e4m3(x), want)


def test_16bit_control_is_the_tf32_control_but_its_operands():
    """With the operands' rounding undone, the 16-bit control is the
    float32 control of ``null.py`` (TF32 band spectra)."""
    rng = np.random.default_rng(3)
    eeg = rng.standard_normal((2, 1024, 2)).astype(np.float32)
    emg = rng.standard_normal((2, 1024, 2)).astype(np.float32)
    p = dict(fs=128.0, window_sec=1.0, overlap=0.5, nw=3,
             taper_threshold=0.9, band=(10.0, 40.0), n_surrogates=20,
             surrogate_chunk=8)
    tf32 = null.cohort_null(eeg, emg, p, 5, "cpu", control=True)
    orig = null_16bit.round_e4m3
    try:
        null_16bit.round_e4m3 = null.round_tf32
        same = null_16bit.cohort_null(eeg, emg, p, 5, "cpu")
    finally:
        null_16bit.round_e4m3 = orig
    for k in ("observed", "max_stat", "counts"):
        np.testing.assert_array_equal(same[k], tf32[k])
    e4m3 = null_16bit.cohort_null(eeg, emg, p, 5, "cpu")
    np.testing.assert_array_equal(e4m3["observed"], tf32["observed"])
    assert np.abs(e4m3["max_stat"] - tf32["max_stat"]).max() > 1e-3


def test_phase_quantile_rule_on_ties():
    """A share exactly at q is not below it: the cell's quantile bin is
    the one that reaches q."""
    hist = torch.zeros(1, phase_null.N_BINS, dtype=torch.int64)
    hist[0, 3], hist[0, 9] = 19, 1                          # 20 drawn
    q = phase_null.histogram_quantiles(hist, 20, (0.95, 0.99))
    assert q[0.95][0] == np.float32(4 / 1024)
    assert q[0.99][0] == np.float32(10 / 1024)
