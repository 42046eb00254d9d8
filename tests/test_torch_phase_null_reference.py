"""The port's phase-randomised null (``ops/surrogate.py:
msc_phase_randomized_null``) against the benchmark's plain reference
(``benchmarks/reference/phase_null.py``: float64, its own DPSS, framing
and FFT, the frozen threefry copy) on the CPU at small sizes: every
number the ``pair.phase_null_cfg4`` cell compares lies within that
cell's limits, and the reference's float16 control fails at least one.
Also the reference's own pieces: the histogram rule's quantiles, the
surrogates' amplitude spectrum, and the step's work count at the cell's
shapes."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.reference import phase_null as ref
from benchmarks.work.peaks import least_seconds
from benchmarks.work.phase_null import step_work
from mba_tpu_torch.ops import surrogate as TS

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
LIMITS = json.loads((BENCH / "workloads" / "pair.phase_null_cfg4.json")
                    .read_text())["check"]["limits"]

FS = 256.0
SECONDS = 8.0
PARAMS = dict(fs=FS, window_sec=1.0, overlap=0.5, nw=3, taper_threshold=0.9,
              n_surrogates=64, surrogate_chunk=32, quantiles=(0.95, 0.99),
              max_stat_only=False)


def _pair(seed, n_eeg=1, n_emg=1, couple=0.4):
    """Unit white noise under a shared 15-30 Hz drive (the cell's signal
    model, ``configs/pair.json``)."""
    rng = np.random.default_rng(seed)
    n = int(FS * SECONDS)
    f = np.fft.rfftfreq(n, 1 / FS)
    spec = np.fft.rfft(rng.standard_normal(n))
    spec[(f < 15) | (f > 30)] = 0
    drive = np.fft.irfft(spec, n=n)
    drive /= drive.std()
    eeg = rng.standard_normal((n, n_eeg)) + couple * drive[:, None]
    emg = rng.standard_normal((n, n_emg)) + couple * drive[:, None]
    return eeg.astype(np.float32), emg.astype(np.float32)


def _port(eeg, emg, p, seed):
    return TS.msc_phase_randomized_null(
        eeg, emg, p["fs"], n_surrogates=p["n_surrogates"], nw=p["nw"],
        window_length_sec=p["window_sec"], overlap_frac=p["overlap"],
        taper_eigenvalue_threshold=p["taper_threshold"], band=p["band"],
        quantiles=p["quantiles"], surrogate_chunk=p["surrogate_chunk"],
        seed=seed, max_stat_only=False, device="cpu")


@pytest.mark.parametrize("seed,n_eeg,n_emg,band,n_surrogates", [
    (2**31 + 7, 1, 1, None, 64),          # the cell's pair, two chunks
    (11, 2, 3, None, 70),                 # 6 pairs; a surplus of 26
    (12, 1, 2, (10.0, 40.0), 64),         # the max statistic in a band
])
def test_port_within_the_cells_limits(seed, n_eeg, n_emg, band,
                                      n_surrogates):
    eeg, emg = _pair(seed, n_eeg, n_emg)
    p = {**PARAMS, "band": band, "n_surrogates": n_surrogates}
    got = _port(eeg, emg, p, seed)
    want = ref.phase_null(eeg, emg, p, seed, "cpu")
    assert want["n_drawn"] == -(-n_surrogates // 32) * 32
    nums = ref.compare(got, want)
    assert set(nums) == set(LIMITS)
    for k, v in nums.items():
        assert v <= LIMITS[k], (k, v, LIMITS[k])
    assert got["p_fwe"] == want["p_fwe"]


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_float16_control_fails(seed):
    eeg, emg = _pair(seed)
    p = {**PARAMS, "band": None}
    want = ref.phase_null(eeg, emg, p, seed, "cpu")
    control = ref.phase_null(eeg, emg, p, seed, "cpu", control=True)
    nums = ref.compare(control, want)
    assert [k for k, v in nums.items() if not v <= LIMITS[k]]


def test_reference_refuses_max_stat_only():
    eeg, emg = _pair(1)
    with pytest.raises(ValueError, match="max_stat_only"):
        ref.phase_null(eeg, emg, {**PARAMS, "band": None,
                                  "max_stat_only": True}, 1, "cpu")


def test_histogram_rule():
    """Quantile q of a cell: (bins whose float32 cumulative share lies
    below float32 q, plus 1) / 1024."""
    hist = torch.zeros(2, ref.N_BINS, dtype=torch.int64)
    hist[0, 10], hist[0, 500], hist[0, 1023] = 95, 4, 1    # 100 drawn
    hist[1, 0], hist[1, 7] = 99, 1
    q = ref.histogram_quantiles(hist, 100, (0.95, 0.99))
    # cell 0: the share reaches 0.95 at bin 10 and 0.99 at bin 500
    np.testing.assert_array_equal(q[0.95], np.float32([11, 1]) / 1024)
    np.testing.assert_array_equal(q[0.99], np.float32([501, 1]) / 1024)


def test_surrogates_keep_the_amplitude_spectrum():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((512, 2)))
    xf = torch.fft.rfft(x, dim=0)
    phi = torch.from_numpy(rng.uniform(0, 2 * np.pi, (3, 257, 2)))
    s = ref.turned(xf, 512, phi)
    sf = torch.fft.rfft(s, dim=1)
    assert torch.allclose(sf.abs(), xf.abs()[None].expand_as(sf),
                          atol=1e-10)
    # DC and Nyquist unturned
    assert torch.allclose(sf[:, [0, -1]], xf[None, [0, -1]], atol=1e-10)


def test_step_work_at_the_cells_shapes():
    """10 000 surrogates of one 120-s pair at 2048 Hz, 119 windows of
    4096, K = 5: bound by operations at about 15 ms on the float32 peak
    (an irfft of 245 760 and 595 rFFTs of 4096 a surrogate)."""
    flops, nbytes = step_work(10_000, 245_760, 4096, 119, 5, 1, 1)
    t, by = least_seconds(flops, nbytes)
    assert by == "operations"
    assert t * 1e3 == pytest.approx(15.33, rel=2e-3)
    # the surrogates' signals written and read once dominate the bytes
    assert 2 * 4 * 10_000 * 245_760 < nbytes < 1.3 * 2 * 4 * 10_000 \
        * 245_760
