"""The reference agrees with the port's CPU path at small sizes; the
null's algebra agrees with turning the spectra themselves; the frozen
key schedule draws the port's phases."""
import time

import numpy as np
import pytest
import torch

from benchmarks.harness.catalog import Catalog
from benchmarks.harness.runner import run_cell
from benchmarks.reference import null, threefry
from benchmarks.reference.spectra import tapered_spectra, tapers, \
    window_starts
from benchmarks.tests.tiny import tiny

CELLS = [c["name"] for c in Catalog().spec["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_port_cpu_path_is_correct(cell):
    cat = Catalog()
    res = run_cell(cell, 2**31 + 99, 0.3, False, "cpu", time.perf_counter(),
                   cat, overrides=tiny(cat, cell))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    # at this size the port's gaps are a tenth of their limits or less
    # (a share of flipped counts is too coarse here: one flip is 2e-6)
    for name, c in res["checks"].items():
        if name.endswith("_gap"):
            assert c["value"] <= c["limit"] / 10, (name, c)


def test_threefry_copy_draws_the_ports_phases():
    from mba_tpu_torch.ops import prng
    for seed in (0, 7, 2**31 + 5, 2**32 + 3):
        key = threefry.prng_key(seed)
        pkey = prng.prng_key(seed)
        for _ in range(3):
            key, sub = threefry.split(key)
            pkey, psub = prng.split(pkey)
            assert tuple(map(int, psub)) == sub
        got = threefry.uniform(sub, (3, 5, 7), 0.0, 2 * np.pi, "cpu")
        want = prng.uniform(psub, (3, 5, 7), 0.0, 2 * np.pi, "cpu")
        assert torch.equal(got, want)


def test_null_algebra_equals_turned_spectra():
    """The statistic of one surrogate from the coefficients equals the
    window mean of the MSC of the EMG spectra turned by its phases."""
    rng = np.random.default_rng(1)
    fs, n, ws, E, M = 64.0, 512, 128, 2, 3
    eeg = torch.from_numpy(rng.standard_normal((n, E)))
    emg = torch.from_numpy(rng.standard_normal((n, M)))
    tap = torch.from_numpy(tapers(ws, 3, 0.9))
    K = tap.shape[0]
    lo, hi = null.band_bins(ws, fs, (5.0, 20.0))
    starts = window_starts(n, ws, 0.5)
    starts = starts[null.disjoint(starts, ws)]
    base, coef = null.subject_coefficients(eeg, emg, starts, ws, tap, lo,
                                           hi)
    phi = torch.from_numpy(rng.uniform(0, 2 * np.pi, (1, 1, K, hi - lo)))
    g = null.features(phi, torch.float64)[:, 0]                 # (F, P)
    stat = base + torch.einsum("fp,pfem->fem", g, coef)
    Es = tapered_spectra(eeg, starts, ws, tap)[:, :, lo:hi]
    Ms = tapered_spectra(emg, starts, ws, tap)[:, :, lo:hi]
    Ms = Ms * torch.exp(1j * phi[0, 0])[None, :, :, None]
    cross = (torch.conj(Es)[..., None] * Ms[..., None, :]).sum(1)
    pe = (Es.abs() ** 2).sum(1)
    pm = (Ms.abs() ** 2).sum(1)
    direct = (cross.abs() ** 2 / (pe[..., None] * pm[..., None, :])).mean(0)
    assert torch.allclose(stat, direct, rtol=1e-10, atol=1e-12)


def test_disjoint_windows_and_band():
    assert null.disjoint(np.arange(7) * 2048, 4096).tolist() == \
        [True, False, True, False, True, False, True]
    assert null.band_bins(4096, 2048.0, (13.0, 100.0)) == (26, 201)
    assert null.band_bins(8, 8.0, (0.0, 4.0)) == (1, 4)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-10 + 2**-11),
                      1 + 2**-12])
    want = torch.tensor([1.0, 1.0, 1 + 2**-9, -(1 + 2**-9), 1.0])
    assert torch.equal(null.round_tf32(x), want)
