"""The port's threefry draws against ``jax.random``, and the nulls that
draw from them against the JAX package at one seed.

``mba_tpu_torch.ops.prng`` is held to ``jax.random`` bit for bit (JAX on
the CPU, ``jax_threefry_partitionable`` on, its default), and to fixed
values that do not lean on JAX: Random123's known-answer vectors for
Threefry-2x32-20 and ten draws of ``PRNGKey(0)``.  The nulls run with
nothing patched, the port at ``seed=s`` against the JAX package at
``seed=s``: ``max_stat`` within rtol 1e-5, ``p_fwe`` equal, counts
(``p_uncorrected``) equal but in at most 1e-4 of the cells, by one, and
the phase null's quantiles equal but in at most 1e-3 of the cells, by
one bin (the tie allowances of the existing null tests).
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mba_tpu.ops import cohort_null as JN
from mba_tpu.ops import surrogate as JS

import mba_tpu_torch
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.ops import cuda_prng, prng
from mba_tpu_torch.ops import surrogate as TS

from _torch_parity import cohort_subject
from test_torch_surrogate import _coupled

torch.set_num_threads(1)

SEEDS = [0, 42, 2 ** 31 + 5]
TIE_CELLS = 1e-4
QUANTILE_CELLS = 1e-3


def test_jax_threefry_is_partitionable():
    """The module's counter layout is the partitionable one."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [-1, 2 ** 32 + 7])
def test_prng_key_equals_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed),
                                  np.array(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 7])
def test_split_equals_jax(seed, num):
    got = prng.split(prng.prng_key(seed), num)
    assert got.dtype == np.uint32 and got.shape == (num, 2)
    np.testing.assert_array_equal(
        got, np.array(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("data", [0, 1, 7, 123456789, 2 ** 32 - 1])
def test_fold_in_equals_jax(data):
    key = jax.random.split(jax.random.PRNGKey(42))[1]
    np.testing.assert_array_equal(
        prng.fold_in(np.array(key), data),
        np.array(jax.random.fold_in(key, np.uint32(data))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (3, 5), (2, 4, 5, 7)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.0, 2 * np.pi),
                                    (-3.5, 7.25)])
def test_uniform_equals_jax_bitwise(seed, shape, bounds):
    """Bit for bit, a nonzero minval included (one fused rounding)."""
    got = prng.uniform(prng.prng_key(seed), shape, *bounds).numpy()
    ref = np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                      minval=bounds[0], maxval=bounds[1]))
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (4, 6)])
def test_random_bits_equals_jax(seed, shape):
    got = prng.random_bits(prng.prng_key(seed), shape).numpy()
    ref = np.array(jax.random.bits(jax.random.PRNGKey(seed), shape))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


@pytest.mark.parametrize("bounds", [(0, 96), (0, 1), (5, 3), (-7, 1000),
                                    (3, 100000), (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("shape", [(), (1000,)])
def test_randint_equals_jax(bounds, shape):
    key = jax.random.PRNGKey(11)
    got = prng.randint(np.array(key), shape, *bounds).numpy()
    ref = np.array(jax.random.randint(key, shape, *bounds))
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 10), (2, 1000),
                                    (3, 1627), (42, 2 ** 17 + 3)])
def test_permutation_equals_jax(seed, n):
    """``jax.random.permutation(key, n)`` bit for bit, through the plain
    draw and through the kernel wrapper's (its plain version here); n
    spans one round (n ≤ 1625) and two."""
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.permutation(key, n))
    got = prng.permutation(np.asarray(key), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        cuda_prng.permutation(np.asarray(key), n, "cpu").numpy(), ref)


def test_permutation_keeps_the_order_of_tied_keys():
    """At n = 2¹⁷ + 3 the 32-bit sort keys of some round hold a tie (~2
    expected per round), so the stable sort's tie order is exercised by
    ``test_permutation_equals_jax``."""
    n = 2 ** 17 + 3
    key = np.asarray(jax.random.PRNGKey(42))
    ties = 0
    for _ in range(2):                       # the rounds at this n
        key, sub = prng.split(key)
        bits = prng.random_bits(sub, (n,))
        ties += n - len(torch.unique(bits))
    assert ties >= 1


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError):
        prng.randint(prng.prng_key(0), (), 0, 2 ** 31)


# Threefry-2x32-20 known-answer vectors (Random123, kat_vectors):
# (key, counter) → output
KAT = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
        (0x6b200159, 0x99ba4efe)),
       ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
        (0x1cb996fc, 0xbb002be7)),
       ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
        (0xc4923a9c, 0x483df7a0))]
# jax.random.bits(PRNGKey(0), (10,)) under JAX 0.9.0's defaults
BITS_OF_KEY_0 = [4070199207, 4202968722, 1427181096, 2012915765,
                 2447653815, 710830403, 1332275837, 2961296638,
                 3207338339, 734502358]


@pytest.mark.parametrize("key,ctr,out", KAT)
def test_threefry2x32_known_answers(key, ctr, out):
    y0, y1 = prng.threefry2x32(*key, torch.tensor([ctr[0]]),
                               torch.tensor([ctr[1]]))
    assert (int(y0[0]), int(y1[0])) == out


def test_ten_fixed_draws_of_key_0():
    got = prng.random_bits(prng.prng_key(0), (10,)).tolist()
    assert got == BITS_OF_KEY_0
    np.testing.assert_array_equal(prng.split(prng.prng_key(0))[0],
                                  [0x6b200159, 0x99ba4efe])


def test_key_must_be_a_uint32_pair():
    with pytest.raises(ValueError):
        prng.uniform(np.array([0, 1], np.int64), (3,))
    with pytest.raises(ValueError):
        prng.split(np.zeros(3, np.uint32))


# ---- the wrapper's CPU route ---------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "bits", "pairs"])
def test_wrapper_takes_the_plain_version_on_the_cpu(kind):
    key = prng.prng_key(3)
    before = cuda_prng.threefry_draw.launches
    got = cuda_prng.threefry_draw(key, (5, 7), kind, "cpu", -1.0, 2.0)
    assert cuda_prng.threefry_draw.launches == before
    if kind == "uniform":
        ref = prng.uniform(key, (5, 7), -1.0, 2.0)
    elif kind == "bits":
        ref = prng.random_bits(key, (5, 7))
    else:
        ref = torch.stack(prng.threefry_pairs(key, 35), -1).reshape(5, 7, 2)
        np.testing.assert_array_equal(
            ref.reshape(35, 2).numpy().astype(np.uint32),
            prng.split(key, 35))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)


def test_many_keys_take_the_plain_version_on_the_cpu():
    """uniform_keys: row s is uniform(keys[s], shape), the full-FFT null's
    per-surrogate draw (``cohort_null.py:613-616``) in one call."""
    keys = prng.split(prng.prng_key(8), 5)
    before = cuda_prng.threefry_draw.launches
    got = cuda_prng.uniform_keys(keys, (3, 4), 0.0, 2 * np.pi, "cpu")
    assert cuda_prng.threefry_draw.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 3, 4)
    for k, row in zip(keys, got):
        ref = np.array(jax.random.uniform(jnp.asarray(k), (3, 4),
                                          minval=0.0, maxval=2 * np.pi))
        np.testing.assert_array_equal(row.numpy().view(np.uint32),
                                      ref.view(np.uint32))
    with pytest.raises(ValueError):
        cuda_prng.uniform_keys(keys.astype(np.int64), (3,), 0.0, 1.0, "cpu")


def test_wrapper_refuses_other_devices_and_kinds():
    with pytest.raises(ValueError):
        cuda_prng.threefry_draw(prng.prng_key(0), (3,), "uniform", "meta")
    with pytest.raises(ValueError):
        cuda_prng.threefry_draw(prng.prng_key(0), (3,), "normal", "cpu")


def test_no_torch_generator_in_the_package():
    """Every draw of the port goes through the threefry module."""
    root = Path(mba_tpu_torch.__file__).parent
    hits = [str(p) for p in root.rglob("*.py")
            if "torch.Generator" in p.read_text()]
    assert not hits


# ---- the nulls at one seed against the JAX package -------------------------

FS = 256.0
KW = dict(sampling_freq=FS, window_length_sec=2.0, band=(8.0, 60.0),
          seed=5)


def _cohort(J=2, n_sec=16.0):
    subj = [cohort_subject(10 + j, n_sec=n_sec, couple=2.0) for j in
            range(J)]
    return (np.stack([s[0] for s in subj]), np.stack([s[1] for s in subj]))


def _assert_null_equal(got, ref, n_total):
    np.testing.assert_allclose(got["max_stat"], ref["max_stat"], rtol=1e-5,
                               atol=0)
    assert got["p_fwe"] == ref["p_fwe"]
    d = np.abs(got["p_uncorrected"].astype(np.float64)
               - ref["p_uncorrected"]) * (1 + n_total)
    assert np.round(d).max() <= 1 and (np.round(d) > 0).mean() <= TIE_CELLS
    for q, r in ref["null_quantiles"].items():
        np.testing.assert_allclose(got["null_quantiles"][q], r, rtol=1e-5)


@pytest.mark.parametrize("mode,engine_jax,engine_port", [
    ("shared", "xla", "pallas"), ("shared", "gram", "gram"),
    ("per_window", "xla", "xla")])
def test_rotation_null_equals_jax_at_one_seed(mode, engine_jax, engine_port):
    """Shared mode: per chunk ``split``, one ``uniform`` of (J, S, K, F);
    per-window mode: ``fold_in(sub, w)`` per window; three chunks."""
    eeg, emg = _cohort()
    kw = dict(n_surrogates=250, surrogate_chunk=100, rotation_mode=mode,
              **KW)
    ref = JN.cohort_msc_rotation_null(eeg, emg, coeff_engine=engine_jax,
                                      compute_dtype=jnp.float32, **kw)
    got = TN.cohort_msc_rotation_null(eeg, emg, coeff_engine=engine_port,
                                      device="cpu", **kw)
    _assert_null_equal(got, ref, 300)


def test_fft_null_equals_jax_at_one_seed():
    """Per chunk ``split(sub, chunk)``, one ``uniform`` of (J, n_f) per
    surrogate, DC and Nyquist 0; two chunks."""
    eeg, emg = _cohort(n_sec=12.0)
    kw = dict(n_surrogates=40, surrogate_chunk=20, **KW)
    ref = JN.cohort_msc_fft_null(eeg, emg, **kw)
    got = TN.cohort_msc_fft_null(eeg, emg, **kw, device="cpu")
    _assert_null_equal(got, ref, 40)


@pytest.mark.parametrize("max_stat_only", [False, True])
def test_phase_null_equals_jax_at_one_seed(max_stat_only):
    """Per chunk ``split``, one ``uniform`` of (S, F, M); three chunks."""
    eeg, emg = _coupled(11, nE=2, nM=3)
    kw = dict(window_length_sec=1.0, quantiles=(0.95, 0.99), seed=3,
              n_surrogates=48, surrogate_chunk=16,
              max_stat_only=max_stat_only)
    ref = JS.msc_phase_randomized_null(eeg, emg, 128, **kw)
    got = TS.msc_phase_randomized_null(eeg, emg, 128, **kw, device="cpu")
    np.testing.assert_allclose(got["max_stat"], ref["max_stat"], rtol=1e-5,
                               atol=0)
    assert got["p_fwe"] == ref["p_fwe"]
    for q, r in ref["null_quantiles"].items():
        d = np.abs(np.asarray(got["null_quantiles"][q]) - r)
        if max_stat_only:
            assert d <= 1e-5 * abs(r)
        else:
            d = d * TS.N_BINS
            assert d.max() <= 1 and (d > 0).mean() <= QUANTILE_CELLS
