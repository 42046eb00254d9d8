"""Parity of the port's chunked coefficient pass (``mba_tpu_torch.ops.
rotation_coeffs``) with ``mba_tpu``'s ``_rotation_coeffs_body``, and the
wrapper of kernel B3 (``ops/cuda_coeffs.py``) on CPU tensors.

The port's ``'pallas'`` engine calls the B3 wrapper, which runs its plain
version on CPU tensors; it is held against the JAX Pallas kernel in
interpret mode in the five cases of ``tests/test_pallas_coeffs.py``, and
the ``'xla'`` and per-window bodies against the JAX scan engine.  The
tolerance is the one the JAX package holds its two engines to, rtol 2e-5
/ atol 2e-6 (``tests/test_pallas_coeffs.py:52-53``): the coefficients are
window means of terms at most 1 in size, and the two packages differ only
in their rFFT and in float32 rounding order.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mba_tpu.ops import cohort_null as CN
from mba_tpu.ops.dpss import filtered_tapers

from mba_tpu_torch.ops import cuda_coeffs
from mba_tpu_torch.ops.rotation_coeffs import rotation_coeffs_subject

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6


def _problem(seed=0, n_sec=8.0, fs=256.0, E=3, M=4):
    """``tests/test_pallas_coeffs.py:15-26``: noise with a shared 21 Hz
    random-walk-phase drive in EEG 0 and EMG 1."""
    rng = np.random.default_rng(seed)
    n = int(n_sec * fs)
    t = np.arange(n) / fs
    eeg = rng.standard_normal((n, E)).astype(np.float32)
    emg = rng.standard_normal((n, M)).astype(np.float32)
    shared = np.sin(2 * np.pi * 21.0 * t
                    + 0.1 * rng.standard_normal(n).cumsum())
    eeg[:, 0] += shared
    emg[:, 1] += shared
    return eeg, emg


def _run_both(eeg, emg, engine, ws=256, W=10, chunk=4, band_lo=0,
              band_hi=None, weights=None, per_window=False, nw=3,
              jax_engine=None):
    """JAX body and the port's on the same numpy inputs, as numpy; the
    JAX body runs ``jax_engine`` (default: ``engine``)."""
    jax_engine = jax_engine or engine
    tapers = np.asarray(filtered_tapers(ws, nw, 0.9), np.float32)
    band_hi = ws // 2 + 1 if band_hi is None else band_hi
    starts = np.linspace(0, eeg.shape[0] - ws, W).astype(np.int32)
    w = np.ones(W, np.float32) if weights is None else weights
    b0, c0 = CN._rotation_coeffs_body(
        jnp.asarray(eeg), jnp.asarray(emg), jnp.asarray(starts),
        jnp.asarray(w), jnp.asarray(tapers), window_samples=ws,
        band_lo=band_lo, band_hi=band_hi, window_chunk=chunk,
        per_window=per_window, use_pallas=jax_engine == "pallas",
        pallas_interpret=jax_engine == "pallas")
    b1, c1 = rotation_coeffs_subject(
        torch.from_numpy(eeg), torch.from_numpy(emg),
        torch.from_numpy(starts.astype(np.int64)), torch.from_numpy(w),
        torch.from_numpy(tapers), ws, band_lo, band_hi, chunk,
        engine=engine, per_window=per_window)
    return np.asarray(b0), np.asarray(c0), b1.numpy(), c1.numpy()


_NONUNIFORM = np.array([1, 0, 2, 0.5, 1, 1, 0, 3, 1, 0.25], np.float32)
CASES = {
    "full_band": dict(seed=0, kw={}),
    "odd_nF_95": dict(seed=1, kw=dict(band_lo=5, band_hi=100)),
    # W=10 with chunk=4 pads 2 windows; zero weights must stay zero
    "weights_and_padding": dict(seed=2, kw=dict(weights=_NONUNIFORM)),
    "int16": dict(seed=3, kw={}, int16=True),
}


def _case_inputs(case):
    spec = CASES[case]
    eeg, emg = _problem(spec["seed"])
    if spec.get("int16"):
        eeg, emg = (eeg * 1000).astype(np.int16), (emg * 1000).astype(np.int16)
    return eeg, emg, spec["kw"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pallas_engine_matches_jax_pallas_interpret(case):
    eeg, emg, kw = _case_inputs(case)
    before = cuda_coeffs.coeff_pairs.launches
    b0, c0, b1, c1 = _run_both(eeg, emg, "pallas", **kw)
    assert cuda_coeffs.coeff_pairs.launches == before
    assert b1.shape == b0.shape and c1.shape == c0.shape
    if case == "odd_nF_95":
        assert b0.shape[0] == 95
    np.testing.assert_allclose(b1, b0, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c1, c0, rtol=RTOL, atol=ATOL)


def test_pallas_engine_takes_any_taper_count_on_cpu():
    """nw = 5 gives K = 9 tapers: CPU tensors run the plain pair pass at
    any K, as the JAX package's ``'pallas'`` engine becomes its scan
    engine off a TPU (``mba_tpu/ops/cohort_null.py:1168-1173``)."""
    K = filtered_tapers(256, 5, 0.9).shape[0]
    assert K == 9
    eeg, emg, kw = _case_inputs("weights_and_padding")
    b0, c0, b1, c1 = _run_both(eeg, emg, "pallas", nw=5, jax_engine="xla",
                               **kw)
    assert c1.shape == c0.shape and c1.shape[-1] == K * (K - 1)
    np.testing.assert_allclose(b1, b0, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c1, c0, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nw,case", [(8, "weights_and_padding"),
                                     (8, "full_band"),
                                     (9, "weights_and_padding")])
def test_pallas_engine_plain_pass_at_nw8_matches_jax(nw, case):
    """nw = 8, K = 15 tapers (105 pairs; on the card one of kernel B3's
    compile-time instances above K = 8), and nw = 9, K = 17 (136 pairs;
    on the card B3's runtime-K instance): on the CPU the plain pair pass,
    against the JAX scan engine, within RTOL / ATOL."""
    K = filtered_tapers(256, nw, 0.9).shape[0]
    assert K == 2 * nw - 1
    eeg, emg, kw = _case_inputs(case)
    b0, c0, b1, c1 = _run_both(eeg, emg, "pallas", nw=nw, jax_engine="xla",
                               **kw)
    assert c1.shape == c0.shape and c1.shape[-1] == K * (K - 1)
    np.testing.assert_allclose(b1, b0, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c1, c0, rtol=RTOL, atol=ATOL)


def test_pallas_engine_observed_statistic_matches_jax():
    """base + Σ cos-features·coef at φ = 0, through both packages."""
    eeg, emg = _problem(4)
    b0, c0, b1, c1 = _run_both(eeg, emg, "pallas")
    P = c0.shape[-1]
    obs0 = b0 + c0[..., :P // 2].sum(axis=-1)
    obs1 = b1 + c1[..., :P // 2].sum(axis=-1)
    np.testing.assert_allclose(obs1, obs0, rtol=RTOL, atol=ATOL)
    assert np.all(obs1 > -1e-5) and np.all(obs1 < 1 + 1e-5)


@pytest.mark.parametrize("case", ["full_band", "odd_nF_95",
                                  "weights_and_padding", "int16"])
def test_xla_engine_matches_jax_scan(case):
    eeg, emg, kw = _case_inputs(case)
    b0, c0, b1, c1 = _run_both(eeg, emg, "xla", **kw)
    np.testing.assert_allclose(b1, b0, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c1, c0, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["full_band", "weights_and_padding"])
def test_per_window_body_matches_jax(case):
    """``per_window=True`` keeps the padded window axis: (Wp, F, N, P),
    zero in the pad windows (``tests/test_cohort_null.py:473-482``)."""
    eeg, emg, kw = _case_inputs(case)
    b0, c0, b1, c1 = _run_both(eeg, emg, "xla", per_window=True,
                               band_lo=2, band_hi=40, **kw)
    assert c1.shape == c0.shape == (12, 38, 12, 20)
    np.testing.assert_array_equal(c1[10:], 0.0)
    np.testing.assert_allclose(b1, b0, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c1, c0, rtol=RTOL, atol=ATOL)


def test_per_window_sums_to_the_shared_coefficients():
    eeg, emg = _problem(5)
    _, _, b_pw, c_pw = _run_both(eeg, emg, "xla", per_window=True,
                                 weights=_NONUNIFORM)
    _, _, b, c = _run_both(eeg, emg, "xla", weights=_NONUNIFORM)
    np.testing.assert_allclose(b_pw, b, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(c_pw.sum(axis=0).reshape(c.shape), c,
                               rtol=1e-5, atol=1e-6)


def test_unknown_engine_raises():
    x = torch.zeros((512, 2))
    with pytest.raises(ValueError, match="engine"):
        rotation_coeffs_subject(x, x, torch.zeros(2, dtype=torch.int64),
                                torch.ones(2), torch.ones((3, 256)), 256,
                                1, 20, 2, engine="gram")


# ---- the B3 wrapper on CPU tensors ---------------------------------------

def _random_spectra(seed, wc=5, K=5, nF=7, nE=3, nM=6):
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 + 1j * rng.standard_normal(shape))
                                .astype(np.complex64))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, wc).astype(np.float32))
    return cplx(wc, K, nF, nE), cplx(wc, K, nF, nM), w


def test_cpu_tensors_take_the_plain_pair_pass():
    e, m, w = _random_spectra(0)
    before = cuda_coeffs.coeff_pairs.launches
    got = cuda_coeffs.coeff_pairs(e, m, w)
    ref = cuda_coeffs.coeff_pairs_plain(e, m, w)
    assert cuda_coeffs.coeff_pairs.launches == before
    assert [tuple(x.shape) for x in got] == [(7, 18), (10, 7, 18),
                                             (10, 7, 18)]
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_pair_pass_matches_per_window_definition():
    """The window sums against y_k formed one window at a time in
    float64: diag = Σ_{w,k} |y_k|², pr + i·pi = Σ_w y_k·conj(y_l)."""
    e, m, w = _random_spectra(1, K=4)
    diag, pr, pi = cuda_coeffs.coeff_pairs_plain(e, m, w)
    E, M, wd = (x.numpy().astype(np.complex128) for x in (e, m, w))
    pe = (np.abs(E) ** 2).sum(1)                           # (wc, F, E)
    pm = (np.abs(M) ** 2).sum(1)
    sc = np.sqrt(wd.real[:, None, None, None]
                 / (pe[..., :, None] * pm[..., None, :]))
    y = np.conj(E)[..., :, None] * M[..., None, :] * sc[:, None]
    y = y.reshape(*y.shape[:3], -1)                        # (wc, K, F, N)
    np.testing.assert_allclose(diag.numpy(), (np.abs(y) ** 2).sum((0, 1)),
                               rtol=1e-5, atol=1e-6)
    ks, ls = np.triu_indices(4, 1)
    c = np.stack([(y[:, k] * np.conj(y[:, l])).sum(0)
                  for k, l in zip(ks, ls)])
    np.testing.assert_allclose(pr.numpy(), c.real, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pi.numpy(), c.imag, rtol=1e-5, atol=1e-6)


def test_zero_weight_window_adds_nothing_but_carries_nan():
    """A zero-weight window is evaluated like any other: finite spectra
    add exact zeros, a NaN spectrum makes the sums NaN (jnp.maximum and
    torch.clamp_min both propagate it)."""
    e, m, w = _random_spectra(2)
    w[1] = 0.0
    full = cuda_coeffs.coeff_pairs(e, m, w)
    keep = [0, 2, 3, 4]
    part = cuda_coeffs.coeff_pairs(e[keep].contiguous(),
                                   m[keep].contiguous(), w[keep])
    for a, b in zip(full, part):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    e[1, 0, 3, 2] = complex(float("nan"), 0.0)
    diag, pr, pi = cuda_coeffs.coeff_pairs(e, m, w)
    assert torch.isnan(diag[3].reshape(3, 6)[2]).all()
    assert torch.isfinite(diag[2]).all()


def test_out_sums_chunks_as_separate_calls_and_add():
    """``out=`` over two chunks gives, bit for bit, what the separate calls
    and ``add_`` gave before (the wrapper on CPU tensors and the plain
    version alike), and returns ``out`` itself."""
    e, m, w = _random_spectra(6, wc=7)
    chunks = [(e[a:b].contiguous(), m[a:b].contiguous(), w[a:b].contiguous())
              for a, b in ((0, 4), (4, 7))]
    for fn in (cuda_coeffs.coeff_pairs, cuda_coeffs.coeff_pairs_plain):
        ref = fn(*chunks[0])
        for acc, x in zip(ref, fn(*chunks[1])):
            acc.add_(x)
        out = fn(*chunks[0])
        got = fn(*chunks[1], out=out)
        assert got is out
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        zeros = tuple(torch.zeros_like(x) for x in ref)
        for c in chunks:
            fn(*c, out=zeros)
        for a, b in zip(zeros, ref):
            assert torch.equal(a, b)


def _bad_coeff_inputs():
    e, m, w = _random_spectra(3, wc=3, K=3, nF=4, nE=2, nM=3)
    e1, m1, _ = _random_spectra(5, wc=3, K=1, nF=4, nE=2, nM=3)
    out = cuda_coeffs.coeff_pairs_plain(e, m, w)
    diag, pr, pi = out
    return [
        (e.to(torch.complex128), m, w, None, TypeError),
        (e, m, w.double(), None, TypeError),
        (e.real.contiguous(), m, w, None, TypeError),
        (e.transpose(2, 3).contiguous().transpose(2, 3), m, w, None,
         ValueError),                                    # not contiguous
        (e[:, :, :3].contiguous(), m, w, None, ValueError),  # (wc, K, F)
        (e, m, w[:2].contiguous(), None, ValueError),    # weights shape
        (e[0], m[0], w, None, ValueError),               # not 4-D
        (e.to("meta"), m.to("meta"), w.to("meta"), None,
         ValueError),                                    # no device
        (e, m.to("meta"), w, None, ValueError),          # devices differ
        (e, m, w, (diag, pr[:2].contiguous(), pi), ValueError),  # out shape
        (e1, m1, w, None, ValueError),                   # K < 2
        (e, m, w, (diag.double(), pr, pi), TypeError),   # out dtype
        (e, m, w, (diag, pr.to("meta"), pi), ValueError),    # out device
        (e, m, w, (diag, pr, pi.transpose(1, 2).contiguous().transpose(1, 2)),
         ValueError),                                    # out not contiguous
        (e, m, w, (diag, pr), ValueError),               # not three tensors
    ]


@pytest.mark.parametrize("case", range(15))
def test_coeff_wrapper_refuses_bad_input(case):
    e, m, w, out, exc = _bad_coeff_inputs()[case]
    with pytest.raises(exc):
        cuda_coeffs.coeff_pairs(e, m, w, out=out)
