"""Parity of the port's other cohort-null engines with ``mba_tpu``: the
chunked coefficient engines (``coeff_engine='pallas'|'xla'``) against
both of the JAX package's upload modes, the per-window rotation null, the
full-FFT null and the ``cohort_msc_null`` dispatch.

Observed maps are compared at the tolerance of the engine that made
them: the chunked engines at rtol 2e-5 / atol 2e-6 (the JAX package's
bound between its own engines, ``tests/test_pallas_coeffs.py:52``), the
gram engine at rtol 2e-4 / atol 2e-5·max (``tests/test_gram_coeffs.py:
65-68``).  Nulls are compared in distribution, or on the same numpy
phases (``tests/test_torch_prng.py`` holds the port's own draws to the
JAX package's at one seed).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mba_tpu.ops import cohort_null as JN
from mba_tpu.ops.dpss import filtered_tapers
from mba_tpu.ops.framing import window_grid

from mba_tpu_torch import convert
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.ops import cuda_coeffs, prng

from _torch_parity import cohort_subject

torch.set_num_threads(1)

FS = 256.0
KW = dict(sampling_freq=FS, window_length_sec=2.0, band=(8.0, 60.0),
          surrogate_chunk=500, seed=5)


def _cohort(J=3, n_sec=24.0, couple=2.0, nE=3, nM=4):
    subj = [cohort_subject(10 + j, n_sec=n_sec, couple=couple, nE=nE,
                           nM=nM) for j in range(J)]
    return (np.stack([s[0] for s in subj]), np.stack([s[1] for s in subj]))


def _assert_observed(got, ref, engine):
    if engine == "gram":
        sc = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5 * sc)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("engine,overlap", [
    ("xla", True), ("pallas", True), ("pallas", False), ("gram", False)])
def test_rotation_null_engines_match_jax(engine, overlap):
    """The observed map against the JAX call with the same engine (JAX
    runs ``'pallas'`` as its XLA scan on the CPU, uploading per subject or
    the whole cohort first; the port has the per-subject upload only),
    the surrogate loop end to end, and the timing split."""
    eeg, emg = _cohort(J=2, n_sec=16.0)
    ref = JN.cohort_msc_rotation_null(
        eeg, emg, precompute_only=True, coeff_engine=engine,
        overlap_upload=overlap, window_chunk=4, **KW)
    before = cuda_coeffs.coeff_pairs.launches
    got = TN.cohort_msc_rotation_null(
        eeg, emg, n_surrogates=300, coeff_engine=engine, window_chunk=4,
        **KW, device="cpu")
    assert cuda_coeffs.coeff_pairs.launches == before
    _assert_observed(got["observed"], ref["observed"], engine)
    assert got["max_stat"].shape == (300,)
    assert np.isfinite(got["max_stat"]).all()
    t = got["metadata"]["timings"]
    assert t["coeff_engine"] == engine
    for key in ("upload_sec", "coeffs_sec", "upload_bytes"):
        assert key in t
    assert t["upload_bytes"] == eeg.nbytes + emg.nbytes


def test_chunked_engines_agree_with_gram_on_the_port():
    eeg, emg = _cohort(J=2, n_sec=16.0)
    obs = {e: TN.cohort_msc_rotation_null(eeg, emg, precompute_only=True,
                                          coeff_engine=e, device="cpu",
                                          **KW)["observed"]
           for e in ("gram", "xla", "pallas")}
    np.testing.assert_array_equal(obs["xla"], obs["pallas"])
    _assert_observed(obs["xla"], obs["gram"], "gram")


def test_pallas_engine_null_matches_jax_in_distribution():
    """``test_rotation_null_slice_matches_jax`` through the chunked
    engine: the JAX 0.95 quantile of max_stat lies between the port's
    quantiles at 0.95 ± 3·sqrt(2·0.95·0.05/n), n = 2000."""
    eeg, emg = _cohort()
    n = 2000
    ref = JN.cohort_msc_rotation_null(eeg, emg, n_surrogates=n,
                                      compute_dtype=jnp.float32,
                                      coeff_engine="xla", **KW)
    got = TN.cohort_msc_rotation_null(eeg, emg, n_surrogates=n,
                                      coeff_engine="pallas", device="cpu",
                                      **KW)
    _assert_observed(got["observed"], ref["observed"], "pallas")
    assert got["p_fwe"] < 0.01 and ref["p_fwe"] < 0.01
    half = 3.0 * np.sqrt(2 * 0.95 * 0.05 / n)
    lo_q, hi_q = np.quantile(got["max_stat"], [0.95 - half, 0.95 + half])
    assert lo_q <= ref["null_quantiles"][0.95] <= hi_q
    for key in ("n_surrogates_drawn", "rotation_mode", "contraction_flops"):
        assert got["metadata"][key] == ref["metadata"][key], key


# ---- the per-window rotation null ----------------------------------------

def test_per_window_null_matches_jax():
    """Observed map, metadata (the engine is the scan engine, the flops
    carry the Wp factor) and the null in distribution."""
    eeg, emg = _cohort()
    n = 2000
    kw = dict(n_surrogates=n, rotation_mode="per_window", **KW)
    ref = JN.cohort_msc_rotation_null(eeg, emg, compute_dtype=jnp.float32,
                                      **kw)
    got = TN.cohort_msc_rotation_null(eeg, emg, coeff_engine="pallas",
                                      device="cpu", **kw)
    _assert_observed(got["observed"], ref["observed"], "xla")
    assert got["metadata"]["timings"]["coeff_engine"] == "xla"
    for key in ("rotation_mode", "n_surrogates_drawn", "contraction_flops",
                "K_tapers", "band_bins"):
        assert got["metadata"][key] == ref["metadata"][key], key
    assert got["p_fwe"] < 0.01 and ref["p_fwe"] < 0.01
    half = 3.0 * np.sqrt(2 * 0.95 * 0.05 / n)
    lo_q, hi_q = np.quantile(got["max_stat"], [0.95 - half, 0.95 + half])
    assert lo_q <= ref["null_quantiles"][0.95] <= hi_q


def test_per_window_observed_equals_shared():
    """The observed statistic is rotation-free, so both modes give the
    same map (``tests/test_cohort_null.py:513-514``)."""
    eeg, emg = _cohort(J=2, n_sec=16.0)
    kw = dict(precompute_only=True, coeff_engine="xla", **KW)
    a = TN.cohort_msc_rotation_null(eeg, emg, rotation_mode="per_window",
                                    **kw, device="cpu")
    b = TN.cohort_msc_rotation_null(eeg, emg, **kw, device="cpu")
    np.testing.assert_allclose(a["observed"], b["observed"], rtol=1e-5,
                               atol=1e-6)
    assert a["metadata"]["rotation_mode"] == "per_window"


@pytest.mark.parametrize("kw,match", [
    (dict(rotation_mode="per_window", p_value_windows="all"),
     "p_value_windows"),
    (dict(rotation_mode="per_window", per_window_max_coef_bytes=16),
     "per-window coefficients"),
    (dict(rotation_mode="bogus"), "rotation_mode"),
    (dict(coeff_engine="bogus"), "coeff_engine"),
])
def test_rotation_null_guards(kw, match):
    eeg, emg = _cohort(J=2, n_sec=8.0)
    with pytest.raises(ValueError, match=match):
        TN.cohort_msc_rotation_null(eeg, emg, FS, n_surrogates=10,
                                    device="cpu", **kw)


def _pw_state(seed, Wp=3, J=2, nF=4, nE=2, nM=5, K=3):
    rng = np.random.default_rng(seed)
    P = K * (K - 1)
    coefw = (rng.standard_normal((Wp, J, nF, nE * nM, P)) * 0.05
             ).astype(np.float32)
    base = rng.uniform(0.1, 0.3, (nF, nE, nM)).astype(np.float32)
    obs = (base.reshape(nF, -1)
           + rng.uniform(-0.05, 0.2, (nF, nE * nM))).astype(np.float32)
    return base, coefw, obs


def test_from_jax_null_state_pw_relayout():
    base, coefw, obs = _pw_state(0)
    state = convert.from_jax_null_state_pw(base, coefw, obs, "cpu")
    Wp, J, nF, N, P = coefw.shape
    assert tuple(state.coefT.shape) == (Wp, nF, J * P, N)
    assert state.coefT.is_contiguous()
    for w in range(Wp):
        np.testing.assert_array_equal(
            state.coefT[w].numpy(),
            coefw[w].transpose(1, 0, 3, 2).reshape(nF, J * P, N))
    np.testing.assert_array_equal(state.base_flat.numpy(),
                                  base.reshape(nF, N))
    assert (state.n_subjects, state.n_feats) == (J, P)
    with pytest.raises(ValueError):
        convert.from_jax_null_state_pw(base, coefw[0], obs, "cpu")
    with pytest.raises(ValueError):
        convert.from_jax_null_state_pw(base, coefw, obs[:2], "cpu")


@pytest.mark.parametrize("S,seed", [(20, 1), (13, 2)])
def test_null_chunk_pw_matches_jax_on_the_same_phases(S, seed):
    """``_null_chunk_jit_pw`` draws φ_w from ``fold_in(key, w)``; the
    port's chunk takes the same φ as numpy, one window at a time."""
    base, coefw, obs = _pw_state(seed)
    Wp, J, nF, N, P = coefw.shape
    K = 3
    key = jax.random.PRNGKey(seed)
    ms_ref, c_ref = JN._null_chunk_jit_pw(
        key, jnp.asarray(coefw), jnp.asarray(base.reshape(nF, N)),
        jnp.asarray(obs), jnp.zeros((nF, N), jnp.int32), S, K, jnp.float32)
    phases = [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(key, jnp.uint32(w)), (J, S, K, nF),
        minval=0.0, maxval=2.0 * np.pi))) for w in range(Wp)]
    state = convert.from_jax_null_state_pw(base, coefw, obs, "cpu")
    ms, inc = TN.null_chunk_pw(iter(phases), state)
    np.testing.assert_allclose(ms.numpy(), np.asarray(ms_ref), atol=1e-5)
    np.testing.assert_array_equal(inc.numpy(), np.asarray(c_ref))


def test_window_phases_are_separate_streams():
    key = prng.prng_key(7)
    a = list(TN.window_phases(key, 3, 2, 4, 3, 5, "cpu"))
    b = list(TN.window_phases(key, 3, 2, 4, 3, 5, "cpu"))
    c = list(TN.window_phases(prng.split(key)[1], 3, 2, 4, 3, 5, "cpu"))
    assert len(a) == 3 and tuple(a[0].shape) == (2, 4, 3, 5)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])
    assert all(float(x.min()) >= 0 and float(x.max()) < 2 * np.pi
               for x in a)


# ---- the full-FFT null and the dispatch ----------------------------------

def _fft_setup(J=2, n_sec=12.0):
    eeg, emg = _cohort(J=J, n_sec=n_sec)
    ws = int(2.0 * FS)
    tapers = np.asarray(filtered_tapers(ws, 3, 0.9), np.float32)
    starts, _ = window_grid(eeg.shape[1], ws, ws // 2, FS, "cmc")
    starts = np.tile(starts[None], (J, 1))
    weights = np.ones(starts.shape, np.float32)
    weights[:, ::4] = 0.0
    return eeg, emg, ws, tapers, starts, weights


def test_cohort_msc_map_matches_jax():
    eeg, emg, ws, tapers, starts, weights = _fft_setup()
    lo, hi, wc = 16, 120, 4
    ref = JN._cohort_msc_map(jnp.asarray(eeg), jnp.asarray(emg),
                             jnp.asarray(starts, jnp.int32),
                             jnp.asarray(weights), jnp.asarray(tapers),
                             ws, lo, hi, wc)
    got = TN.cohort_msc_map(torch.from_numpy(eeg), torch.from_numpy(emg),
                            torch.from_numpy(starts),
                            torch.from_numpy(weights),
                            torch.from_numpy(tapers), ws, lo, hi, wc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-6)


def test_fft_surrogate_map_matches_jax_on_the_same_phases():
    """One surrogate: phases on the EMG signal spectrum (DC and Nyquist
    0), irfft, the cohort map — JAX's ``null_chunk`` body
    (``cohort_null.py:606-617``) against the port's, on numpy phases.
    The two irffts differ in rounding only: rtol 1e-4 / atol 1e-5."""
    eeg, emg, ws, tapers, starts, weights = _fft_setup()
    J, n = eeg.shape[:2]
    lo, hi, wc = 16, 120, 8
    rng = np.random.default_rng(3)
    phases = rng.uniform(0, 2 * np.pi, (2, J, n // 2 + 1)).astype(np.float32)
    phases[..., 0] = 0.0
    phases[..., -1] = 0.0
    spec = jnp.fft.rfft(jnp.asarray(emg), axis=1)
    args_j = (jnp.asarray(starts, jnp.int32), jnp.asarray(weights),
              jnp.asarray(tapers), ws, lo, hi, wc)
    ref = []
    for s in range(2):
        surr = jnp.fft.irfft(spec * jnp.exp(1j * phases[s])[..., None], n=n,
                             axis=1)
        ref.append(np.asarray(JN._cohort_msc_map(jnp.asarray(eeg), surr,
                                                 *args_j)).reshape(hi - lo,
                                                                   -1))
    got = TN.fft_surrogate_maps(
        torch.from_numpy(phases), torch.from_numpy(eeg),
        torch.fft.rfft(torch.from_numpy(emg), dim=1),
        torch.from_numpy(starts), torch.from_numpy(weights),
        torch.from_numpy(tapers), ws, lo, hi, wc, n)
    assert tuple(got.shape) == (2, hi - lo, 12)
    np.testing.assert_allclose(got.numpy(), np.stack(ref), rtol=1e-4,
                               atol=1e-5)


def test_fft_null_matches_jax():
    """Observed map over ALL windows against JAX's, the schema, the
    planted coupling detected, and the nulls in distribution."""
    eeg, emg = _cohort(J=2, n_sec=16.0)
    kw = dict(sampling_freq=FS, window_length_sec=2.0, band=(8.0, 60.0),
              n_surrogates=200, surrogate_chunk=25, seed=1)
    ref = JN.cohort_msc_fft_null(eeg, emg, **kw)
    got = TN.cohort_msc_fft_null(eeg, emg, **kw, device="cpu")
    np.testing.assert_allclose(got["observed"], ref["observed"], rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_array_equal(got["freqs"], ref["freqs"])
    for key in ("max_stat", "p_uncorrected"):
        assert got[key].shape == ref[key].shape, key
    assert got["p_fwe"] < 0.01 and ref["p_fwe"] < 0.01
    assert got["observed"].max() > got["null_quantiles"][0.99]
    for key in ("method", "K_tapers", "n_surrogates_drawn", "band_bins",
                "n_subjects"):
        assert got["metadata"][key] == ref["metadata"][key], key
    # the two nulls' medians within 10 % (Monte-Carlo spread at n = 200)
    np.testing.assert_allclose(np.median(got["max_stat"]),
                               np.median(ref["max_stat"]), rtol=0.1)


def test_fft_null_input_validation():
    eeg, emg = _cohort(J=1, n_sec=8.0)
    with pytest.raises(ValueError, match="J, n_samples"):
        TN.cohort_msc_fft_null(eeg[0], emg[0], FS, device="cpu")
    with pytest.raises(ValueError, match="no frequency bins"):
        TN.cohort_msc_fft_null(eeg, emg, FS, band=(200.0, 300.0),
                               window_length_sec=0.25, device="cpu")


@pytest.mark.parametrize("method,budget,run", [
    ("auto", 1e30, "fft"), ("auto", 1.0, "rotation"),
    ("fft", None, "fft"), ("rotation", None, "rotation"),
    ("auto", None, "fft"),          # the CPU default budget, 2e11
])
def test_cohort_msc_null_engine_choice_matches_jax(method, budget, run):
    eeg, emg = _cohort(J=2, n_sec=8.0)
    kw = dict(window_length_sec=2.0, band=(8.0, 60.0), n_surrogates=40,
              surrogate_chunk=20, coeff_engine="gram",
              p_value_windows="disjoint")
    ref = JN.cohort_msc_null(eeg, emg, FS, method=method,
                             fft_flop_budget=budget, **kw)
    got = TN.cohort_msc_null(eeg, emg, FS, method=method,
                             fft_flop_budget=budget, **kw, device="cpu")
    choice, ref_choice = (r["metadata"]["engine_choice"] for r in (got, ref))
    assert choice == ref_choice
    assert choice["method_run"] == run
    if method == "auto" and budget is None:
        assert choice["fft_flop_budget"] == TN.FFT_FLOP_BUDGET["cpu"] == 2e11
    meta = got["metadata"]
    if run == "fft":
        assert meta["method"] == "full_fft_phase_randomization"
        assert meta["dropped_rotation_kwargs"] == \
            ref["metadata"]["dropped_rotation_kwargs"] == \
            ["p_value_windows", "coeff_engine"]
        assert "sensitivity_note" not in meta
    else:
        assert meta["method"] == "taper_rotation"
        assert meta["sensitivity_note"] == ref["metadata"]["sensitivity_note"]
    sc = float(np.abs(ref["observed"]).max())
    np.testing.assert_allclose(got["observed"], ref["observed"], rtol=2e-4,
                               atol=2e-5 * sc)


def test_cohort_msc_null_rejects_unknown_method():
    eeg, emg = _cohort(J=1, n_sec=8.0)
    with pytest.raises(ValueError, match="method"):
        TN.cohort_msc_null(eeg, emg, FS, method="bogus", device="cpu")
