"""Parity of the port's cohort rotation null (``mba_tpu_torch``) with
``mba_tpu``: the gram coefficient pass, the phase features, the
surrogate chunk (plain, and through the wrapper of kernel B2, which runs
its plain version on CPU tensors) against the XLA core and the Pallas
kernel in interpret mode, the relayout of ``convert.from_jax_null_state``,
and ``cohort_msc_rotation_null`` as a whole.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mba_tpu.ops import cohort_null as JN
from mba_tpu.ops.dpss import filtered_tapers
from mba_tpu.ops.framing import window_grid
from mba_tpu.ops.gram_coeffs import gram_coeffs_subject as jax_gram
from mba_tpu.ops.pallas_null import null_chunk_pallas, prepare_null_coeffs

from mba_tpu_torch import convert
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.ops import cuda_null
from mba_tpu_torch.ops.gram_coeffs import gram_coeffs_subject as port_gram

from _torch_parity import (NULL_UPLOAD_KEYS, cohort_subject, jax_phases,
                           null_across_upload_paths, null_toy, t32)

torch.set_num_threads(1)

FS = 256.0


def _gram_inputs(seed, weighted=False):
    eeg, emg = cohort_subject(seed)
    ws = int(2.0 * FS)
    tapers = np.asarray(filtered_tapers(ws, 3, 0.9), np.float32)
    starts, _ = window_grid(eeg.shape[0], ws, ws // 2, FS)
    weights = np.ones(starts.shape[0], np.float32)
    if weighted:
        rng = np.random.default_rng(2)
        weights = rng.uniform(0.2, 1.5, starts.shape[0]).astype(np.float32)
        weights[::3] = 0.0
    return eeg, emg, starts, weights, tapers, ws


@pytest.mark.parametrize("spectra,weighted,gram_chunk", [
    ("dft", False, 512), ("fft", False, 512),
    ("dft", True, 5),      # masked windows + a chunk that pads
])
def test_gram_coeffs_match_jax(spectra, weighted, gram_chunk):
    eeg, emg, starts, weights, tapers, ws = _gram_inputs(0, weighted)
    lo, hi = 8, 60
    b_ref, c_ref = jax_gram(
        jnp.asarray(eeg), jnp.asarray(emg), jnp.asarray(starts, jnp.int32),
        jnp.asarray(weights), jnp.asarray(tapers), ws, lo, hi,
        gram_chunk=gram_chunk, spectra=spectra)
    b, c = port_gram(torch.from_numpy(eeg), torch.from_numpy(emg),
                     torch.from_numpy(starts), torch.from_numpy(weights),
                     torch.from_numpy(tapers), ws, lo, hi,
                     gram_chunk=gram_chunk, spectra=spectra)
    assert tuple(b.shape) == b_ref.shape and tuple(c.shape) == c_ref.shape
    sc = float(np.abs(np.asarray(c_ref)).max())
    # tests/test_gram_coeffs.py:65-68
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref),
                               rtol=2e-3, atol=2e-4 * sc)


def test_phase_features_match_jax():
    phi = jax_phases(1, 2, 5, 5, 7)
    ref = JN.phase_features(jnp.asarray(phi))
    got = TN.phase_features(torch.from_numpy(phi))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("S,N,seed", [(20, 512, 0), (13, 256, 1)])
def test_null_chunk_core_matches_xla_core(S, N, seed):
    J, nF, K = 3, 4, 3
    coef, base, obs = null_toy(J, nF, N, K, seed)
    key = jax.random.PRNGKey(7 + seed)
    ms_ref, c_ref = JN._null_chunk_core(
        key, jnp.asarray(coef), jnp.asarray(base), jnp.asarray(obs),
        jnp.zeros((nF, N), jnp.int32), S, K, jnp.float32)
    phi = jax_phases(7 + seed, J, S, K, nF)    # the same draws
    ms, c = TN._null_chunk_core(torch.from_numpy(phi), t32(coef), t32(base),
                                t32(obs), torch.zeros((nF, N),
                                                      dtype=torch.int32))
    assert tuple(ms.shape) == (S,)
    np.testing.assert_allclose(ms.numpy(), np.asarray(ms_ref), atol=1e-5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("S,N,seed", [(20, 512, 2), (13, 256, 3)])
def test_null_chunk_matches_pallas_interpret(S, N, seed):
    """Through the B2 wrapper (plain version on CPU) from a state carried
    over from JAX's arrays, against the Pallas kernel; S=13 leaves
    padded rows in the Pallas tile that must not count."""
    J, nF, K = 2, 3, 3
    P = K * (K - 1)
    coef, base, obs = null_toy(J, nF, N, K, seed)
    key = jax.random.PRNGKey(seed)
    coefT = prepare_null_coeffs(jnp.asarray(coef), jnp.float32)
    ms_ref, c_ref = null_chunk_pallas(key, coefT, jnp.asarray(base),
                                      jnp.asarray(obs), S, K, J, P,
                                      jnp.float32, interpret=True)
    state = convert.from_jax_null_state(base, coef, obs, "cpu")
    before = cuda_null.null_tile.launches
    ms, c = TN.null_chunk(torch.from_numpy(jax_phases(seed, J, S, K, nF)),
                          state)
    assert cuda_null.null_tile.launches == before
    np.testing.assert_allclose(ms.numpy(), np.asarray(ms_ref), atol=1e-5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


def test_from_jax_null_state_relayout():
    J, nF, N, K = 3, 4, 512, 3
    coef, base, obs = null_toy(J, nF, N, K, seed=4)
    ref = np.asarray(prepare_null_coeffs(jnp.asarray(coef), jnp.float32))
    state = convert.from_jax_null_state(base, coef, obs, "cpu")
    JP = J * K * (K - 1)
    got = state.coefT.numpy()
    assert got.shape == (nF, JP, N) and state.coefT.is_contiguous()
    np.testing.assert_array_equal(got, ref[:, :JP])
    assert np.all(ref[:, JP:] == 0.0)       # the TPU layout's zero pad
    np.testing.assert_array_equal(state.observed_flat.numpy(), obs)
    assert (state.n_subjects, state.n_feats) == (J, K * (K - 1))
    tapers = filtered_tapers(256, 3, 0.9)
    np.testing.assert_array_equal(
        convert.tapers_from_jax(tapers, "cpu").numpy(),
        tapers.astype(np.float32))


def test_disjoint_window_weights():
    starts = np.tile(np.arange(9, dtype=np.int64)[None] * 256, (2, 1))
    weights = np.ones(starts.shape, np.float32)
    weights[1, 0] = 0.0                 # a masked window blocks nothing
    got = TN.disjoint_window_weights(starts, weights, 512)
    np.testing.assert_array_equal(got[0], [1, 0, 1, 0, 1, 0, 1, 0, 1])
    np.testing.assert_array_equal(got[1], [0, 1, 0, 1, 0, 1, 0, 1, 0])


def _cohort(J=3, n_sec=24.0, couple=2.0):
    # the shared-rotation null is conservative under coupling: at 24 s a
    # 0.4 drive gives p_fwe ~0.8, a 2.0 drive ~5e-4 (port and JAX alike)
    subj = [cohort_subject(10 + j, n_sec=n_sec, couple=couple)
            for j in range(J)]
    return (np.stack([s[0] for s in subj]), np.stack([s[1] for s in subj]))


KW = dict(sampling_freq=FS, window_length_sec=2.0, band=(8.0, 60.0),
          surrogate_chunk=500, seed=5)


def test_rotation_null_slice_matches_jax():
    """The slice as a whole on a 3-subject toy with planted 21 Hz
    coupling, the nulls compared in distribution (the gram engine's
    observed map differs at rtol 2e-4; ``tests/test_torch_prng.py`` holds
    the draws themselves to the JAX package's): the JAX 0.95 quantile of
    max_stat must lie between the port's quantiles at 0.95 ± 3·sqrt(2·0.95·0.05/n) — a
    distribution-free 3-sigma bound for two samples of n = 2000."""
    eeg, emg = _cohort()
    n = 2000
    ref = JN.cohort_msc_rotation_null(eeg, emg, n_surrogates=n,
                                      compute_dtype=jnp.float32, **KW)
    got = TN.cohort_msc_rotation_null(eeg, emg, n_surrogates=n,
                                      device="cpu", **KW)
    sc = float(np.abs(ref["observed"]).max())
    np.testing.assert_allclose(got["observed"], ref["observed"],
                               rtol=2e-4, atol=2e-5 * sc)
    np.testing.assert_array_equal(got["freqs"], ref["freqs"])
    assert got["max_stat"].shape == ref["max_stat"].shape == (n,)
    assert got["p_uncorrected"].shape == ref["p_uncorrected"].shape
    assert got["p_fwe"] < 0.01 and ref["p_fwe"] < 0.01
    half = 3.0 * np.sqrt(2 * 0.95 * 0.05 / n)
    lo_q, hi_q = np.quantile(got["max_stat"], [0.95 - half, 0.95 + half])
    assert lo_q <= ref["null_quantiles"][0.95] <= hi_q
    for key in ("method", "K_tapers", "n_surrogates_drawn", "n_surrogates",
                "band", "band_bins", "n_subjects", "rotation_mode",
                "compute_dtype", "contraction_flops"):
        assert got["metadata"][key] == ref["metadata"][key], key
    for key in ("precompute_sec", "null_sec", "coeffs_sec", "upload_bytes"):
        assert key in got["metadata"]["timings"]


def test_rotation_null_precompute_only_and_adc_passthrough():
    eeg, emg = _cohort(J=2, n_sec=12.0)
    q = 2.0 ** 12
    eeg_i = np.round(eeg * q / np.abs(eeg).max(axis=(0, 1))).astype(np.int16)
    emg_i = np.round(emg * q / np.abs(emg).max(axis=(0, 1))).astype(np.int16)
    ref = JN.cohort_msc_rotation_null(eeg_i.astype(np.float32),
                                      emg_i.astype(np.float32),
                                      precompute_only=True, **KW)
    got = TN.cohort_msc_rotation_null(eeg_i, emg_i, transfer_dtype=np.int16,
                                      precompute_only=True, **KW, device="cpu")
    assert "max_stat" not in got
    sc = float(np.abs(ref["observed"]).max())
    np.testing.assert_allclose(got["observed"], ref["observed"],
                               rtol=2e-4, atol=2e-5 * sc)
    assert got["metadata"]["timings"]["coeff_engine"] == "gram"


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_unsupported_options_raise(kw):
    eeg, emg = _cohort(J=1, n_sec=8.0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        TN.cohort_msc_rotation_null(eeg, emg, FS, n_surrogates=10,
                                    device="cpu", **kw)


JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.mark.parametrize("overlap_upload", [True, False])
@pytest.mark.parametrize("transfer_dtype", [np.int16, np.int8, np.float16])
def test_rotation_null_transfer_dtype_matches_jax(transfer_dtype,
                                                  overlap_upload):
    """``transfer_dtype`` on a float cohort, held against the JAX
    package's per-subject and whole-cohort uploads (the port has the
    per-subject one only): the host conversion is the JAX package's
    (``native.quantize_*_per_channel``, bit for bit in
    ``tests/test_torch_transfer.py``), so the port equals itself run on
    the converted cohort widened to float32, and the JAX package within
    the gram engine's tolerance (the observed maps and, at one seed, the
    maxima), with ``p_fwe`` and the upload bytes equal."""
    eeg, emg = _cohort(J=2, n_sec=12.0)
    kw = dict(KW, n_surrogates=200)
    ref = JN.cohort_msc_rotation_null(eeg, emg, transfer_dtype=transfer_dtype,
                                      compute_dtype=jnp.float32,
                                      overlap_upload=overlap_upload, **kw)
    got = TN.cohort_msc_rotation_null(eeg, emg, transfer_dtype=transfer_dtype,
                                      device="cpu", **kw)
    conv = TN.upload_quantizer(transfer_dtype, eeg, emg)
    # int16/int8 convert to numpy, float16 to a CPU tensor
    wide = TN.cohort_msc_rotation_null(
        *(np.stack([torch.as_tensor(conv(x)).float().numpy() for x in xs])
          for xs in (eeg, emg)), device="cpu", **kw)
    np.testing.assert_array_equal(got["observed"], wide["observed"])
    np.testing.assert_array_equal(got["max_stat"], wide["max_stat"])
    sc = float(np.abs(ref["observed"]).max())
    for key in ("observed", "max_stat"):
        np.testing.assert_allclose(got[key], ref[key], rtol=2e-4,
                                   atol=2e-5 * sc, err_msg=key)
    assert got["p_fwe"] == ref["p_fwe"] < 0.01
    t_got, t_ref = got["metadata"]["timings"], ref["metadata"]["timings"]
    assert t_got["upload_bytes"] == t_ref["upload_bytes"] == \
        (eeg.size + emg.size) * np.dtype(transfer_dtype).itemsize
    assert "quantize_sec" in t_got and "quantize_sec" in t_ref


@pytest.mark.parametrize("rotation_mode", ["shared", "per_window"])
@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float16])
def test_rotation_null_compute_dtype_matches_jax(compute_dtype,
                                                 rotation_mode):
    """The contraction on 16-bit operands with float32 sums, end to end:
    the observed map is the float32 pass's (the gram tolerance), the
    maxima at one seed within the gram tolerance, ``p_fwe`` equal, and
    the metadata names the type as the JAX package does."""
    eeg, emg = _cohort(J=2, n_sec=12.0)
    kw = dict(KW, n_surrogates=200, rotation_mode=rotation_mode)
    ref = JN.cohort_msc_rotation_null(
        eeg, emg, compute_dtype=JAX_DTYPES[compute_dtype], **kw)
    got = TN.cohort_msc_rotation_null(eeg, emg, compute_dtype=compute_dtype,
                                      device="cpu", **kw)
    sc = float(np.abs(ref["observed"]).max())
    for key in ("observed", "max_stat"):
        np.testing.assert_allclose(got[key], ref[key], rtol=2e-4,
                                   atol=2e-5 * sc, err_msg=key)
    assert got["p_fwe"] == ref["p_fwe"]
    assert got["metadata"]["compute_dtype"] == \
        ref["metadata"]["compute_dtype"] == str(compute_dtype)[6:]


def _count_ties(coef, base, obs, phi, cdtype, J):
    """Cells where some surrogate's statistic lies within 1e-5 of the
    observed one: there the rounding of the sums may move a count."""
    G = cuda_null.null_features(TN.phase_features(torch.from_numpy(phi)),
                                cdtype)
    rows = G[..., :phi.shape[1]].transpose(1, 2).float()
    coefT = cuda_null.prepare_null_coeffs(t32(coef), cdtype).float()
    stat = t32(base)[:, None, :] + torch.bmm(rows, coefT) / J
    return ((stat - t32(obs)[:, None, :]).abs() <= 1e-5).any(dim=1).numpy()


@pytest.mark.parametrize("engine", ["core", "pallas"])
@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float16])
def test_null_chunk_reduced_precision_matches_jax(compute_dtype, engine):
    """One chunk on 16-bit operands: the plain core against the XLA core,
    and through the B2 wrapper against the Pallas kernel in interpret
    mode, on the same φ: maxima within rtol 1e-5, counts equal but in
    cells whose statistic lies within 1e-5 of the observed one."""
    J, nF, N, K, S, seed = 3, 4, 512, 3, 20, 5
    P = K * (K - 1)
    jd = JAX_DTYPES[compute_dtype]
    coef, base, obs = null_toy(J, nF, N, K, seed)
    key = jax.random.PRNGKey(seed)
    phi = jax_phases(seed, J, S, K, nF)
    if engine == "core":
        ms_ref, c_ref = JN._null_chunk_core(
            key, jnp.asarray(coef), jnp.asarray(base), jnp.asarray(obs),
            jnp.zeros((nF, N), jnp.int32), S, K, jd)
        ms, c = TN._null_chunk_core(torch.from_numpy(phi), t32(coef),
                                    t32(base), t32(obs),
                                    torch.zeros((nF, N), dtype=torch.int32),
                                    compute_dtype)
    else:
        ms_ref, c_ref = null_chunk_pallas(
            key, prepare_null_coeffs(jnp.asarray(coef), jd),
            jnp.asarray(base), jnp.asarray(obs), S, K, J, P, jd,
            interpret=True)
        state = TN.null_state(t32(base), t32(coef), t32(obs), compute_dtype)
        assert state.coefT.dtype == compute_dtype
        ms, c = TN.null_chunk(torch.from_numpy(phi), state)
    np.testing.assert_allclose(ms.numpy(), np.asarray(ms_ref), rtol=1e-5)
    ties = _count_ties(coef, base, obs, phi, compute_dtype, J)
    differ = c.numpy() != np.asarray(c_ref)
    assert not (differ & ~ties).any()


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float16])
def test_null_chunk_pw_reduced_precision_matches_jax(compute_dtype):
    """The per-window chunk on 16-bit operands (``_null_chunk_jit_pw``):
    the same keys give the same φ per window, maxima within rtol 1e-5 and
    counts equal."""
    Wp, J, nF, N, K, S = 3, 2, 4, 256, 3, 16
    rng = np.random.default_rng(6)
    P = K * (K - 1)
    coefw = (0.05 * rng.standard_normal((Wp, J, nF, N, P))).astype(
        np.float32)
    base = (0.1 + 0.2 * rng.random((nF, N))).astype(np.float32)
    obs = (base + 0.05 * rng.standard_normal((nF, N))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ms_ref, c_ref = JN._null_chunk_jit_pw(
        key, jnp.asarray(coefw), jnp.asarray(base), jnp.asarray(obs),
        jnp.zeros((nF, N), jnp.int32), S, K, JAX_DTYPES[compute_dtype])
    state = TN.null_state(t32(base), t32(coefw), t32(obs), compute_dtype)
    ms, c = TN.null_chunk_pw(
        TN.window_phases(np.asarray(key), Wp, J, S, K, nF, "cpu"), state)
    np.testing.assert_allclose(ms.numpy(), np.asarray(ms_ref), rtol=1e-5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("N", [100, 512])
@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float16])
def test_prepare_null_coeffs_pads_16bit_cells(compute_dtype, N):
    """The 16-bit coefT's cell axis, padded with zeros to a multiple of 8
    (the tensor-core kernel's 16-byte TMA rows): its first N cells are
    the JAX package's relayout rounded to the same type (which pads J·P
    instead), in the shared and the per-window layout; float32 stays
    unpadded."""
    J, nF, K = 3, 4, 3
    JP, ldc = J * K * (K - 1), -(-N // 8) * 8
    coef, _, _ = null_toy(J, nF, N, K, seed=7)
    ref = np.asarray(prepare_null_coeffs(
        jnp.asarray(coef), JAX_DTYPES[compute_dtype]).astype(jnp.float32))
    got = cuda_null.prepare_null_coeffs(t32(coef), compute_dtype)
    assert tuple(got.shape) == (nF, JP, ldc) and got.is_contiguous()
    assert got.dtype == compute_dtype
    np.testing.assert_array_equal(got[..., :N].float().numpy(), ref[:, :JP])
    assert not bool(got[..., N:].any())
    pw = cuda_null.prepare_null_coeffs(t32(np.stack([coef, 2 * coef])),
                                       compute_dtype)
    assert tuple(pw.shape) == (2, nF, JP, ldc) and pw.is_contiguous()
    assert torch.equal(pw[0], got) and torch.equal(
        pw[1], cuda_null.prepare_null_coeffs(t32(2 * coef), compute_dtype))
    assert tuple(cuda_null.prepare_null_coeffs(t32(coef)).shape) == \
        (nF, JP, N)


@pytest.mark.parametrize("engine", ["core", "pallas"])
@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float16])
def test_null_chunk_16bit_padded_cells_match_jax(compute_dtype, engine):
    """One 16-bit chunk at N = 100 (coefT padded to 104 cells, the pad
    never read) and S = 13 (G padded to 16 rows): the plain core against
    the XLA core, and the B2 wrapper against the Pallas kernel in
    interpret mode, on the same φ; maxima within rtol 1e-5, counts equal
    but in cells whose statistic lies within 1e-5 of the observed one."""
    J, nF, N, K, S, seed = 3, 4, 100, 3, 13, 8
    P = K * (K - 1)
    jd = JAX_DTYPES[compute_dtype]
    coef, base, obs = null_toy(J, nF, N, K, seed)
    key = jax.random.PRNGKey(seed)
    phi = jax_phases(seed, J, S, K, nF)
    if engine == "core":
        ms_ref, c_ref = JN._null_chunk_core(
            key, jnp.asarray(coef), jnp.asarray(base), jnp.asarray(obs),
            jnp.zeros((nF, N), jnp.int32), S, K, jd)
        ms, c = TN._null_chunk_core(torch.from_numpy(phi), t32(coef),
                                    t32(base), t32(obs),
                                    torch.zeros((nF, N), dtype=torch.int32),
                                    compute_dtype)
    else:
        ms_ref, c_ref = null_chunk_pallas(
            key, prepare_null_coeffs(jnp.asarray(coef), jd),
            jnp.asarray(base), jnp.asarray(obs), S, K, J, P, jd,
            interpret=True)
        state = TN.null_state(t32(base), t32(coef), t32(obs), compute_dtype)
        assert tuple(state.coefT.shape) == (nF, J * P, 104)
        ms, c = TN.null_chunk(torch.from_numpy(phi), state)
    assert tuple(c.shape) == (nF, N) and tuple(ms.shape) == (S,)
    np.testing.assert_allclose(ms.numpy(), np.asarray(ms_ref), rtol=1e-5)
    G = cuda_null.null_features(TN.phase_features(torch.from_numpy(phi)),
                                compute_dtype)
    rows = G[..., :S].transpose(1, 2).float()
    coefT = cuda_null.prepare_null_coeffs(t32(coef), compute_dtype)
    stat = t32(base)[:, None, :] + torch.bmm(rows, coefT[..., :N].float()) / J
    ties = ((stat - t32(obs)[:, None, :]).abs() <= 1e-5).any(dim=1).numpy()
    differ = c.numpy() != np.asarray(c_ref)
    assert not (differ & ~ties).any()


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float16])
def test_null_chunk_pw_16bit_padded_cells_match_jax(compute_dtype):
    """The per-window chunk on a 16-bit state whose cell axis is padded
    (N = 100 → 104): the same φ per window as ``_null_chunk_jit_pw``,
    maxima within rtol 1e-5 and counts equal."""
    Wp, J, nF, N, K, S = 2, 2, 3, 100, 3, 16
    rng = np.random.default_rng(9)
    P = K * (K - 1)
    coefw = (0.05 * rng.standard_normal((Wp, J, nF, N, P))).astype(
        np.float32)
    base = (0.1 + 0.2 * rng.random((nF, N))).astype(np.float32)
    obs = (base + 0.05 * rng.standard_normal((nF, N))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ms_ref, c_ref = JN._null_chunk_jit_pw(
        key, jnp.asarray(coefw), jnp.asarray(base), jnp.asarray(obs),
        jnp.zeros((nF, N), jnp.int32), S, K, JAX_DTYPES[compute_dtype])
    state = TN.null_state(t32(base), t32(coefw), t32(obs), compute_dtype)
    assert tuple(state.coefT.shape) == (Wp, nF, J * P, 104)
    ms, c = TN.null_chunk_pw(
        TN.window_phases(np.asarray(key), Wp, J, S, K, nF, "cpu"), state)
    np.testing.assert_allclose(ms.numpy(), np.asarray(ms_ref), rtol=1e-5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


@pytest.mark.cuda
@pytest.mark.parametrize("coeff_engine", ["auto", "pallas"])
def test_null_results_do_not_depend_on_the_upload_path(coeff_engine):
    """On the card, the null's results are bit for bit the same whether
    its cohort goes up by the plain copy or through the staging ring,
    each subject under the previous subject's pass, in the shared and
    the per-window rotation mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: nothing is staged on the CPU")
    runs = null_across_upload_paths("cuda", coeff_engine)
    for mode in ("shared", "per_window"):
        plain, staged = runs[f"plain_{mode}"], runs[f"staged_{mode}"]
        assert "upload.staged_bytes" not in plain["counters"]
        c = staged["counters"]
        assert c["upload.staged_bytes"] == c["upload.bytes"] > 0
        for key in NULL_UPLOAD_KEYS:
            np.testing.assert_array_equal(staged[key], plain[key],
                                          err_msg=f"{mode} {key}")
