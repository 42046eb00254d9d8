"""Parity of the port's multi-device layer (``mba_tpu_torch.parallel`` and
the nulls' ``mesh=``) with ``mba_tpu.parallel`` and the JAX nulls' mesh.

The port runs as 2 or 4 gloo CPU ranks (``tests/_torch_mesh.py``: spawned
processes, a ``FileStore`` under ``tmp_path``, a 60-s process-group
timeout and a bounded join); the JAX package on ``make_mesh(n)`` over the
conftest's virtual CPU devices, on the same numpy inputs.  Tolerances:
coherence and CIs atol 5e-5 (``tests/test_torch_coherence.py``); the
rotation null's ``max_stat`` atol 1e-5 with counts and ``p_fwe`` equal
(``tests/test_torch_cohort_null.py``); the phase null as
``tests/test_torch_surrogate.py`` states it.  Every rank returns the
whole result, and the ranks' results are equal.
"""
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax.numpy as jnp

from mba_tpu.ops import cohort_null as JN
from mba_tpu.ops import surrogate as JS
from mba_tpu.parallel import cohort as JP
from mba_tpu.parallel.mesh import make_mesh as jax_mesh

from mba_tpu_torch.ops import surrogate as TS
from mba_tpu_torch.parallel import mesh as TM

import _torch_mesh as M

torch.set_num_threads(1)

FS = M.FS
MSC_ATOL = 5e-5
NULL_ATOL = 1e-5
OBS_ATOL = 5e-5
MAX_RTOL, MAX_ATOL = 1e-4, 5e-5
QUANTILE_CELLS = 1e-3
CMC_KEYS = ("coherence_raw", "coherence_ci_lower", "coherence_ci_upper")


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh2")
    return M.run_ranks(M.two_rank_cases, 2, d, str(d / "artifacts"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return M.run_ranks(M.four_rank_cases, 4, tmp_path_factory.mktemp("m4"))


# a span record's start and end seconds ([name, parent, start, end])
_SPAN_TIMES = re.compile(r"\.spans\[\d+\]\[[23]\]$")


def _assert_ranks_equal(results, key):
    """Every rank returns the same result (arrays bit for bit), times
    aside: the ``_sec`` keys and the span records' seconds."""
    def walk(a, b, where):
        if isinstance(a, dict):
            assert set(a) == set(b), where
            for k in a:
                walk(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}[{i}]")
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=where)
        elif key != "timings" and not where.endswith("_sec") \
                and not _SPAN_TIMES.search(where):
            assert a == b, where
    for other in results[1:]:
        walk(results[0][key], other[key], key)


def _assert_cmc_close(got, ref):
    for k in CMC_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=MSC_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["cohort_mean"], ref["cohort_mean"],
                               rtol=0, atol=MSC_ATOL)
    np.testing.assert_array_equal(got["freqs"], ref["freqs"])
    np.testing.assert_array_equal(got["time_centers"], ref["time_centers"])


# ---- the mesh ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_default_factorisation_is_jax_s(n):
    assert TM.default_axis_shapes(n) == dict(jax_mesh(n).shape)


@pytest.mark.parametrize("ranks", [2, 4])
def test_make_mesh_layout_and_sharding(two, four, ranks):
    results = two if ranks == 2 else four
    shape = tuple(jax_mesh(ranks).devices.shape)
    for r, res in enumerate(results):
        assert res["mesh_shape"] == shape
        assert res["sharding"] == TM.CohortSharding(
            coordinate=(r // shape[1], r % shape[1]), shape=shape)
    assert two[0]["mesh_names"] == ("subjects", "windows")


def test_make_mesh_needs_a_process_group_and_a_card():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        TM.make_mesh(device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_type"):
            TM.rank_device("cuda")
    with pytest.raises(ValueError, match="device_type"):
        TM.rank_device("tpu")


# ---- cohort_multitaper_msc --------------------------------------------------

@pytest.mark.parametrize("emg_max", [False, True])
def test_cohort_cmc_matches_jax_with_subject_padding(two, emg_max):
    """J = 3 on a (2, 1) mesh: the last subject is tiled once."""
    key = f"cohort_emg_max={emg_max}"
    got = two[0][key]
    eeg, emg = M.cohort_signals(3)
    ref = JP.cohort_multitaper_msc(jax_mesh(2), eeg, emg, FS,
                                   aggregate_emg_max=emg_max, **M.CMC_KW)
    _assert_cmc_close(got, ref)
    assert got["metadata"] == ref["metadata"]
    assert got["metadata"]["mesh"] == {"subjects": 2, "windows": 1}
    _assert_ranks_equal(two, key)


@pytest.mark.parametrize("output", ["full", "compact"])
def test_masked_cohort_cmc_matches_jax(two, output):
    masks = two[0]["masks"]
    eeg, emg = M.cohort_signals(3, seconds=6.0, seed=1)
    kw = dict(window_masks=masks, output=output, **M.CMC_KW)
    ref = JP.cohort_multitaper_msc(jax_mesh(2), eeg, emg, FS, **kw)
    key = f"masked_{output}"
    got = two[0][key]
    assert got["metadata"] == ref["metadata"]
    if output == "full":
        _assert_cmc_close(got, ref)
        for j in range(3):
            assert np.all(got["coherence_raw"][j][~masks[j]] == 0)
    else:
        np.testing.assert_allclose(got["cohort_mean"], ref["cohort_mean"],
                                   rtol=0, atol=MSC_ATOL)
        for g, r in zip(got["subjects"], ref["subjects"]):
            np.testing.assert_array_equal(g["active_windows"],
                                          r["active_windows"])
            for k in ("coherence", "ci_lower", "ci_upper"):
                np.testing.assert_allclose(g[k], r[k], rtol=0,
                                           atol=MSC_ATOL)
    _assert_ranks_equal(two, key)


def test_compact_artifacts_are_written_once(two, tmp_path_factory):
    """With ``artifact_dir`` flat rank 0 writes one file a subject and
    every rank returns its paths; each file holds the compact result."""
    got = two[0]["masked_artifacts"]
    _assert_ranks_equal(two, "masked_artifacts")
    compact = two[0]["masked_compact"]
    paths = [s["path"] for s in got["subjects"]]
    assert len(set(paths)) == 3 and all(p.endswith(".npz") for p in paths)
    for path, sub, ref in zip(paths, got["subjects"], compact["subjects"]):
        loaded = np.load(path)
        np.testing.assert_array_equal(loaded["coherence"], ref["coherence"])
        np.testing.assert_array_equal(loaded["active_windows"],
                                      sub["active_windows"])
        assert "freqs" in loaded and "time_centers" in loaded


def test_all_masked_out_is_zero(two):
    res = two[0]["all_masked"]
    assert np.all(res["coherence_raw"] == 0)
    assert np.all(res["cohort_mean"] == 0)


def test_cohort_cmc_on_a_2x2_mesh_matches_jax(four):
    """A windows axis of 2: each subject's active windows are split over
    two ranks and gathered back."""
    masks = four[0]["masks"]
    eeg, emg = M.cohort_signals(3, seconds=6.0, seed=1)
    ref = JP.cohort_multitaper_msc(jax_mesh(4), eeg, emg, FS,
                                   aggregate_emg_max=True,
                                   window_masks=masks, **M.CMC_KW)
    got = four[0]["cohort"]
    _assert_cmc_close(got, ref)
    assert got["metadata"]["mesh"] == {"subjects": 2, "windows": 2}
    _assert_ranks_equal(four, "cohort")


# ---- time_sharded_msc -------------------------------------------------------

@pytest.mark.parametrize("overlap", M.TIME_OVERLAPS)
def test_time_sharded_matches_jax(two, overlap):
    eeg, emg = M.time_signals()
    ref = JP.time_sharded_msc(jax_mesh(2), eeg, emg, FS, overlap_frac=overlap,
                              **M.CMC_KW)
    key = f"time_overlap={overlap}"
    got = two[0][key]
    for k in CMC_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=MSC_ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got["time_centers"], ref["time_centers"])
    assert got["metadata"] == ref["metadata"]
    assert got["metadata"]["halo_samples"] == int(FS * overlap)
    _assert_ranks_equal(two, key)


def test_time_sharded_on_4_ranks_matches_jax(four):
    eeg, emg = M.time_signals()
    ref = JP.time_sharded_msc(jax_mesh(4), eeg, emg, FS, overlap_frac=0.5,
                              **M.CMC_KW)
    got = four[0]["time"]
    for k in CMC_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=MSC_ATOL)
    assert got["metadata"] == ref["metadata"]
    assert got["metadata"]["n_time_shards"] == 4
    _assert_ranks_equal(four, "time")


def test_time_shard_shorter_than_its_halo_raises(two):
    """448 samples, 1-s windows at 75 % overlap, 2 shards of 128 samples
    against a 192-sample halo: the port refuses, the JAX function fails
    in broadcasting."""
    assert two[0]["time_halo_error"].startswith("ValueError: each of the 2")
    eeg, emg = M.time_signals()
    with pytest.raises(ValueError):
        JP.time_sharded_msc(jax_mesh(2), eeg[:448], emg[:448], FS,
                            overlap_frac=0.75, window_chunk=1, **M.CMC_KW)


# ---- the nulls' mesh= -------------------------------------------------------

@pytest.mark.parametrize("engine", ["gram", "pallas"])
def test_rotation_null_matches_jax_mesh(two, engine):
    """Subject-sharded pass (J = 3 on 2 ranks: one pad subject), 48
    surrogates in rounds of 2 × 16, rank r drawing from split(sub, 2)[r]
    as the JAX mesh does.  JAX runs ``'pallas'`` as its XLA pass on the
    CPU; the port runs kernel B3's plain version."""
    eeg, emg = M.cohort_signals(3, seconds=8.0, seed=6)
    ref = JN.cohort_msc_rotation_null(eeg, emg, FS, mesh=jax_mesh(2),
                                      coeff_engine=engine,
                                      compute_dtype=np.float32, **M.ROT_KW)
    got = two[0][f"rotation_{engine}"]
    sc = float(np.abs(ref["observed"]).max())
    np.testing.assert_allclose(got["observed"], ref["observed"], rtol=2e-4,
                               atol=2e-5 * sc)
    assert got["max_stat"].shape == ref["max_stat"].shape == (48,)
    np.testing.assert_allclose(got["max_stat"], ref["max_stat"], rtol=0,
                               atol=NULL_ATOL)
    np.testing.assert_array_equal(got["p_uncorrected"],
                                  ref["p_uncorrected"])
    assert got["p_fwe"] == ref["p_fwe"]
    for key in ("n_surrogates_drawn", "n_subjects", "band_bins",
                "contraction_flops"):
        assert got["metadata"][key] == ref["metadata"][key], key
    assert got["metadata"]["timings"]["coeffs_shard_devices"] == 2
    _assert_ranks_equal(two, f"rotation_{engine}")


def test_rotation_null_int16_upload_and_bf16_match_jax_mesh(two):
    """``transfer_dtype=np.int16`` on the float cohort (each rank
    quantizes only its own subjects) and ``compute_dtype`` bf16 under the
    mesh, against the JAX mesh with the same options: the observed map
    within the gram tolerance, maxima within 1e-5, counts and ``p_fwe``
    equal."""
    eeg, emg = M.cohort_signals(3, seconds=8.0, seed=6)
    ref = JN.cohort_msc_rotation_null(eeg, emg, FS, mesh=jax_mesh(2),
                                      transfer_dtype=np.int16,
                                      compute_dtype=jnp.bfloat16,
                                      **M.ROT_KW)
    got = two[0]["rotation_int16_bf16"]
    sc = float(np.abs(ref["observed"]).max())
    np.testing.assert_allclose(got["observed"], ref["observed"], rtol=2e-4,
                               atol=2e-5 * sc)
    np.testing.assert_allclose(got["max_stat"], ref["max_stat"], rtol=0,
                               atol=NULL_ATOL)
    np.testing.assert_array_equal(got["p_uncorrected"],
                                  ref["p_uncorrected"])
    assert got["p_fwe"] == ref["p_fwe"]
    assert got["metadata"]["compute_dtype"] == "bfloat16"
    assert "quantize_sec" in got["metadata"]["timings"]
    _assert_ranks_equal(two, "rotation_int16_bf16")


def test_rotation_null_refuses_per_window_and_a_foreign_device(two):
    err = two[0]["rotation_per_window_error"]
    assert err.startswith("ValueError: rotation_mode='per_window' does not "
                          "support mesh")
    eeg, emg = M.cohort_signals(3, seconds=8.0, seed=6)
    with pytest.raises(ValueError, match="per_window"):
        JN.cohort_msc_rotation_null(eeg, emg, FS, mesh=jax_mesh(2),
                                    rotation_mode="per_window", **M.ROT_KW)
    assert two[0]["rotation_device_error"].startswith(
        "ValueError: device='meta'")


@pytest.mark.parametrize("max_stat_only", [False, True])
def test_phase_null_matches_jax_mesh(two, max_stat_only):
    """40 surrogates in rounds of 2 × 8; the histogram increments are
    summed over the ranks."""
    eeg, emg = M.null_pair()
    ref = JS.msc_phase_randomized_null(eeg, emg, FS, mesh=jax_mesh(2),
                                       max_stat_only=max_stat_only,
                                       **M.PHASE_KW)
    key = "phase_max_only" if max_stat_only else "phase"
    got = two[0][key]
    np.testing.assert_allclose(got["observed"], ref["observed"], rtol=0,
                               atol=OBS_ATOL)
    assert got["max_stat"].shape == ref["max_stat"].shape == (40,)
    np.testing.assert_allclose(got["max_stat"], ref["max_stat"],
                               rtol=MAX_RTOL, atol=MAX_ATOL)
    assert got["p_fwe"] == ref["p_fwe"]
    for q, r in ref["null_quantiles"].items():
        g = got["null_quantiles"][q]
        if max_stat_only:
            assert g == pytest.approx(r, rel=MAX_RTOL, abs=MAX_ATOL)
            continue
        diff = np.abs(g - r) * TS.N_BINS
        assert (diff > 0).mean() <= QUANTILE_CELLS and diff.max() <= 1, q
    _assert_ranks_equal(two, key)


# ---- torch_entry.py ---------------------------------------------------------

def test_torch_entry_step_matches_graft_entry():
    """``torch_entry.entry`` on the CPU against ``__graft_entry__.entry``:
    the same tiny problem, the same CMC step."""
    import __graft_entry__
    import torch_entry
    jfn, jargs = __graft_entry__.entry()
    tfn, targs = torch_entry.entry(device="cpu")
    for t, j in zip(targs, jargs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for got, ref in zip(tfn(*targs), jfn(*jargs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=MSC_ATOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            torch_entry.entry()


def test_torch_entry_dryrun_on_two_ranks(capfd):
    import torch_entry
    torch_entry.dryrun_multichip(2, device_type="cpu")
    assert "dryrun_multichip OK on 2 cpu ranks" in capfd.readouterr().out


def test_torch_entry_dry_run_is_the_card_s_unless_asked(monkeypatch, capfd):
    """``dryrun_multichip`` runs on the card by default (with no card it
    raises before it spawns a rank), and the command line passes
    ``--device`` to it as well as to ``entry()``."""
    import torch_entry
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            torch_entry.dryrun_multichip(2)
        assert "dryrun_multichip OK" not in capfd.readouterr().out
    seen = []
    monkeypatch.setattr(torch_entry, "dryrun_multichip",
                        lambda n, device_type: seen.append((n, device_type)))
    torch_entry.main(["--ranks", "2", "--device", "cpu"])
    assert "entry() OK (cpu)" in capfd.readouterr().out
    if torch.cuda.is_available():
        torch_entry.main(["--ranks", "3"])
    else:
        with pytest.raises(RuntimeError, match="device"):
            torch_entry.main(["--ranks", "3"])
    assert seen == [(2, "cpu"), (3, "cuda")]
