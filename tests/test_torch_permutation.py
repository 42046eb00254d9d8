"""``mba_tpu_torch.ops.permutation`` against ``mba_tpu.ops.permutation``
on the CPU.

The adjacency helpers and the neighbour table are host copies: equal.
The sign matrices are ``jax.random.bernoulli``'s bits under the same key
split: equal.  t-maps and the max-mass null are float32 on both sides,
with the sign-flip matmul summed in another order: held within
``H0_RTOL``/``H0_ATOL`` (tests/test_stats_golden.py:298).  Exact mode
enumerates every sign assignment, so its cluster p-values equal the
independent numpy oracle of tests/test_stats_golden.py with tolerance 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from mba_tpu.ops import permutation as J
from mba_tpu.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET
from mba_tpu.channel_layout import EEG_CHANNELS
from mba_tpu_torch.ops import permutation as T

from test_stats_golden import GOLDEN_TOLERANCES, _mne_semantics_oracle

torch.set_num_threads(1)

H0_RTOL, H0_ATOL = 1e-4, 1e-4


def _chain(n_ch):
    return scipy.sparse.csr_matrix(np.eye(n_ch, k=1, dtype=bool)
                                   + np.eye(n_ch, k=-1, dtype=bool))


def _contrast(n_subj=12, n_times=20, n_ch=8, amp=1.2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_subj, n_times, n_ch)).astype(np.float32)
    X[:, 5:12, 2:5] += amp
    return X


@pytest.mark.parametrize("channels", [CMC_EEG_CHANNEL_SUBSET, EEG_CHANNELS,
                                      ["C3", "Cz", "C4"]])
def test_adjacencies_and_neighbour_table_match_jax(channels):
    port = T.delaunay_channel_adjacency(channels)
    ref = J.delaunay_channel_adjacency(channels)
    assert (port != ref).nnz == 0
    port_c, ref_c = (m.combine_adjacency(7, a) for m, a in ((T, port),
                                                              (J, ref)))
    assert (port_c != ref_c).nnz == 0
    wrapped = T.add_phase_wraparound(port_c, 7, len(channels))
    assert (wrapped != J.add_phase_wraparound(ref_c, 7, len(channels))
            ).nnz == 0
    np.testing.assert_array_equal(T._edge_list(wrapped),
                                  J._edge_list(wrapped))
    np.testing.assert_array_equal(
        T._neighbor_table(T._edge_list(wrapped), wrapped.shape[0]),
        J._neighbor_table(J._edge_list(wrapped), wrapped.shape[0]))


@pytest.mark.parametrize("seed,n_chunks,chunk,n_subj",
                         [(42, 4, 256, 12), (7, 3, 100, 9)])
def test_signs_are_jax_bernoulli_bits(seed, n_chunks, chunk, n_subj):
    """``_null_distribution``'s draws: split(PRNGKey(seed), n_chunks),
    then bernoulli(key_c, 0.5, (chunk, n_subj)) per chunk."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)
    ref = np.stack([np.where(jax.random.bernoulli(k, 0.5, (chunk, n_subj)),
                             1.0, -1.0) for k in keys]).astype(np.float32)
    port = T._draw_signs(seed, n_chunks, chunk, n_subj, "cpu")
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), ref)


def test_t_maps_and_null_match_jax():
    X = _contrast()
    n_subj = X.shape[0]
    X_flat = X.reshape(n_subj, -1)
    adj = J.combine_adjacency(20, _chain(8))
    table = J._neighbor_table(J._edge_list(adj), adj.shape[0])
    signs = T._draw_signs(3, 2, 64, n_subj, "cpu")[0]
    sum_sq = (X_flat.astype(np.float64) ** 2).sum(0).astype(np.float32)
    port_t = T._t_maps(signs, torch.from_numpy(X_flat),
                       torch.from_numpy(sum_sq)).numpy()
    ref_t = np.asarray(J._t_maps(jnp.asarray(signs.numpy()),
                                 jnp.asarray(X_flat), jnp.asarray(sum_sq)))
    np.testing.assert_allclose(port_t, ref_t, rtol=1e-5, atol=1e-5)
    thr = np.float32(2.2)
    for tail in (-1, 0, 1):
        ref = np.asarray(J._null_distribution(
            jax.random.PRNGKey(3), jnp.asarray(X_flat), jnp.asarray(table),
            thr, tail, adj.shape[0], 100, chunk=64))
        port = T._null_distribution(
            3, torch.from_numpy(X_flat), torch.from_numpy(
                table.astype(np.int64)), float(thr), tail, adj.shape[0],
            100, chunk=64).numpy()
        assert port.shape == (100,)
        np.testing.assert_allclose(port, ref, rtol=H0_RTOL, atol=H0_ATOL)


@pytest.mark.parametrize("tail", [-1, 0, 1])
def test_monte_carlo_test_matches_jax(tail):
    X = _contrast(n_subj=14)
    adj = T.combine_adjacency(20, _chain(8))
    port = T.cluster_permutation_1samp_test(X, adj, n_permutations=300,
                                            tail=tail, seed=5, device="cpu")
    ref = J.cluster_permutation_1samp_test(X, adj, n_permutations=300,
                                           tail=tail, seed=5)
    np.testing.assert_array_equal(port[0], ref[0])
    assert len(port[1]) == len(ref[1])
    for a, b in zip(port[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(port[3], ref[3], rtol=H0_RTOL, atol=H0_ATOL)
    np.testing.assert_allclose(port[2], ref[2], atol=2 / 301)
    if tail >= 0:
        assert port[2].min() < 0.05


@pytest.mark.parametrize("tail", [-1, 0, 1])
def test_exact_mode_equals_the_oracle(tail):
    """tests/test_stats_golden.py:279 on the port, all three tails: the
    same clusters, H0 as the float64 oracle's within 1e-4, and cluster
    p-values equal with tolerance 0."""
    rng = np.random.default_rng(8)
    n_subj, n_times, n_ch = 8, 5, 4
    X = rng.standard_normal((n_subj, n_times, n_ch)).astype(np.float32)
    X[:, 1:3, 1:3] += 1.1
    adj = T.combine_adjacency(n_times, _chain(n_ch))
    _, clusters, pv, H0 = T.cluster_permutation_1samp_test(
        X, adj, n_permutations=2 ** n_subj, tail=tail, exact=True,
        device="cpu")
    obs, pv_o, H0_o = _mne_semantics_oracle(X, adj, tail)
    assert ({frozenset(np.flatnonzero(c.ravel())) for c in clusters}
            == {frozenset(nodes.tolist()) for nodes, _ in obs})
    np.testing.assert_allclose(np.sort(H0), np.sort(H0_o), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(sorted(pv), sorted(pv_o),
                               atol=GOLDEN_TOLERANCES["cluster_p"])


def test_exact_switch_is_automatic():
    """tests/test_stats_golden.py:306: n_permutations ≥ 2^n enumerates
    every assignment, whatever the seed."""
    rng = np.random.default_rng(9)
    X = rng.standard_normal((6, 4, 3)).astype(np.float32)
    adj = T.combine_adjacency(4, scipy.sparse.csr_matrix(np.ones((3, 3),
                                                                 bool)))
    run = lambda n, seed: T.cluster_permutation_1samp_test(
        X, adj, n_permutations=n, tail=0, seed=seed, device="cpu")[3]
    assert len(run(50, 1)) == 51
    np.testing.assert_array_equal(run(100, 1), run(100, 2))
    assert len(run(100, 1)) == 64


def test_phase_wraparound_joins_the_ends():
    """A cluster planted at both ends of the phase axis is one cluster
    with the circular edges, two without — as in the JAX package."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((12, 16, 3)).astype(np.float32)
    X[:, :3, 1] += 2.0
    X[:, -3:, 1] += 2.0
    adj = T.combine_adjacency(16, _chain(3))
    wrapped = T.add_phase_wraparound(adj, 16, 3)
    for a in (adj, wrapped):
        port = T.cluster_permutation_1samp_test(X, a, n_permutations=200,
                                                tail=1, device="cpu")
        ref = J.cluster_permutation_1samp_test(X, a, n_permutations=200,
                                               tail=1)
        assert len(port[1]) == len(ref[1])
        np.testing.assert_allclose(port[2], ref[2], atol=2 / 201)
    n_big = lambda res: sum(c.sum() >= 3 for c in res[1])
    assert n_big(T.cluster_permutation_1samp_test(
        X, adj, n_permutations=200, tail=1, device="cpu")) == 2
    assert n_big(T.cluster_permutation_1samp_test(
        X, wrapped, n_permutations=200, tail=1, device="cpu")) == 1


def test_label_propagation_matches_scipy_on_a_path():
    """tests/test_cbpa.py:198: the worst case for propagation depth, all
    440 nodes supra-threshold on a chain, is one cluster."""
    n = 440
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    table = torch.from_numpy(T._neighbor_table(edges, n).astype(np.int64))
    t = torch.full((2, n), 2.5)
    mass = T._max_cluster_mass(t, table, 2.0, 1, n)
    np.testing.assert_allclose(mass.numpy(), [n * 2.5] * 2, rtol=1e-6)
