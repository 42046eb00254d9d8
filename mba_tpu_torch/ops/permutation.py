"""Cluster-based sign-flip permutation testing on the card.

The port of ``mba_tpu/ops/permutation.py``.  It replaces
``mne.stats.spatio_temporal_cluster_1samp_test`` /
``permutation_cluster_1samp_test`` (reference cbpa.py:1027-1042) with a
batched device implementation:

- **t-maps for all permutations are one matmul.**  For a 1-sample
  sign-flip test, Σ(s_i·x_i)² = Σx_i², so per-permutation variances come
  from the fixed Σx² and the permuted means; the only permutation-
  dependent work is ``signs (P, S) @ X (S, N)`` (full float32, TF32 off).
- **Cluster search is label propagation** through a padded neighbour
  table: ``ceil(log2 N) + 2`` rounds of gather-max plus pointer jumping,
  over all permutations of a chunk at once (int64 labels).  Cluster mass
  = segment sum of t over the final labels (``scatter_add_``, atomic on
  the card, so a mass may differ in its last bits from run to run); the
  null records each permutation's maximum mass.
- **Signs are ``jax.random.bernoulli`` draws**: the JAX package's key
  schedule (``split(PRNGKey(seed), n_chunks)``, per chunk
  ``uniform(key_c, (chunk, n_subj)) < 0.5``), all chunks' uniforms drawn
  by the threefry kernel in one launch on the card (``ops/cuda_prng``),
  so a seed gives the JAX package's sign matrices on both devices.
- Observed clusters are labelled once on the host (scipy connected
  components) and receive p-values against the device null, with the
  observed statistic included in H0 exactly as MNE does.

Also provides the host adjacency helpers: Delaunay over 2-D-projected
electrode positions (MNE's ``find_ch_adjacency`` analog), the temporal
chain combination, and circular phase wrap-around edges.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import scipy.spatial
import torch
from scipy.stats import t as t_dist

from mba_tpu_torch import _device
from mba_tpu_torch.channel_layout import eeg_positions_3d
from mba_tpu_torch.ops import cuda_prng, prng


# --------------------------------------------------------------------------
# adjacency construction (host)
# --------------------------------------------------------------------------
def delaunay_channel_adjacency(ch_names: list[str]) -> scipy.sparse.csr_matrix:
    """Spatial adjacency via Delaunay triangulation of projected positions.

    MNE's ``find_ch_adjacency`` analog (reference cbpa.py:235): electrode
    3-D positions are azimuthally projected to 2-D, triangulated, and
    triangle edges become adjacency.  Degenerate cases (< 4 channels) fall
    back to full connectivity.
    """
    pos = eeg_positions_3d(ch_names)
    # azimuthal equidistant projection (like MNE's _auto_topomap_coords)
    xyz = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    theta = np.arccos(np.clip(xyz[:, 2], -1, 1))
    phi = np.arctan2(xyz[:, 1], xyz[:, 0])
    pts = np.stack([theta * np.cos(phi), theta * np.sin(phi)], axis=1)

    n = len(ch_names)
    adj = scipy.sparse.lil_matrix((n, n), dtype=bool)
    if n < 4:
        adj[:, :] = True
    else:
        tri = scipy.spatial.Delaunay(pts)
        for simplex in tri.simplices:
            for i in range(3):
                a, b = simplex[i], simplex[(i + 1) % 3]
                adj[a, b] = True
                adj[b, a] = True
    adj.setdiag(False)
    return adj.tocsr()


def combine_adjacency(n_times: int,
                      spatial_adj: scipy.sparse.spmatrix
                      ) -> scipy.sparse.csr_matrix:
    """Lattice product of a temporal chain with spatial adjacency.

    Node index convention: ``t * n_ch + ch`` (matches
    ``mne.stats.combine_adjacency``; reference cbpa.py:237).
    """
    n_ch = spatial_adj.shape[0]
    temporal = scipy.sparse.diags([np.ones(n_times - 1)] * 2, [-1, 1],
                                  format='csr', dtype=bool) \
        if n_times > 1 else scipy.sparse.csr_matrix((1, 1), dtype=bool)
    eye_t = scipy.sparse.eye(n_times, dtype=bool, format='csr')
    eye_c = scipy.sparse.eye(n_ch, dtype=bool, format='csr')
    combined = (scipy.sparse.kron(temporal, eye_c)
                + scipy.sparse.kron(eye_t, spatial_adj.astype(bool)))
    return combined.tocsr().astype(bool)


def add_phase_wraparound(adjacency: scipy.sparse.spmatrix, n_times: int,
                         n_ch: int) -> scipy.sparse.csr_matrix:
    """Circular edges joining the first and last phase bin per channel
    (reference cbpa.py:949-982)."""
    wrap = scipy.sparse.lil_matrix(adjacency.shape, dtype=bool)
    for ch in range(n_ch):
        first = ch
        last = (n_times - 1) * n_ch + ch
        wrap[first, last] = True
        wrap[last, first] = True
    return (adjacency.astype(bool) + wrap.tocsr()).astype(bool)


def _edge_list(adjacency: scipy.sparse.spmatrix) -> np.ndarray:
    coo = scipy.sparse.triu(adjacency.tocoo(), k=1)
    return np.stack([coo.row, coo.col], axis=1).astype(np.int32)


def _neighbor_table(edges: np.ndarray, n_nodes: int) -> np.ndarray:
    """Padded per-node neighbor-index table (n_nodes, max_degree).

    Padding entries point at the node itself, so a gather through the
    table is always in-bounds and padding never changes a max-reduction.
    """
    nbrs: list[list[int]] = [[] for _ in range(n_nodes)]
    for a, b in edges:
        if a != b:
            nbrs[a].append(int(b))
            nbrs[b].append(int(a))
    max_deg = max((len(x) for x in nbrs), default=1) or 1
    table = np.tile(np.arange(n_nodes, dtype=np.int32)[:, None],
                    (1, max_deg))
    for i, x in enumerate(nbrs):
        table[i, :len(x)] = x
    return table


# --------------------------------------------------------------------------
# device part
# --------------------------------------------------------------------------
def _t_maps(signs: torch.Tensor, X_flat: torch.Tensor,
            sum_sq: torch.Tensor) -> torch.Tensor:
    """Per-permutation one-sample t-maps from the sign-flip matmul trick:
    signs (P, S), X_flat (S, N), sum_sq (N,) → (P, N)."""
    n_subj = X_flat.shape[0]
    mean = (signs @ X_flat) / n_subj                        # (P, N)
    var = (sum_sq[None, :] - n_subj * mean ** 2) / (n_subj - 1)
    se = torch.sqrt(torch.clamp_min(var, 1e-30) / n_subj)
    return mean / se


def _max_cluster_mass(t_maps: torch.Tensor, nbr_table: torch.Tensor,
                      threshold: float, tail: int,
                      n_nodes: int) -> torch.Tensor:
    """Maximum cluster mass of each t-map (P, N) → (P,), by gather-based
    label propagation with pointer jumping (Shiloach–Vishkin style): each
    supra-threshold node repeatedly (a) hooks to the max label among its
    supra neighbours and (b) shortcuts to its representative's label.
    Reach at least doubles per round, so ``ceil(log2(N)) + 2`` rounds
    suffice, as in the JAX package.  ``nbr_table`` (N, D) int64."""
    n_iters = int(np.ceil(np.log2(max(n_nodes, 2)))) + 2
    nodes = torch.arange(n_nodes, dtype=torch.int64, device=t_maps.device)

    def mass_for(supra):
        labels = torch.where(supra, nodes, -1)               # (P, N)
        for _ in range(n_iters):
            nbr_max = labels[:, nbr_table].amax(-1)          # -1 ignored
            labels = torch.where(labels >= 0,
                                 torch.maximum(labels, nbr_max), -1)
            # pointer jump: adopt the representative's (supra) label
            rep = torch.where(labels >= 0, labels, 0)
            labels = torch.where(
                labels >= 0, torch.maximum(labels, labels.gather(1, rep)),
                -1)
        seg = torch.where(labels >= 0, labels, 0)
        mass = torch.zeros_like(t_maps).scatter_add_(
            1, seg, torch.where(supra, t_maps, 0.0))
        return mass.abs().amax(-1)

    if tail == 1:
        return mass_for(t_maps > threshold)
    if tail == -1:
        return mass_for(t_maps < -threshold)
    # two-tailed: positive and negative clusters found separately (MNE)
    return torch.maximum(mass_for(t_maps > threshold),
                         mass_for(t_maps < -threshold))


def _draw_signs(seed: int, n_chunks: int, chunk: int, n_subj: int,
                device) -> torch.Tensor:
    """The sign matrices of ``_null_distribution``, (n_chunks, chunk,
    n_subj) float32 ±1: ``jax.random.bernoulli(key_c, 0.5, (chunk,
    n_subj))`` for each key of ``split(PRNGKey(seed), n_chunks)``, which
    is ``uniform(key_c, (chunk, n_subj)) < 0.5``; one threefry launch for
    all chunks on the card."""
    keys = prng.split(prng.prng_key(seed), n_chunks)
    u = cuda_prng.uniform_keys(keys, (chunk, n_subj), 0.0, 1.0, device)
    return torch.where(u < 0.5, 1.0, -1.0)


def _null_from_sign_chunks(sign_chunks, X_flat: torch.Tensor,
                           nbr_table: torch.Tensor, threshold: float,
                           tail: int, n_nodes: int) -> torch.Tensor:
    """Max-cluster-mass null over sign chunks (each (chunk, n_subj)),
    one chunk at a time (``lax.map`` in the JAX package)."""
    sum_sq = (X_flat ** 2).sum(0)
    return torch.cat([_max_cluster_mass(_t_maps(sg, X_flat, sum_sq),
                                        nbr_table, threshold, tail, n_nodes)
                      for sg in sign_chunks])


def _null_distribution(seed: int, X_flat: torch.Tensor,
                       nbr_table: torch.Tensor, threshold: float, tail: int,
                       n_nodes: int, n_permutations: int,
                       chunk: int = 256) -> torch.Tensor:
    """Max-cluster-mass null over ``n_permutations`` sign-flip
    permutations drawn from ``seed`` (the JAX package's key schedule);
    padding rows of the last chunk are cut."""
    n_chunks = -(-n_permutations // chunk)
    signs = _draw_signs(seed, n_chunks, chunk, X_flat.shape[0],
                        X_flat.device)
    return _null_from_sign_chunks(signs, X_flat, nbr_table, threshold, tail,
                                  n_nodes)[:n_permutations]


def _null_from_signs(signs: torch.Tensor, X_flat: torch.Tensor,
                     nbr_table: torch.Tensor, threshold: float, tail: int,
                     n_nodes: int, chunk: int = 256) -> torch.Tensor:
    """Max-cluster-mass null for an explicit sign matrix (P, n_subj) —
    used for exact enumeration of all 2^n sign assignments."""
    return _null_from_sign_chunks(signs.split(chunk), X_flat, nbr_table,
                                  threshold, tail, n_nodes)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def cluster_permutation_1samp_test(X: np.ndarray,
                                   adjacency: scipy.sparse.spmatrix,
                                   n_permutations: int = 1024,
                                   threshold: float | None = None,
                                   tail: int = 0,
                                   alpha_cluster_forming: float = 0.05,
                                   seed: int = 42,
                                   permutation_chunk: int = 256,
                                   exact: bool | None = None,
                                   device=None):
    """Spatio-temporal cluster-based 1-sample permutation test.

    X : (n_subjects, n_times, n_channels) contrast array.
    adjacency : combined (n_times·n_ch)² sparse adjacency
        (node index = t·n_ch + ch).
    permutation_chunk : permutations per step; with the seed it fixes the
        sign draws (one key per chunk, as in the JAX package).
    exact : enumerate ALL 2^n_subjects sign assignments instead of Monte
        Carlo — the permutation p-values are then exact randomisation-test
        p-values (the identity assignment is included in H0, so p ≥ 2^-n).
        Defaults to automatic: exact when 2^n_subjects ≤ n_permutations.
    device : where the null runs; the card unless ``device="cpu"``.

    Returns (t_obs (n_times, n_ch), clusters [bool masks], cluster_pv,
    H0) with MNE conventions: cluster mass = sum of t inside the cluster;
    H0 includes the observed maximum; p = mean(H0 ≥ |mass|).
    """
    device = _device.entry_device(device)
    X = np.asarray(X, np.float32)
    n_subj, n_times, n_ch = X.shape
    n_nodes = n_times * n_ch
    if adjacency.shape != (n_nodes, n_nodes):
        raise ValueError(
            f"adjacency shape {adjacency.shape} does not match "
            f"n_times*n_ch = {n_nodes}")
    if threshold is None:
        df = n_subj - 1
        q = (1 - alpha_cluster_forming / 2 if tail == 0
             else 1 - alpha_cluster_forming)
        threshold = float(t_dist.ppf(q, df))

    X_flat = X.reshape(n_subj, n_nodes)

    # observed t-map (host; cheap)
    mean = X_flat.mean(axis=0)
    sd = X_flat.std(axis=0, ddof=1)
    t_obs_flat = mean / np.maximum(sd / np.sqrt(n_subj), 1e-30)

    # observed clusters via scipy connected components on the masked graph
    clusters: list[np.ndarray] = []
    masses: list[float] = []

    def find_clusters(supra_mask, tvals):
        idx = np.flatnonzero(supra_mask)
        if len(idx) == 0:
            return
        sub = adjacency[idx][:, idx]
        n_comp, labels = scipy.sparse.csgraph.connected_components(
            sub, directed=False)
        for c in range(n_comp):
            nodes = idx[labels == c]
            mask = np.zeros(n_nodes, bool)
            mask[nodes] = True
            clusters.append(mask.reshape(n_times, n_ch))
            masses.append(float(tvals[nodes].sum()))

    if tail in (0, 1):
        find_clusters(t_obs_flat > threshold, t_obs_flat)
    if tail in (0, -1):
        find_clusters(t_obs_flat < -threshold, t_obs_flat)

    # permutation null on the device
    nbr_table = torch.from_numpy(
        _neighbor_table(_edge_list(adjacency), n_nodes).astype(np.int64)
    ).to(device)
    X_d = torch.from_numpy(X_flat).to(device)
    threshold32 = float(np.float32(threshold))
    if exact is None:
        exact = n_subj <= 20 and 2 ** n_subj <= n_permutations
    obs_max = max((abs(m) for m in masses), default=0.0)
    if exact:
        # all 2^n sign assignments; the identity (all +1) is one of them,
        # so H0 already contains the observed statistic
        bits = np.arange(2 ** n_subj, dtype=np.int64)
        signs = np.where((bits[:, None] >> np.arange(n_subj)) & 1,
                         1.0, -1.0).astype(np.float32)
        chunk = int(min(permutation_chunk, len(signs)))
        H0 = _null_from_signs(torch.from_numpy(signs).to(device), X_d,
                              nbr_table, threshold32, tail, n_nodes,
                              chunk=chunk).cpu().numpy().astype(np.float64)
        # the identity's entry (all +1, the last) is the observed
        # statistic, as MNE places it in H0: the device's sign-flip
        # t-map ((Σx² − n·mean²) form) rounds it a few ulps away from
        # the host t-map, which could drop the observed maximum from its
        # own count.  Two-tailed, the all −1 assignment (the first)
        # negates every t and has the same statistic.
        H0[-1] = obs_max
        if tail == 0:
            H0[0] = obs_max
    else:
        chunk = int(min(permutation_chunk, max(n_permutations, 1)))
        H0_perm = _null_distribution(seed, X_d, nbr_table, threshold32,
                                     tail, n_nodes, n_permutations,
                                     chunk=chunk).cpu().numpy()
        H0 = np.concatenate([[obs_max], H0_perm])  # observed incl. (MNE)

    cluster_pv = np.array([float(np.mean(H0 >= abs(m))) for m in masses])
    return (t_obs_flat.reshape(n_times, n_ch), clusters, cluster_pv, H0)
