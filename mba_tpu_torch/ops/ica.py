"""Extended-Infomax ICA and rule-based IC labels (port of
``mba_tpu/ops/ica.py``).

- :class:`InfomaxICA`: PCA whitening (covariance on the device, the C×C
  eigendecomposition on the host, the numerical-rank cap) and extended-
  Infomax natural-gradient learning (Lee, Girolami & Sejnowski 1999) with
  kurtosis-based sub/super-Gaussian switching, learning-rate annealing
  and the weight-change stop, in either of the JAX package's batch
  layouts: ``'comb'``, a fixed decimated comb whose order is rolled each
  epoch by ``randint(sub, (), 0, n_blocks)`` after ``key, sub =
  split(key)``; or ``'reference'``, each epoch's blocks gathered as
  ``x_white[permutation(sub, n_blocks·block)]`` (MNE's per-epoch sample
  permutation, ``ica.py:52-64``).  The keys are ``jax.random``'s
  threefry (``ops/prng.py``), so a seed gives the JAX package's shifts
  and permutations.
- :func:`label_components`: the feature-based classifier of
  ``ops/ic_classify.py`` (a host copy) on the sources; a tensor input
  ships only the 120-s spectral segment and the full-length moments to
  the host.

An epoch is a serial chain of mini-batch steps, each a few tiny matmuls
(at study scale ~3 230 steps of a 1 077 × 25 block).  On the card the
epoch is captured once per fit as a CUDA graph and replayed: the roll's
gather, the steps, the kurtosis signs, the annealing and blow-up updates
and the ``done`` flag run from device tensors, and the host writes the
shift and reads ``done`` once an epoch.  In the reference layout the
graph reads its blocks from a static buffer instead, which the
permutation's gather (its sort keys drawn by the threefry kernel, a
stable sort, ``index_select``) fills on the stream before each replay.
On the CPU the same epoch runs eagerly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from mba_tpu_torch._device import entry_device, to_device
from mba_tpu_torch.ops import cuda_prng, prng
from mba_tpu_torch.ops.ic_classify import classify_components

KURTOSIS_ROWS = 6000     # rows of the whitened data behind the signs


@dataclass
class _EpochState:
    """The device tensors one epoch reads and updates in place."""
    x_comb: torch.Tensor      # (n_blocks, block, n): 'comb', block b =
                              # rows i·nb + b, rolled by the epoch;
                              # 'reference', this epoch's gathered blocks
    x_kurt: torch.Tensor      # (≤ 6000, n): the rows behind the signs
    order: torch.Tensor       # arange(n_blocks), int64
    eye: torch.Tensor
    shift: torch.Tensor       # () int64, written by the host each epoch
    w: torch.Tensor           # (n, n)
    signs: torch.Tensor       # (n,) ±1
    lrate: torch.Tensor       # () float32
    old_d_w: torch.Tensor     # (n, n)
    step: torch.Tensor        # () int32, epochs run
    done: torch.Tensor        # () bool


def _epoch(st: _EpochState, block: int, w_change_tol: float,
           anneal_deg: float, anneal_step: float, roll: bool = True
           ) -> None:
    """One extended-Infomax epoch, in place on ``st`` (capturable: no
    host reads).  Step: u = x_b·W, W += lrate·W·(block·I − u^T(s·tanh u
    + u)), the JAX package's update with its two products fused.
    ``roll``: the comb's blocks rolled by ``st.shift``; else the blocks
    as ``st.x_comb`` holds them."""
    n_blocks = st.x_comb.shape[0]
    data = st.x_comb
    if roll:
        data = data.index_select(
            0, torch.remainder(st.order - st.shift, n_blocks))  # jnp.roll
    w0 = st.w
    lr_block_eye = st.eye * (st.lrate * block)
    neg_lr = -st.lrate
    w = w0
    for b in range(n_blocks):
        u = data[b] @ w
        v = torch.addcmul(u, torch.tanh(u), st.signs)
        inner = torch.addcmul(lr_block_eye, u.T @ v, neg_lr)
        w = torch.addmm(w, w, inner)

    # kurtosis-based sign update (sub- vs super-Gaussian components)
    u_all = st.x_kurt @ w
    m2 = (u_all ** 2).mean(dim=0)
    m4 = (u_all ** 4).mean(dim=0)
    kurt = m4 / torch.clamp_min(m2 ** 2, 1e-12) - 3.0
    new_signs = torch.where(kurt >= 0, 1.0, -1.0).to(torch.float32)

    # convergence / annealing (MNE-style angle criterion)
    d_w = w - w0
    change = (d_w * d_w).sum()
    dot = (d_w * st.old_d_w).sum()
    denom = torch.sqrt(torch.clamp_min(change, 1e-30) * torch.clamp_min(
        (st.old_d_w * st.old_d_w).sum(), 1e-30))
    angle = torch.rad2deg(torch.acos(torch.clamp(dot / denom, -1.0, 1.0)))
    anneal = angle > anneal_deg
    lrate = torch.where(anneal, st.lrate * anneal_step, st.lrate)
    old_d_w = torch.where(anneal, d_w, st.old_d_w)
    blowup = ~torch.isfinite(change) | (change > 1e9)
    w = torch.where(blowup, st.eye, w)
    lrate = torch.where(blowup, lrate * 0.5, lrate)
    done = (change < w_change_tol) & (st.step > 1)

    st.w.copy_(w)
    st.signs.copy_(new_signs)
    st.lrate.copy_(lrate)
    st.old_d_w.copy_(old_d_w)
    st.done.copy_(done)
    st.step.add_(1)


def _extended_infomax(key, x_white: torch.Tensor, n_comp: int, block: int,
                      max_iter: int, l_rate, ext_blocks=1,
                      w_change_tol=1e-7, anneal_deg=60.0, anneal_step=0.9,
                      batch_layout="comb", timings_out: dict | None = None):
    """Extended Infomax on whitened data (T, n_comp) → (W (n_comp²) on
    the data's device, epochs run).  ``key``: a threefry key (a (2,)
    uint32 array, ``prng.prng_key(seed)``)."""
    if batch_layout not in ("comb", "reference"):
        raise ValueError("batch_layout must be 'comb' or 'reference', got "
                         f"{batch_layout!r}")
    comb = batch_layout == "comb"
    device = x_white.device
    n_samples = x_white.shape[0]
    n_blocks = n_samples // block
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.eye(n_comp, **f32)
    st = _EpochState(
        x_comb=(x_white[:n_blocks * block].reshape(block, n_blocks, n_comp)
                .transpose(0, 1).contiguous() if comb else
                torch.empty((n_blocks, block, n_comp), **f32)),
        x_kurt=x_white[:min(n_samples, KURTOSIS_ROWS)],
        order=torch.arange(n_blocks, device=device),
        eye=eye, shift=torch.zeros((), dtype=torch.int64, device=device),
        w=eye.clone(), signs=torch.ones(n_comp, **f32),
        lrate=torch.tensor(float(np.float32(l_rate)), **f32),
        old_d_w=eye.clone(),
        step=torch.zeros((), dtype=torch.int32, device=device),
        done=torch.zeros((), dtype=torch.bool, device=device))
    args = (block, w_change_tol, anneal_deg, anneal_step, comb)

    def next_input():
        """The next epoch's shift ('comb'), or its permutation
        ('reference', drawn on the device)."""
        nonlocal key
        key, sub = prng.split(key)
        if comb:
            return int(prng.randint(sub, (), 0, n_blocks))
        return cuda_prng.permutation(sub, n_blocks * block, device)

    def load(inp) -> None:
        """Write an epoch's input where the epoch reads it."""
        if comb:
            st.shift.fill_(inp)
        else:
            torch.index_select(x_white, 0, inp,
                               out=st.x_comb.view(-1, n_comp))

    graph = None
    t_capture = 0.0
    t0 = time.perf_counter()
    inp = next_input()
    n_iter = 0
    while n_iter < max_iter:
        if device.type != "cuda":
            load(inp)
            _epoch(st, *args)
        elif graph is None:
            # the first epoch runs eagerly on a side stream (the warm-up
            # that capture needs), then the epoch is captured once
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                load(inp)
                _epoch(st, *args)
            torch.cuda.current_stream(device).wait_stream(side)
            tc = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                _epoch(st, *args)
            t_capture = time.perf_counter() - tc
        else:
            load(inp)                     # on the stream, before the replay
            graph.replay()
        n_iter += 1
        inp = next_input()                # while the card runs the epoch
        if bool(st.done):
            break
    if timings_out is not None:
        timings_out.update(epochs=n_iter, capture_sec=t_capture,
                           epochs_sec=time.perf_counter() - t0 - t_capture)
    w = st.w.clone()
    del graph
    return w, n_iter


def _mean_cov(x: torch.Tensor):
    """Channel mean and covariance on the device (x: (T, C) float32)."""
    mean = x.mean(dim=0)
    xc = x - mean
    return mean, xc.T @ xc / x.shape[0]


def _project(x: torch.Tensor, mean: torch.Tensor, proj_t: torch.Tensor
             ) -> torch.Tensor:
    """(x − mean) @ proj_t.T on the device."""
    return (x - mean) @ proj_t.T


def _source_moments(src: torch.Tensor):
    """Per-column excess kurtosis and |skewness| (device reduction), as
    ``ic_classify.component_features`` computes them (z-scored central
    moments, population σ with a +1e-20 guard)."""
    mu = src.mean(dim=0, keepdim=True)
    sd = src.std(dim=0, correction=0, keepdim=True) + 1e-20
    z = (src - mu) / sd
    return (z ** 4).mean(dim=0) - 3.0, (z ** 3).mean(dim=0).abs()


class InfomaxICA:
    """Extended-Infomax ICA with PCA whitening (MNE-equivalent role).

    Same constructor, fitted attributes (``_mean``, ``_whitener``,
    ``_dewhitener``, ``_w``, ``unmixing_``, ``mixing_``,
    ``n_components_``, ``n_iter_``, ``block_``, ``exclude``) and methods
    as ``mba_tpu.ops.ica.InfomaxICA``, plus ``device`` (default: the
    device of a tensor input, else the card; ``device="cpu"`` for the
    CPU).  The covariance, whitening, epochs, source projection and
    artifact reconstruction run on the device; the host does the C×C
    eigendecomposition.  ``n_components`` is capped at the data's
    numerical rank; the count used is ``n_components_``.  ``timings_``
    holds the fit's epochs, the graph capture's seconds and the epochs'
    seconds.
    """

    def __init__(self, n_components: int, max_iter: int = 500,
                 random_state: int = 42, l_rate: float | None = None,
                 block: int | None = None,
                 batch_layout: str = "comb", device=None):
        if batch_layout not in ("comb", "reference"):
            raise ValueError("batch_layout must be 'comb' or "
                             f"'reference', got {batch_layout!r}")
        self.n_components = n_components
        self.max_iter = max_iter
        self.random_state = random_state
        self.l_rate = l_rate
        self.block = block
        self.batch_layout = batch_layout
        self.device = device
        self.exclude: list[int] = []

    def _f32(self, a, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def fit(self, data) -> "InfomaxICA":
        """data: (n_samples, n_channels), numpy or a tensor."""
        device = entry_device(self.device, data)
        x_d = to_device(data, device).to(torch.float32)
        n_samples, n_ch = x_d.shape

        mean_d, cov_d = _mean_cov(x_d)
        cov = cov_d.cpu().numpy().astype(np.float64)
        self._mean = mean_d.cpu().numpy().astype(np.float64)
        eigval, eigvec = np.linalg.eigh(cov)
        order = np.argsort(eigval)[::-1]
        eigval = eigval[order]
        eigvec = eigvec[:, order]
        # numerical-rank cap: the float32 covariance puts null-space
        # eigenvalues near n·eps_f32 relative
        tol = max(eigval[0], 0.0) * n_ch * np.finfo(np.float32).eps
        rank = int((eigval > tol).sum())
        n_comp = min(self.n_components, n_ch, max(rank, 1))
        self.n_components_ = n_comp
        eigval = np.maximum(eigval[:n_comp], 1e-12)
        eigvec = eigvec[:, :n_comp]
        self._whitener = (eigvec / np.sqrt(eigval)).T      # (n_comp, C)
        self._dewhitener = (eigvec * np.sqrt(eigval))      # (C, n_comp)
        x_white = _project(x_d, mean_d, self._f32(self._whitener, device))
        del x_d

        # MNE/EEGLAB block heuristic √(n/3)
        if self.block is not None:
            block = int(self.block)
        else:
            block = int(np.floor(np.sqrt(n_samples / 3.0)))
        block = max(8, min(block, n_samples))
        self.block_ = block
        l_rate = self.l_rate or 0.01 / np.log(n_comp ** 2.0)
        self.timings_ = {}
        w, n_iter = _extended_infomax(
            prng.prng_key(self.random_state), x_white, n_comp, block,
            self.max_iter, np.float32(l_rate), batch_layout=self.batch_layout,
            timings_out=self.timings_)
        self._w = w.cpu().numpy().astype(np.float64)       # (n_comp, n_comp)
        self.n_iter_ = int(n_iter)

        # unmixing: sources = (x - mean) @ unmixing.T
        self.unmixing_ = self._w.T @ self._whitener        # (n_comp, C)
        self.mixing_ = np.linalg.pinv(self.unmixing_)      # (C, n_comp)
        return self

    def get_sources(self, data) -> np.ndarray:
        """(n_samples, n_components) source estimates, numpy float64."""
        device = entry_device(self.device, data)
        x_d = to_device(data, device).to(torch.float32)
        return _project(x_d, self._f32(self._mean, device),
                        self._f32(self.unmixing_, device)
                        ).cpu().numpy().astype(np.float64)

    def apply(self, data, exclude: list[int] | None = None):
        """Reconstruct data with the excluded components removed
        (``mne.preprocessing.ICA.apply``): the artifact subspace is
        projected out, the rest (the non-retained PCA subspace included)
        kept.  A tensor input gives a float32 tensor on its device; numpy
        input gives numpy float64."""
        exclude = exclude if exclude is not None else self.exclude
        on_device = isinstance(data, torch.Tensor)
        if not len(exclude):
            return data if on_device else np.asarray(data,
                                                     np.float64).copy()
        device = entry_device(self.device, data)
        x_d = to_device(data, device).to(torch.float32)
        # artifact = sources[:, exclude] @ mixing[:, exclude].T, fused:
        # (x - mean) @ (unmixing[exclude].T @ mixing[:, exclude].T)
        proj = self.unmixing_[exclude].T @ self.mixing_[:, exclude].T
        artifact = _project(x_d, self._f32(self._mean, device),
                            self._f32(proj.T, device))
        if on_device:
            return x_d - artifact
        return (np.asarray(data, np.float64)
                - artifact.cpu().numpy().astype(np.float64))


# --------------------------------------------------------------------------
# component labeling (ICLabel-equivalent vocabulary)
# --------------------------------------------------------------------------
def label_components(ica: InfomaxICA, data, fs: float,
                     channel_names: list[str] | None = None) -> dict:
    """Per-class feature-based IC labels (mne-icalabel contract):
    ``{'y_pred_proba': [...], 'labels': [...]}``, one of 'brain', 'eye
    blink', 'heart beat', 'muscle artifact', 'channel noise', 'line
    noise', 'other' per component.

    A tensor input stays on its device: the sources are projected there
    and the host receives the 120-s spectral-feature segment and the
    full-length moments only.
    """
    if isinstance(data, torch.Tensor):
        device = data.device
        src_d = _project(data.to(torch.float32),
                         ica._f32(ica._mean, device),
                         ica._f32(ica.unmixing_, device))
        n_use = min(src_d.shape[0], int(120 * fs))
        kurt_d, skew_d = _source_moments(src_d)
        seg = src_d[:n_use].cpu().numpy().astype(np.float64)
        moments = {"kurtosis": kurt_d.cpu().numpy().astype(np.float64),
                   "abs_skew": skew_d.cpu().numpy().astype(np.float64)}
        out = classify_components(seg, ica.mixing_, fs, channel_names,
                                  full_moments=moments)
    else:
        sources = ica.get_sources(data)
        out = classify_components(sources, ica.mixing_, fs, channel_names)
    return {'y_pred_proba': out['y_pred_proba'], 'labels': out['labels']}
