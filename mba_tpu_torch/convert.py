"""Carry state from the JAX package into the port.

The system has no trained weights.  Its state is the DPSS taper set, the
rotation-null coefficients and a fitted ICA; each crosses as numpy
arrays in the JAX package's layouts.
"""
from __future__ import annotations

import numpy as np
import torch

from mba_tpu_torch.ops.cohort_null import NullState, null_state
from mba_tpu_torch.ops.ica import InfomaxICA


def from_jax_null_state(base_cohort, coef_all, observed_flat,
                        device) -> NullState:
    """The port's null state from the JAX package's coefficient pass.

    base_cohort (F, E, M), coef_all (J, F, N, P) and observed_flat (F, N)
    as numpy arrays (e.g. ``np.asarray`` of ``_cohort_rotation_coeffs``'s
    outputs).  The observed statistic is taken as given, not recomputed.
    """
    base = np.asarray(base_cohort, np.float32)
    coef = np.asarray(coef_all, np.float32)
    obs = np.asarray(observed_flat, np.float32)
    if coef.ndim != 4:
        raise ValueError(f"coef_all must be (J, F, N, P), got {coef.shape}")
    J, nF, N, P = coef.shape
    if base.shape[0] != nF or base.size != nF * N or obs.shape != (nF, N):
        raise ValueError(f"inconsistent shapes: base {base.shape}, coef "
                         f"{coef.shape}, observed {obs.shape}")
    as_t = lambda a: torch.as_tensor(a, device=device)
    return null_state(as_t(base), as_t(coef), as_t(obs))


def from_jax_null_state_pw(base_cohort, coefw_all, observed_flat,
                           device) -> NullState:
    """The port's per-window null state from the JAX package's per-window
    coefficient pass.

    base_cohort (F, E, M), coefw_all (Wp, J, F, N, P) and observed_flat
    (F, N) as numpy arrays (``_cohort_rotation_coeffs_pw``'s outputs).
    The state's coefT is (Wp, F, J·P, N), what :func:`~mba_tpu_torch.ops.
    cohort_null.null_chunk_pw` takes.
    """
    base = np.asarray(base_cohort, np.float32)
    coefw = np.asarray(coefw_all, np.float32)
    obs = np.asarray(observed_flat, np.float32)
    if coefw.ndim != 5:
        raise ValueError(f"coefw_all must be (Wp, J, F, N, P), got "
                         f"{coefw.shape}")
    Wp, J, nF, N, P = coefw.shape
    if base.shape[0] != nF or base.size != nF * N or obs.shape != (nF, N):
        raise ValueError(f"inconsistent shapes: base {base.shape}, coefw "
                         f"{coefw.shape}, observed {obs.shape}")
    as_t = lambda a: torch.as_tensor(a, device=device)
    return null_state(as_t(base), as_t(coefw), as_t(obs))


def ica_from_jax(mean, whitener, unmixing, mixing, n_components: int,
                 n_iter: int, exclude=(), device=None) -> InfomaxICA:
    """The port's fitted ``InfomaxICA`` from the JAX package's fitted
    state, given as numpy arrays: ``_mean`` (C,), ``_whitener``
    (n_comp, C), ``unmixing_`` (n_comp, C), ``mixing_`` (C, n_comp),
    ``n_components_``, ``n_iter_`` and ``exclude``.  ``apply`` and
    ``label_components`` then run on that one fit."""
    unmixing = np.asarray(unmixing, np.float64)
    mixing = np.asarray(mixing, np.float64)
    whitener = np.asarray(whitener, np.float64)
    n_comp = int(n_components)
    C = unmixing.shape[1]
    if (unmixing.shape != (n_comp, C) or mixing.shape != (C, n_comp)
            or whitener.shape != (n_comp, C)):
        raise ValueError(f"inconsistent shapes: unmixing {unmixing.shape}, "
                         f"mixing {mixing.shape}, whitener "
                         f"{whitener.shape}, n_components {n_comp}")
    ica = InfomaxICA(n_components=n_comp, device=device)
    ica._mean = np.asarray(mean, np.float64).reshape(C)
    ica._whitener = whitener
    ica.unmixing_ = unmixing
    ica.mixing_ = mixing
    ica.n_components_ = n_comp
    ica.n_iter_ = int(n_iter)
    ica.exclude = [int(i) for i in exclude]
    return ica


def tapers_from_jax(np_tapers, device) -> torch.Tensor:
    """(K, S) DPSS tapers → float32 tensor on ``device``."""
    tapers = np.asarray(np_tapers)
    if tapers.ndim != 2:
        raise ValueError(f"tapers must be (K, S), got {tapers.shape}")
    return torch.as_tensor(tapers, dtype=torch.float32, device=device)
