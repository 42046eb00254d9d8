"""Helpers for the parity tests of ``mba_tpu_torch`` against ``mba_tpu``.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU, torch on CPU tensors (each kernel wrapper then runs its
plain version).  Data crosses between the two as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def to_np(x) -> np.ndarray:
    """numpy copy of a JAX array, torch tensor or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.array(x)


def t32(x) -> torch.Tensor:
    """float32 CPU tensor from an array-like (a writable copy)."""
    return torch.tensor(np.array(x), dtype=torch.float32)


def assert_dicts_close(port: dict, ref: dict, keys, atol: float,
                       rtol: float = 0.0) -> None:
    for key in keys:
        np.testing.assert_allclose(to_np(port[key]), to_np(ref[key]),
                                   atol=atol, rtol=rtol, err_msg=key)


def jax_phases(seed: int, J: int, S: int, K: int, nF: int) -> np.ndarray:
    """φ drawn as ``cohort_null.py:724-725`` draws it, as numpy."""
    import jax
    key = jax.random.PRNGKey(seed)
    return np.array(jax.random.uniform(key, (J, S, K, nF), minval=0.0,
                                       maxval=2.0 * np.pi))


def jax_chunk_phases(seed: int):
    """A stand-in for ``mba_tpu_torch.ops.surrogate.draw_chunk_phases``
    that hands out the JAX package's draws: per chunk ``key, sub =
    jax.random.split(key)`` and ``uniform(sub, (S, F, M), 0, 2π)``, as
    ``surrogate.py:415-416`` and ``:132-134`` draw them."""
    import jax
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(key, n_surrogates, n_freqs, n_channels, device):
        state["key"], sub = jax.random.split(state["key"])
        phases = jax.random.uniform(sub, (n_surrogates, n_freqs, n_channels),
                                    minval=0.0, maxval=2 * np.pi)
        return torch.from_numpy(np.array(phases)).to(device)
    return draw


def null_toy(J=3, nF=4, N=512, K=3, seed=0):
    """Random rotation-null coefficients as ``tests/test_pallas_null.py``
    makes them: coef (J, nF, N, P), base and obs (nF, N)."""
    rng = np.random.default_rng(seed)
    P = K * (K - 1)
    coef = (rng.standard_normal((J, nF, N, P)) * 0.05).astype(np.float32)
    base = rng.uniform(0.1, 0.3, (nF, N)).astype(np.float32)
    obs = (base + rng.uniform(-0.05, 0.2, (nF, N))).astype(np.float32)
    return coef, base, obs


def cohort_subject(seed, fs=256.0, n_sec=24.0, nE=3, nM=4, couple=0.4):
    """One subject with a 21 Hz coupled drive, as
    ``tests/test_gram_coeffs.py:25-36`` builds it."""
    rng = np.random.default_rng(seed)
    n = int(fs * n_sec)
    t = np.arange(n) / fs
    drive = np.convolve(rng.standard_normal(n), np.ones(12) / 12.0, "same")
    carrier = np.sin(2 * np.pi * 21.0 * t) * drive
    eeg = (couple * carrier[:, None]
           + rng.standard_normal((n, nE))).astype(np.float32)
    emg = (couple * carrier[:, None]
           + rng.standard_normal((n, nM))).astype(np.float32)
    return eeg, emg


def coupled_signals(fs=256, seconds=6, n_eeg=2, n_emg=3, seed=1):
    """EEG/EMG with genuine 20 Hz coherence plus noise
    (``tests/test_ops_coherence.py:76-85``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    shared = np.sin(2 * np.pi * 20 * t + rng.uniform(0, 2 * np.pi))
    eeg = np.stack([shared + 0.8 * rng.standard_normal(len(t))
                    for _ in range(n_eeg)], axis=1)
    emg = np.stack([shared + 0.8 * rng.standard_normal(len(t))
                    for _ in range(n_emg)], axis=1)
    return eeg, emg
