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


# ---- the CMC's result assembly -----------------------------------------

MSC_WINDOWS = 47             # 24 s at 256 Hz, 1-s windows at the half hop
MSC_MASKS = {
    "none": None,
    "all": np.ones(MSC_WINDOWS, bool),
    "no_window": np.zeros(MSC_WINDOWS, bool),
    "one_run": np.isin(np.arange(MSC_WINDOWS), np.arange(5, 30)),
    "runs": np.isin(np.arange(MSC_WINDOWS),
                    np.r_[0:3, 8:20, 21:22, 30:46]),
    "alternating": np.arange(MSC_WINDOWS) % 2 == 1,
    "ends": np.isin(np.arange(MSC_WINDOWS), [0, MSC_WINDOWS - 1]),
}
MSC_OPTIONS = {
    "jackknife": dict(use_jackknife=True),
    "jackknife_emg_max": dict(use_jackknife=True, aggregate_emg_max=True),
    "plain": dict(use_jackknife=False),
    "plain_emg_max": dict(use_jackknife=False, aggregate_emg_max=True),
    "jackknife_band": dict(use_jackknife=True, freq_range=(8.0, 40.0)),
    "plain_emg_max_band": dict(use_jackknife=False, aggregate_emg_max=True,
                               freq_range=(8.0, 40.0)),
}
MSC_TRANSFERS = {"float32": None, "bfloat16": torch.bfloat16,
                 "float16": np.float16, "int16": np.int16, "int8": np.int8}


def check_msc_assembly(monkeypatch, device, mask: str, options: str,
                       transfer: str) -> None:
    """``multitaper_msc``'s full-grid results against the rule they
    replaced, bit for bit: each compact result downloaded whole (float32;
    cast on the device to 16 bits; or through ``download_quantized``,
    lanes judged on the active windows), then zeros with the active rows
    set by a fancy index.  The compact results are the call's own,
    caught as ``_msc_all_windows`` returns them."""
    from mba_tpu_torch.ops import coherence as TC
    from mba_tpu_torch.utils.transfer import download_quantized

    caught = {}
    inner = TC._msc_all_windows

    def catch(*args, **kwargs):
        out = inner(*args, **kwargs)
        caught.update({key: val.clone() for key, val in out.items()})
        return out

    monkeypatch.setattr(TC, "_msc_all_windows", catch)
    window_mask, td = MSC_MASKS[mask], MSC_TRANSFERS[transfer]
    eeg, emg = coupled_signals(seconds=24)
    res = TC.multitaper_msc(eeg, emg, 256, window_length_sec=1.0,
                            window_mask=window_mask, window_chunk=8,
                            transfer_dtype=td, collect_timings=True,
                            device=device, **MSC_OPTIONS[options])

    on = np.ones(MSC_WINDOWS, bool) if window_mask is None else window_mask
    active = np.flatnonzero(on)
    n_runs = int(np.sum(on & ~np.r_[False, on[:-1]]))
    freqs = np.fft.rfftfreq(256, d=1.0 / 256)
    f0 = int(np.searchsorted(freqs, res["freqs"][0]))
    f1 = f0 + len(res["freqs"])
    keys = ("coherence", "ci_lower", "ci_upper") \
        if MSC_OPTIONS[options]["use_jackknife"] else ("coherence",)
    tail = (len(res["freqs"]), eeg.shape[1]) \
        + (() if MSC_OPTIONS[options].get("aggregate_emg_max")
           else (emg.shape[1],))
    want, n_bytes = {}, 0
    for key in keys:
        full = np.zeros((MSC_WINDOWS,) + tail, np.float32)
        if len(active):
            val = caught[key][:, f0:f1]
            if transfer in ("int16", "int8"):
                fine = 8.0 <= 0.1 * np.dtype(td).itemsize * len(active)
                compact, nb, _ = download_quantized(
                    val, td, lane_ndim=val.ndim - 1 if fine else 1)
            else:
                if td is not None:
                    val = val.to(getattr(torch, transfer))
                nb = val.numel() * val.element_size()
                compact = val.cpu().to(torch.float32).numpy()
            full[active] = compact
            n_bytes += nb
        want[key] = full

    names = {"coherence": "coherence_raw", "ci_lower": "coherence_ci_lower",
             "ci_upper": "coherence_ci_upper"}
    assert {k for k in names.values() if k in res} == \
        {names[k] for k in keys}
    for key in keys:
        got = res[names[key]]
        assert got.dtype == np.float32 and got.shape == want[key].shape
        assert got.flags.c_contiguous and got.flags.owndata, key
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want[key].view(np.uint32), err_msg=key)
        assert not got[~on].view(np.uint32).any(), key     # +0.0 exactly
    assert res["metadata"]["n_active_windows"] == len(active)
    t = res["timings"]
    assert t["download_bytes"] == n_bytes
    assert t["counters"].get("cmc.download_copies", 0) == \
        len(keys) * n_runs


NULL_UPLOAD_KEYS = ("observed", "max_stat", "p_uncorrected", "p_fwe")


def null_across_upload_paths(device, coeff_engine, seconds=100.0):
    """The cohort rotation null of three subjects (64×64 at 2048 Hz,
    ``seconds`` each: 52 MB an array at 100 s, six chunks of the staging
    ring and a part) on ``device``, run by upload path: the plain copy
    (every array under the staging threshold), then staged with
    ``overlap_upload`` True and False.  {path: the results of
    ``NULL_UPLOAD_KEYS``}, as numpy."""
    from mba_tpu_torch import _device
    from mba_tpu_torch.ops import cohort_null as TN
    rng = np.random.default_rng(11)
    n = int(2048 * seconds)
    drive = rng.standard_normal((3, n, 1)).astype(np.float32)
    eeg = rng.standard_normal((3, n, 64), dtype=np.float32) + 0.3 * drive
    emg = rng.standard_normal((3, n, 64), dtype=np.float32) + 0.3 * drive
    kw = dict(n_surrogates=300, surrogate_chunk=100, band=(13.0, 100.0),
              coeff_engine=coeff_engine, seed=5, device=device)
    out, threshold = {}, _device.STAGE_MIN_BYTES
    try:
        for path, overlap, stage_min in (("plain", True, eeg[0].nbytes + 1),
                                         ("staged", True, threshold),
                                         ("staged_fused", False, threshold)):
            _device.STAGE_MIN_BYTES = stage_min
            res = TN.cohort_msc_rotation_null(eeg, emg, 2048.0,
                                              overlap_upload=overlap, **kw)
            out[path] = {k: np.asarray(res[k]) for k in NULL_UPLOAD_KEYS}
            out[path]["counters"] = res["metadata"]["timings"]["counters"]
    finally:
        _device.STAGE_MIN_BYTES = threshold
    return out
