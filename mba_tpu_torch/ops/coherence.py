"""Multitaper magnitude-squared coherence (CMC) over all EEG×EMG pairs.

Port of ``mba_tpu/ops/coherence.py`` (:56-143, :164-204, :207-520).
The conventions are the JAX package's, which copies the reference
(signal_features.py:619-839, :484-578):

- taper set: k = 2·nw − 1 DPSS tapers, eigenvalue-filtered λ > 0.9,
  L2-normalised;
- PSD = |rfft|²/(fs·N), CSD = conj(EEG)·EMG/(fs·N), no one-sided doubling;
- coherence = |CSD̄|²/max(PSD̄ₑ·PSD̄ₘ, tiny) clipped to [0, 1];
- jackknife: leave-one-taper-out replicates computed algebraically as
  (total − x_k)/(K−1), mean in coherence space, variance in Fisher-z
  space, Student-t CI clamped to contain the mean.

Windows are a batch axis processed in chunks: frame (one gather) → taper
→ ``torch.fft.rfft`` → epilogue.  With the jackknife, the epilogue is
:func:`mba_tpu_torch.ops.cuda_msc.msc_jackknife`, which on a CUDA tensor
launches the fused kernel (B1) in both ``aggregate_emg_max`` modes, and
on a CPU tensor runs its plain version.  Without the jackknife the
epilogue is plain torch, as in the JAX package.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch
from scipy.stats import t as _t_dist

from mba_tpu_torch._device import (dtype_name, entry_device, synchronize,
                                   to_device)
from mba_tpu_torch.native.quantize import quantize_int16_per_channel
from mba_tpu_torch.ops.cuda_msc import (coherence_ratio, fisher_atanh,
                                        inverse_fisher_atanh, msc_jackknife)
from mba_tpu_torch.ops.dpss import (cmc_independence_threshold_host,
                                    filtered_tapers)
from mba_tpu_torch.ops.framing import (frame_signal, tapered_rfft,
                                        window_grid)
from mba_tpu_torch.utils.profiling import count, recording, span
from mba_tpu_torch.utils.transfer import download_quantized

__all__ = ["fisher_atanh", "inverse_fisher_atanh",
           "cmc_independence_threshold", "multitaper_msc",
           "max_cmc_over_channels"]


def cmc_independence_threshold(K: int, alpha: float = 0.05) -> float:
    """(1−alpha) quantile of the Beta(K−2, K−2) independence null."""
    return cmc_independence_threshold_host(K, alpha)


def jackknife_t_crit(K: int, alpha: float) -> float:
    """Two-sided Student-t critical value of the K-taper jackknife CI,
    rounded to float32 as the kernels take it."""
    return float(np.float32(_t_dist.ppf(1 - alpha / 2, K - 1)))


def _msc_chunk(eeg_frames: torch.Tensor, emg_frames: torch.Tensor,
               tapers: torch.Tensor, inv_fs_n: float, t_crit: float,
               use_jackknife: bool, aggregate_emg_max: bool) -> dict:
    """Coherence for one chunk of windows (``_msc_chunk_kernel``).

    eeg_frames: (w, S, E); emg_frames: (w, S, M); tapers: (K, S).
    Returns dict of (w, F, E, M) arrays — or (w, F, E) when
    ``aggregate_emg_max`` (CI-aligned argmax over EMG).
    """
    K = tapers.shape[0]
    eeg_fft = tapered_rfft(eeg_frames, tapers)
    emg_fft = tapered_rfft(emg_frames, tapers)
    if use_jackknife:
        return msc_jackknife(eeg_fft, emg_fft, t_crit,
                             emg_max=aggregate_emg_max, inv_fs_n=inv_fs_n)
    sum_e = (eeg_fft.real ** 2 + eeg_fft.imag ** 2).mul(inv_fs_n).sum(1)
    sum_m = (emg_fft.real ** 2 + emg_fft.imag ** 2).mul(inv_fs_n).sum(1)
    sum_c = (torch.conj(eeg_fft)[..., :, None]
             * emg_fft[..., None, :]).mul(inv_fs_n).sum(1)
    coherence_raw = coherence_ratio(sum_c / K, sum_e / K, sum_m / K)
    if aggregate_emg_max:
        coherence_raw = coherence_raw.amax(dim=-1)
    return {"coherence": coherence_raw}


def _auto_chunk(window_samples: int, K: int, n_eeg: int, n_emg: int,
                use_jackknife: bool, fused: bool,
                budget_bytes: float = 2.5e9) -> int:
    """Window-chunk size keeping transient device memory under budget.

    ``fused``: the CUDA epilogue holds only the spectra and the output,
    not the (K, F, E, M) leave-one-out tensors of the plain version.
    """
    n_freqs = window_samples // 2 + 1
    per_win = 2 * K * n_freqs * (n_eeg + n_emg) * 8 \
        + 2 * K * window_samples * (n_eeg + n_emg) * 4
    if fused:
        per_win += 3 * n_freqs * n_eeg * n_emg * 4
    else:
        per_win += K * n_freqs * n_eeg * n_emg * (24 if use_jackknife
                                                  else 10)
    return max(1, int(budget_bytes // max(per_win, 1)))


def _msc_all_windows(eeg, emg, starts, tapers, inv_fs_n, t_crit,
                     window_samples, chunk, use_jackknife,
                     aggregate_emg_max) -> dict:
    """The active window grid in chunks of ``chunk`` windows."""
    parts: dict[str, list] = {}
    for c0 in range(0, len(starts), chunk):
        with span("cmc.chunk"):
            cs = starts[c0:c0 + chunk]
            out = _msc_chunk(frame_signal(eeg, cs, window_samples),
                             frame_signal(emg, cs, window_samples),
                             tapers, inv_fs_n, t_crit, use_jackknife,
                             aggregate_emg_max)
            for key, val in out.items():
                parts.setdefault(key, []).append(val)
    return {key: torch.cat(vals) for key, vals in parts.items()}


def _transfer_kind(transfer_dtype):
    """``transfer_dtype`` → (None | 'int' | 'float', its numpy or torch
    type): int16/int8 take the quantized download, float16/bfloat16 a
    cast on the device, float32 and None neither."""
    name = "float32" if transfer_dtype is None else dtype_name(transfer_dtype)
    if name in ("int16", "int8"):
        return "int", np.dtype(name)
    if name in ("float16", "bfloat16"):
        return "float", getattr(torch, name)
    if name != "float32":
        raise ValueError("transfer_dtype must be float16, bfloat16, int16, "
                         f"int8, float32 or None, got {transfer_dtype!r}")
    return None, None


def _upload(x, axis: int, input_transfer, device,
            channels=None) -> torch.Tensor:
    """One signal on ``device`` as (n_samples, n_channels), in the type
    it crossed in.  ``channels``: the channels to keep, indices along the
    channel axis; on (samples, channels) input that is not quantized they
    are gathered on the way up (``_device.upload``), else taken here
    first.  With ``input_transfer='int16'`` host input other than int16
    is quantized per channel on the host first, after the selection
    (``coherence.py:349-363``)."""
    quantize = (input_transfer == "int16" and not isinstance(x, torch.Tensor)
                and np.asarray(x).dtype != np.int16)
    if channels is not None and (axis == 1 or quantize):
        x = (x[channels] if isinstance(x, torch.Tensor)     # axis 1
             else np.take(x, channels, axis=1 - axis))
        channels = None
    if quantize:
        x = np.asarray(x, np.float32)
        x = quantize_int16_per_channel(x.T if axis == 1 else x)
        axis = 0
    x = to_device(x, device, channels)
    return x.T if axis == 1 else x


def _runs(active: np.ndarray) -> list[tuple[int, int, int]]:
    """The runs of consecutive active windows, each as (its first window
    on the full grid, its first row among the active windows, length)."""
    cut = np.flatnonzero(np.diff(active) != 1) + 1
    firsts = np.concatenate(([0], cut))
    ends = np.concatenate((cut, [len(active)]))
    return [(int(active[a]), int(a), int(b - a))
            for a, b in zip(firsts, ends)]


def _write_runs(full: np.ndarray, rows: torch.Tensor, runs) -> None:
    """Copy each run of ``rows`` (one row an active window) into its
    rows of the full-grid ``full``, one copy a run; from a card tensor
    that copy is the download itself.  Counts the copies
    (``cmc.download_copies``)."""
    dst = torch.from_numpy(full)
    for w0, r0, n in runs:
        dst[w0:w0 + n].copy_(rows[r0:r0 + n])
    count("cmc.download_copies", len(runs))


def _download(device_out: dict, kind, td, n_active: int, full: dict,
              runs) -> tuple[dict, int]:
    """The results to the host, in the bytes of one download each:
    float32 straight into their rows of ``full``, one copy a run; cast
    to ``td`` on the device first into a host buffer of that type; or
    through the per-lane quantizer (``coherence.py:427-446``) into
    dequantized float32 rows.  Returns ({key: the host rows ``full``
    still lacks}, bytes)."""
    if kind == "int":
        staged, n_bytes = {}, 0
        for key, val in device_out.items():
            # per-(freq, channel) lanes where their sidecars (2·4 bytes a
            # lane) stay under a tenth of the integer payload, judged on
            # the active window count
            fine = 8.0 <= 0.1 * td.itemsize * n_active
            host, nb, _ = download_quantized(
                val, td, lane_ndim=val.ndim - 1 if fine else 1)
            staged[key] = torch.from_numpy(host)
            n_bytes += nb
        return staged, n_bytes
    if kind == "float":
        staged = {key: val.to(td).cpu() for key, val in device_out.items()}
        return staged, sum(v.numel() * v.element_size()
                           for v in staged.values())
    for key, val in device_out.items():
        _write_runs(full[key], val, runs)
    return {}, sum(v.numel() * v.element_size() for v in device_out.values())


def multitaper_msc(
        eeg_array,
        emg_array,
        sampling_freq: float,
        nw: float = 3,
        window_length_sec: float = 1.0,
        overlap_frac: float = 0.5,
        eeg_axis: Literal[0, 1] = 0,
        emg_axis: Literal[0, 1] = 0,
        taper_eigenvalue_threshold: float = 0.90,
        use_jackknife: bool = True,
        jackknife_alpha: float = 0.05,
        apply_independence_threshold: bool = True,
        apply_bonferroni_correction: bool = False,
        significance_level: float = 0.05,
        window_mask: np.ndarray | None = None,
        aggregate_emg_max: bool = False,
        window_chunk: int | None = None,
        freq_range: tuple | None = None,
        transfer_dtype=None,
        input_transfer: Literal[None, "int16"] = None,
        verbose: bool = False,
        collect_timings: bool = False,
        device=None,
        eeg_channels=None,
) -> dict:
    """Multitaper magnitude-squared coherence over all EEG×EMG pairs.

    Same arguments, window grid, taper policy, masking (skipped windows
    are zeros on the full grid) and result dictionary as
    ``mba_tpu.ops.coherence.multitaper_msc``; arrays come back as numpy.

    ``device``: where to compute.  Default: the device of a torch tensor
    input, else the card (``"cuda"``); without a card the call raises
    unless ``device="cpu"`` is given.  Integer ADC-count inputs
    (int16/int8) are accepted and cast to float32 on the device.

    ``transfer_dtype``: a float type (``np.float16``, ``torch.bfloat16``)
    casts each result on the device before the download; ``np.int16`` /
    ``np.int8`` download each result through the affine per-lane
    quantizer of ``utils.transfer.download_quantized``, with one lane per
    (frequency, EEG[, EMG]) cell where the sidecars cost at most a tenth
    of the payload (judged on the active window count), else one per
    channel.  The arithmetic stays float32 either way.
    ``input_transfer='int16'`` quantizes host float input per channel to
    int16 (``native.quantize_int16_per_channel``), uploads the integers
    and casts them to float32 on the device; coherence is invariant to
    the per-channel scale, so only the signal's rounding remains.  int16
    host input and tensors upload as they are.

    ``eeg_channels``: the EEG channels to use, indices along
    ``eeg_array``'s channel axis (default: all); the result is that of
    the selected array (``np.take(eeg_array, eeg_channels, axis=...)``),
    bit for bit.  A (samples, channels) host array's columns are gathered
    by the staging ring on their way to the card where it can take them
    (``_device.upload``), with no host copy of the selection.

    ``collect_timings`` records the call (``utils.profiling.recording``)
    and returns ``timings``: ``upload_sec``, ``compute_sec`` and
    ``download_sec``, each the sum of its span's seconds, the bytes that
    crossed each way, the span records (``spans``: the root ``cmc``;
    ``cmc.plan``, ``cmc.upload``, ``cmc.compute`` with one ``cmc.chunk``
    a window chunk, ``cmc.download``, ``cmc.scatter`` and
    ``cmc.threshold``) and the ``counters`` (``cmc.download_copies``, below).
    The upload and compute spans then end in a synchronise, so that they
    hold the card's work.  Without it the call reads no clock.  Called
    inside another entry point's recording, the call joins it: its
    ``cmc`` tree nests under the span open there, ``spans`` and
    ``counters`` are the outer call's tree, and the ``*_sec`` keys sums
    over it.

    The results land in full-grid float32 arrays made first with
    ``np.zeros``: each run of consecutive active windows is written into
    its rows with one copy a result (``cmc.download_copies`` counts them),
    so with no mask, or every window active, a float32 result is one
    download straight into place.  A 16-bit or quantized result downloads
    as one buffer, and its runs are converted into place on the host,
    the only work ``cmc.scatter`` holds.
    """
    with recording(collect_timings, join=True) as rec, span("cmc"):
        with span("cmc.plan"):
            if input_transfer not in (None, "int16"):
                raise ValueError(
                    f"unknown input_transfer {input_transfer!r}")
            td_kind, td = _transfer_kind(transfer_dtype)
            device = entry_device(device, eeg_array, emg_array)

            eeg_shape = tuple(np.shape(eeg_array))
            emg_shape = tuple(np.shape(emg_array))
            if len(eeg_shape) != 2 or len(emg_shape) != 2:
                raise ValueError("EEG/EMG arrays must be 2D")
            if eeg_axis == 1:
                eeg_shape = eeg_shape[::-1]
            if emg_axis == 1:
                emg_shape = emg_shape[::-1]
            n_samples, n_eeg = eeg_shape
            if eeg_channels is not None:
                n_eeg = len(eeg_channels)
            n_samples_m, n_emg = emg_shape
            if n_samples != n_samples_m:
                raise ValueError(
                    f"EEG and EMG must have same number of samples. "
                    f"Got EEG: {n_samples}, EMG: {n_samples_m}")

            window_samples = int(window_length_sec * sampling_freq)
            hop_samples = int(window_samples * (1 - overlap_frac))
            if hop_samples <= 0:
                raise ValueError(
                    "overlap_frac too high: hop_samples becomes <= 0")

            tapers = filtered_tapers(window_samples, nw,
                                     taper_eigenvalue_threshold)
            K = tapers.shape[0]
            if use_jackknife and K < 2:
                raise ValueError("jackknife requires at least 2 tapers")

            starts, time_centers = window_grid(
                n_samples, window_samples, hop_samples, sampling_freq,
                convention="cmc")
            n_windows = len(starts)
            freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)
            n_freqs = len(freqs)
            if freq_range is not None:
                f_lo, f_hi = freq_range
                # inclusive on both edges — matches the band aggregators'
                # rule
                f0 = int(np.searchsorted(freqs, f_lo, side="left"))
                f1 = int(np.searchsorted(freqs, f_hi, side="right"))
                if f1 <= f0:
                    raise ValueError(
                        f"freq_range {freq_range} selects no frequency bins "
                        f"(axis spans {freqs[0]:.3f}-{freqs[-1]:.3f} Hz)")
            else:
                f0, f1 = 0, n_freqs
            n_freqs_out = f1 - f0

            if window_mask is not None:
                window_mask = np.asarray(window_mask, dtype=bool)
                if window_mask.shape != (n_windows,):
                    raise ValueError(
                        f"window_mask must have shape ({n_windows},), "
                        f"got {window_mask.shape}")
                active = np.nonzero(window_mask)[0]
            else:
                active = np.arange(n_windows)
            n_active = len(active)
            if verbose:
                print(f"window_mask: {n_active}/{n_windows} windows will be "
                      f"computed ({100 * n_active / max(n_windows, 1):.1f}%)"
                      f" | K={K} tapers")

            t_crit = jackknife_t_crit(K, jackknife_alpha)
            inv_fs_n = float(np.float32(1.0 / (sampling_freq
                                               * window_samples)))
            fused = use_jackknife and device.type == "cuda"
            chunk = window_chunk or _auto_chunk(window_samples, K, n_eeg,
                                                n_emg, use_jackknife, fused)
            chunk = int(min(chunk, max(n_active, 1)))

        with span("cmc.upload"):
            eeg = _upload(eeg_array, eeg_axis, input_transfer, device,
                          eeg_channels)
            emg = _upload(emg_array, emg_axis, input_transfer, device)
            upload_bytes = sum(x.numel() * x.element_size()
                               for x in (eeg, emg))
            eeg, emg = eeg.to(torch.float32), emg.to(torch.float32)
            tapers_t = torch.as_tensor(tapers, dtype=torch.float32,
                                       device=device)
            if collect_timings:
                synchronize(device)

        tail = (n_freqs_out, n_eeg) if aggregate_emg_max \
            else (n_freqs_out, n_eeg, n_emg)
        # np.zeros leaves the pages of rows no copy writes untouched
        full = {key: np.zeros((n_windows,) + tail, np.float32)
                for key in (("coherence", "ci_lower", "ci_upper")
                            if use_jackknife else ("coherence",))}
        staged, dl_bytes = {}, 0
        if n_active > 0:
            runs = _runs(active)
            with span("cmc.compute"):
                device_out = _msc_all_windows(
                    eeg, emg, torch.as_tensor(starts[active], device=device),
                    tapers_t, inv_fs_n, t_crit, window_samples, chunk,
                    use_jackknife, aggregate_emg_max)
                if (f0, f1) != (0, n_freqs):
                    device_out = {key: val[:, f0:f1]
                                  for key, val in device_out.items()}
                if collect_timings:
                    synchronize(device)
            with span("cmc.download"):
                staged, dl_bytes = _download(device_out, td_kind, td,
                                             n_active, full, runs)

        with span("cmc.scatter"):
            for key, rows in staged.items():
                _write_runs(full[key], rows, runs)

        result = {
            "coherence_raw": full["coherence"],
            "time_centers": time_centers,
            "freqs": freqs[f0:f1],
            "metadata": {
                "K_tapers": int(K),
                "n_windows": int(n_windows),
                "n_active_windows": int(n_active),
                "window_length_sec": window_length_sec,
                "overlap_frac": overlap_frac,
                "use_jackknife": use_jackknife,
                "apply_independence_threshold": apply_independence_threshold,
                "apply_bonferroni_correction": apply_bonferroni_correction,
                "significance_level": significance_level,
                "freq_range": freq_range,
            },
        }
        if use_jackknife:
            result["coherence_ci_lower"] = full["ci_lower"]
            result["coherence_ci_upper"] = full["ci_upper"]

        if apply_independence_threshold:
            with span("cmc.threshold"):
                n_comp = n_eeg * n_emg
                alpha_adj = (max(significance_level / n_comp, 1e-10)
                             if apply_bonferroni_correction
                             else significance_level)
                it = cmc_independence_threshold_host(K, alpha=alpha_adj)
                result["coherence_significant"] = \
                    result["coherence_raw"] > it
                result["metadata"]["IT_unadjusted"] = float(
                    cmc_independence_threshold_host(
                        K, alpha=significance_level))
                if apply_bonferroni_correction:
                    result["metadata"]["IT_bonferroni"] = float(it)
                    result["metadata"]["n_comparisons"] = n_comp
                result["metadata"]["n_significant"] = int(
                    result["coherence_significant"].sum())

        if rec is not None:
            # each time is the sum of its spans
            result["timings"] = {
                "upload_sec": rec.seconds("cmc.upload"),
                "upload_bytes": int(upload_bytes),
                "compute_sec": rec.seconds("cmc.compute"),
                "download_sec": rec.seconds("cmc.download"),
                "download_bytes": int(dl_bytes), **rec.timings()}
        return result


def max_cmc_over_channels(cmc_array, lower=None, upper=None,
                          channel_ax: int = 3, verbose: bool = False):
    """Joint EMG-channel max with CI-aligned indices (host numpy).

    Parity: reference signal_features.py:1132-1171.  Prefer
    ``aggregate_emg_max=True`` in :func:`multitaper_msc`, which fuses this
    into the kernel; this host version serves stored spectrograms.
    """
    max_idx = np.argmax(cmc_array, axis=channel_ax)
    take = lambda a: np.take_along_axis(
        a, np.expand_dims(max_idx, channel_ax), axis=channel_ax
    ).squeeze(axis=channel_ax)
    maxed = take(cmc_array)
    if lower is None or upper is None:
        return maxed
    return maxed, take(lower), take(upper)
