"""High-level biosignal feature extraction (port of
``mba_tpu/pipeline/signal_features.py`` up to :781).

Every public symbol of that part keeps its name and semantics; the dense
numerics are the port's :mod:`mba_tpu_torch.ops`:

- :func:`multitaper_psd` → ``ops.spectral.multitaper_psd``;
- :func:`jackknife_coherence_and_ci` → ``ops.coherence._msc_chunk``, the
  full-grid mode of kernel B1 on a CUDA tensor;
- :func:`compute_task_wise_aggregated_cmc` → ``ops.coherence.
  multitaper_msc``: kernel B1 in its fused EMG-max mode, or, with
  ``enforce_independence_threshold``, in its full-grid mode followed by
  the host :func:`max_cmc_over_channels`;
- :func:`band_aggregate_spectrogram` reduces a torch tensor on its
  device and a numpy array on the host.

Each function that computes takes ``device=`` (default: the device of a
tensor input, else the CPU) and returns numpy, except
``multitaper_psd(device_output=True)`` and the device path of
``band_aggregate_spectrogram``, which return tensors on the device.

Not in this slice (ROADMAP A-list): the serial-sensor features
(``compute_heart_rate_and_variability``, ``compute_task_wise_scaled_
force``, ``compute_feature_mi_importance``, ``signal_features.py:786``
on).  pandas is imported only where an experiment log is read.
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Literal

import numpy as np
import torch

from mba_tpu_torch._device import resolve_device, to_device
from mba_tpu_torch.channel_layout import (EEG_CHANNEL_IND_DICT,
                                          mirror_eeg_channel_list)  # noqa: F401
from mba_tpu_torch.ops.coherence import (_msc_chunk, jackknife_t_crit,
                                         multitaper_msc,
                                         cmc_independence_threshold,
                                         max_cmc_over_channels)
from mba_tpu_torch.ops.framing import resample_linear
from mba_tpu_torch.ops.spectral import (multitaper_psd as _multitaper_psd_op,
                                        spectral_snr, amplitude_spectrum)
from mba_tpu_torch.utils import file_management as filemgmt

FREQUENCY_BANDS = {
    'delta': (0.5, 4),
    'theta': (4, 8),
    'alpha': (8, 12),
    'beta': (13, 30),
    'gamma': (30, 100),  # EEG gamma range
}


# --------------------------------------------------------------------------
# thin wrappers over ops (reference-identical signatures, plus device)
# --------------------------------------------------------------------------
def check_2d_numpy_array(input_array: np.ndarray,
                         axis: Literal[0, 1] | None = None
                         ) -> tuple[np.ndarray, Literal[0, 1]]:
    """Promote 1-D input to a (n, 1) column and resolve ``axis``.

    1-D arrays get a channel axis and ``axis=0``; 2-D arrays require an
    explicit ``axis``.
    """
    input_array = np.asarray(input_array)
    if input_array.ndim == 1:
        input_array = input_array[:, np.newaxis]
        if axis is None:
            axis = 0
    elif axis is None:
        raise AttributeError("For 2D signal arrays, axis needs to be "
                             "defined!")
    return input_array, axis


def resample_data(data, original_sampling_freq, new_sampling_freq,
                  axis: Literal[0, 1] | None = None, device=None):
    """Linear-interpolation resampling (reference signal_features.py:40),
    in float32 on ``device``; returns numpy.  1-D input stays 1-D; 2-D
    input needs ``axis``."""
    device = resolve_device(device, data)
    x = to_device(data, device).to(torch.float32)
    transpose = x.ndim == 2 and axis == 1
    if x.ndim == 2 and axis is None:
        raise AttributeError("For 2D signal arrays, axis needs to be "
                             "defined!")
    out = resample_linear(x.T if transpose else x, original_sampling_freq,
                          new_sampling_freq).cpu().numpy()
    return out.T if transpose else out


def jackknife_coherence_and_ci(tapers_filtered,
                               eeg_window,
                               emg_window,
                               sampling_freq: float,
                               window_samples: int,
                               jackknife_alpha: float = 0.05,
                               device=None) -> tuple:
    """Leave-one-taper-out jackknife for one window (reference
    signal_features.py:484-578): mean in coherence space, variance in
    Fisher-z space, Student-t CI clamped to contain the mean.

    eeg_window (S, E), emg_window (S, M) → (coherence, ci_lower,
    ci_upper), each (F, E, M) numpy.  On a CUDA device this is kernel B1
    in its full-grid mode (it launches or raises); on the CPU its plain
    version.
    """
    device = resolve_device(device, eeg_window, emg_window)
    tapers = torch.as_tensor(tapers_filtered, dtype=torch.float32,
                             device=device)
    K = tapers.shape[0]
    t_crit = jackknife_t_crit(K, jackknife_alpha)
    inv_fs_n = float(np.float32(1.0 / (sampling_freq * window_samples)))
    eeg = to_device(eeg_window, device).to(torch.float32)
    emg = to_device(emg_window, device).to(torch.float32)
    out = _msc_chunk(eeg[None], emg[None], tapers, inv_fs_n, t_crit,
                     use_jackknife=True, aggregate_emg_max=False)
    return tuple(out[key][0].cpu().numpy()
                 for key in ("coherence", "ci_lower", "ci_upper"))


def fisher_atanh_transform(coherence: np.ndarray,
                           eps: float = 1e-10) -> np.ndarray:
    """Forward Fisher atanh: C² → z (reference :459-462)."""
    c = np.clip(coherence, eps, 1 - eps)
    return 0.5 * np.log((1 + c) / (1 - c))


def inverse_fisher_atanh(z: np.ndarray) -> np.ndarray:
    """Inverse Fisher atanh: z → C² (reference :465-467)."""
    return np.tanh(z) ** 2


def compute_cmc_independence_threshold(K: int, alpha: float = 0.05) -> float:
    """Beta(K−2, K−2) (1−alpha) quantile (reference :470-481)."""
    return cmc_independence_threshold(K, alpha)


def apply_threshold_filtering(coherence_values: np.ndarray, K: int,
                              alpha: float = 0.05,
                              n_comparisons: int | None = None,
                              apply_bonferroni: bool = False):
    """Independence-threshold mask with optional Bonferroni (ref :581-604)."""
    if apply_bonferroni and n_comparisons is not None:
        alpha = max(alpha / n_comparisons, 1e-10)
    it = compute_cmc_independence_threshold(K, alpha=alpha)
    return coherence_values > it, it


def multitaper_psd(input_array, sampling_freq: float, nw: float = 3,
                   window_length_sec: float = 1.0, overlap_frac: float = 0.5,
                   axis: Literal[0, 1] | None = None,
                   apply_log_scale: bool = True,
                   psd_save_dir: str | Path | None = None,
                   psd_file_suffix: str = "", device_output: bool = False,
                   device=None, **_ignored):
    """DPSS multitaper sliding-window PSD (reference :80-454).

    ``device_output=True`` keeps the spectrogram on the device as a
    tensor (the save path, if requested, still downloads it once)."""
    spectrograms, time_centers, freqs = _multitaper_psd_op(
        input_array, sampling_freq, nw=nw,
        window_length_sec=window_length_sec, overlap_frac=overlap_frac,
        axis=axis, apply_log_scale=apply_log_scale,
        device_output=device_output, device=device)
    if psd_save_dir is not None:
        save_spectrograms(spectrograms, time_centers, freqs, "PSD",
                          save_dir=psd_save_dir,
                          identifier_suffix=psd_file_suffix)
    return spectrograms, time_centers, freqs


def multitaper_magnitude_squared_coherence(eeg_array, emg_array,
                                           sampling_freq, **kwargs) -> dict:
    """Full EEG×EMG multitaper MSC (reference :619-839)."""
    return multitaper_msc(eeg_array, emg_array, sampling_freq, **kwargs)


def compute_spectral_snr(input_array, sampling_freq,
                         target_freq: float = 21.5,
                         freq_window: float = 8.5,
                         target_band_ratio: float = 0.5,
                         axis: Literal[0, 1] = 0,
                         return_psd: bool = False, device=None):
    """Welch-based SNR at a target frequency (reference :2069-2130)."""
    return spectral_snr(input_array, sampling_freq, target_freq,
                        freq_window, target_band_ratio, axis, return_psd,
                        device=device)


def discrete_fourier_transform(input_array, sampling_freq,
                               axis: Literal[0, 1] = 0,
                               plot_result: bool = False, device=None,
                               **_plot_kwargs):
    """Positive-frequency amplitude spectrum (reference :2133-2185)."""
    return amplitude_spectrum(input_array, sampling_freq, axis,
                              device=device)


# --------------------------------------------------------------------------
# task-selective CMC
# --------------------------------------------------------------------------
def _build_task_window_mask(time_centers_sec: np.ndarray,
                            log_frame,
                            pre_buffer_sec: float,
                            post_buffer_sec: float,
                            verbose: bool = True,
                            task_latency_assumption_sec: float = 3.25,
                            task_end_cutoff_sec: float = 2.0
                            ) -> np.ndarray:
    """Boolean mask of windows whose centre falls inside a buffered task.

    Parity: reference :842-895 — trial spans and measurement start come
    from the experiment log (a pandas frame); everything is compared in
    float seconds from recording start.
    """
    import pandas as pd

    from mba_tpu_torch.pipeline import data_integration
    from mba_tpu_torch.pipeline.data_analysis import make_timezone_aware

    measurement_start, _ = data_integration.get_qtc_measurement_start_end(
        log_frame)
    measurement_start = make_timezone_aware(pd.Timestamp(measurement_start))
    trial_start_ends = data_integration.get_all_task_start_ends(
        log_frame, output_type='list',
        assumed_latency_sec=task_latency_assumption_sec,
        cut_off_sec_to_prevent_transients=task_end_cutoff_sec)
    return task_window_mask_from_spans(
        time_centers_sec, trial_start_ends, measurement_start,
        pre_buffer_sec, post_buffer_sec, verbose=verbose)


def task_window_mask_from_spans(time_centers_sec: np.ndarray,
                                trial_start_ends: list[tuple],
                                measurement_start,
                                pre_buffer_sec: float,
                                post_buffer_sec: float,
                                verbose: bool = True) -> np.ndarray:
    """Mask construction from explicit trial spans (testable core).

    Spans and ``measurement_start`` are timestamps whose differences
    have ``total_seconds()`` (``pd.Timestamp`` or ``datetime``)."""
    mask = np.zeros(len(time_centers_sec), dtype=bool)
    for trial_start, trial_end in trial_start_ends:
        t0 = ((trial_start - measurement_start).total_seconds()
              - pre_buffer_sec)
        t1 = ((trial_end - measurement_start).total_seconds()
              + post_buffer_sec)
        mask |= (time_centers_sec >= t0) & (time_centers_sec <= t1)
    if verbose:
        n_active = int(mask.sum())
        print(f"Task window mask: {n_active}/{len(mask)} windows selected "
              f"({100 * n_active / max(len(mask), 1):.1f}%) across "
              f"{len(trial_start_ends)} trials "
              f"[±{pre_buffer_sec}s / +{post_buffer_sec}s buffers]")
    return mask


def compute_task_wise_aggregated_cmc(
        eeg_array,
        emg_array,
        sampling_freq: int,
        muscle_group: str,
        log_frame=None,
        eeg_channel_subset: list[str] | None = None,
        window_size_sec: float = 2.0,
        window_overlap_ratio: float = 0.5,
        enforce_independence_threshold: bool = False,
        independence_threshold_alpha: float = 0.2,
        use_jackknife: bool = True,
        jackknife_alpha: float = 0.05,
        save_dir: str | Path | None = None,
        pre_trial_computation_buffer_sec: float = 3.0,
        post_trial_computation_buffer_sec: float = 3.0,
        window_mask: np.ndarray | None = None,
        task_latency_assumption_sec: float = 3.25,
        task_end_cutoff_sec: float = 2.0,
        timings_out: dict | None = None,
        transfer_dtype=None,
        freq_range: tuple | None = None,
        device=None,
) -> tuple:
    """EMG-max-aggregated task-selective CMC (reference :898-1026).

    One global sliding-window grid; windows outside buffered task periods
    are skipped (zeros).  The EMG-channel max with CI-aligned indices is
    fused into kernel B1 unless the independence-threshold masking is
    requested (which the reference applies to the un-aggregated tensor).
    ``freq_range=(lo, hi)`` slices the coherence grid to the band on the
    device before download.  ``transfer_dtype`` other than float32
    raises ``NotImplementedError``, as in ``multitaper_msc``.
    """
    if eeg_channel_subset:
        inds = [EEG_CHANNEL_IND_DICT[ch] for ch in eeg_channel_subset]
        print(f"Reducing EEG to {len(eeg_channel_subset)} channels: "
              f"{eeg_channel_subset}")
        eeg_array = eeg_array[:, inds]

    n_samples_eeg, _ = eeg_array.shape
    n_samples_emg, _ = emg_array.shape
    if n_samples_eeg != n_samples_emg:
        raise ValueError(
            f"EEG and EMG must have same number of samples. "
            f"Got EEG: {n_samples_eeg}, EMG: {n_samples_emg}")

    if log_frame is not None and window_mask is None:
        window_samples = int(window_size_sec * sampling_freq)
        hop_samples = int(window_samples * (1 - window_overlap_ratio))
        if hop_samples <= 0:
            raise ValueError(
                "window_overlap_ratio too high: hop_samples becomes <= 0")
        n_windows = (n_samples_eeg - window_samples) // hop_samples + 1
        time_centers_preview = ((np.arange(n_windows) * hop_samples
                                 + window_samples / 2) / sampling_freq)
        window_mask = _build_task_window_mask(
            time_centers_preview, log_frame,
            pre_buffer_sec=pre_trial_computation_buffer_sec,
            post_buffer_sec=post_trial_computation_buffer_sec,
            task_latency_assumption_sec=task_latency_assumption_sec,
            task_end_cutoff_sec=task_end_cutoff_sec)

    # reference applies the significance mask BEFORE the EMG max, so the
    # fused aggregation is only used when thresholding is off
    fuse = not enforce_independence_threshold
    output = multitaper_msc(
        eeg_array, emg_array, sampling_freq=sampling_freq,
        window_length_sec=window_size_sec,
        overlap_frac=window_overlap_ratio,
        significance_level=independence_threshold_alpha,
        apply_independence_threshold=enforce_independence_threshold,
        use_jackknife=use_jackknife, jackknife_alpha=jackknife_alpha,
        window_mask=window_mask, aggregate_emg_max=fuse, verbose=True,
        collect_timings=timings_out is not None,
        transfer_dtype=transfer_dtype, freq_range=freq_range, device=device)
    if timings_out is not None:
        timings_out.update(output.get('timings', {}))
        # the kept taper count: the Beta(K−2, K−2) independence threshold
        # (reference :470-481) needs it downstream
        timings_out['K_tapers'] = output['metadata']['K_tapers']

    time_centers = output['time_centers']
    freqs = output['freqs']

    if fuse:
        values = output['coherence_raw']
        if use_jackknife:
            values_lower = output['coherence_ci_lower']
            values_upper = output['coherence_ci_upper']
    else:
        masked = np.where(output['coherence_significant'],
                          output['coherence_raw'], 0.0)
        if use_jackknife:
            values, values_lower, values_upper = \
                max_cmc_over_channels(masked,
                                      output['coherence_ci_lower'],
                                      output['coherence_ci_upper'])
        else:
            values = max_cmc_over_channels(masked)

    if save_dir is not None:
        channel_suffix = (f"Channels_{'_'.join(eeg_channel_subset)}"
                          if eeg_channel_subset else "All_Channels")
        label = (f"{muscle_group.capitalize()} CMC"
                 f"{' Trial-wise' if window_mask is not None else ''}")
        save_spectrograms(values, time_centers, freqs, save_dir=save_dir,
                          modality=label, identifier_suffix=channel_suffix)

    if use_jackknife:
        return values, values_lower, values_upper, time_centers, freqs
    return values, time_centers, freqs


# --------------------------------------------------------------------------
# spectrogram persistence (timestamped artifact store)
# --------------------------------------------------------------------------
def save_spectrograms(spectrograms, time_centers: np.ndarray,
                      frequencies: np.ndarray, modality: str,
                      save_dir: str | Path, identifier_suffix: str = "",
                      save_dtype=None):
    """Persist (spectrograms, timecenters, frequencies) triplet (ref :1033).

    A device tensor is downloaded once.  ``save_dtype`` (e.g.
    ``np.float16``) casts the big spectrogram array before writing —
    halves the disk bytes for log10 PSD artifacts whose values fit in f16
    (|log10 PSD| < 20 ⇒ abs error ≤ ~0.01 log units); ``np.load``
    consumers upcast transparently.  Default ``None`` keeps the input
    dtype (float32, the reference's on-disk format).
    """
    save_dir = Path(save_dir)
    if isinstance(spectrograms, torch.Tensor):
        spectrograms = spectrograms.cpu().numpy()
    if save_dtype is not None:
        spectrograms = np.asarray(spectrograms, dtype=save_dtype)
    diffs = np.diff(time_centers)
    step = np.nanmin(np.where(diffs > 0, diffs, np.nan)) if len(diffs) \
        else 0.0
    sfx = f" {identifier_suffix}" if identifier_suffix else ""
    for obj, title in [
        (spectrograms,
         f"{modality} Spectrograms {spectrograms.shape[2]}ch "
         f"{step:.2f}sec_step{sfx}"),
        (time_centers, f"{modality} Timecenters {len(time_centers)}windows"
                       f"{sfx}"),
        (frequencies, f"{modality} Frequencies {len(frequencies)}freqs"
                      f"{sfx}"),
    ]:
        np.save(save_dir / filemgmt.file_title(title, ".npy"), obj)
    print(f"Saved {modality} spectrograms of shape {spectrograms.shape} "
          f"to {save_dir}")


def fetch_stored_spectrograms(dir: Path | str, modality: str,
                              file_identifier=None,
                              expected_n_channels: int | None = None):
    """Load the most recent (spectrograms, timecenters, frequencies)
    triplet matching keywords (reference :1050-1100)."""
    ids = ([file_identifier] if isinstance(file_identifier, str)
           else file_identifier if file_identifier is not None else [])
    spectrograms = np.load(filemgmt.most_recent_file(
        dir, ".npy", [modality, "Spectrograms"] + ids))
    if spectrograms.dtype == np.float16:
        # storage-only dtype (save_spectrograms save_dtype=f16):
        # upcast so downstream reductions accumulate in f32
        spectrograms = spectrograms.astype(np.float32)
    if expected_n_channels is not None and spectrograms.ndim >= 3:
        if spectrograms.shape[2] != expected_n_channels:
            raise ValueError(
                f"fetch_stored_spectrograms: expected {expected_n_channels} "
                f"channels on axis 2 but loaded "
                f"{spectrograms.shape[2]} "
                f"(modality={modality!r}, "
                f"file_identifier={file_identifier!r}).")
    timecenters = np.load(filemgmt.most_recent_file(
        dir, ".npy", [modality, "Timecenters"] + ids))
    frequencies = np.load(filemgmt.most_recent_file(
        dir, ".npy", [modality, "Frequencies"] + ids))
    return spectrograms, timecenters, frequencies


def max_cmc_spectrograms_over_channels(cmc_array, cmc_array_lower_ci=None,
                                       cmc_array_upper_ci=None,
                                       channel_ax: int = 3,
                                       verbose: bool = True):
    """Joint EMG-channel max with CI-aligned indices (reference :1132)."""
    if verbose:
        print("Maxing CMC values over EMG channels (aligned)...")
    return max_cmc_over_channels(cmc_array, cmc_array_lower_ci,
                                 cmc_array_upper_ci, channel_ax=channel_ax)


# --------------------------------------------------------------------------
# aggregators (host numpy)
# --------------------------------------------------------------------------
def aggregate_spectrogram_over_frequency_band(
        spectrograms: np.ndarray,
        freqs: np.ndarray,
        behaviour: Literal['max', 'mean'] = 'mean',
        frequency_bands: dict | None = None,
        log_transform: bool = False,
        log_epsilon: float = 1e-10,
        frequency_axis: int = 1,
        pre_aggregate_axis: tuple[int, str] | None = None,
        lower_array: np.ndarray | None = None,
        upper_array: np.ndarray | None = None) -> dict:
    """Per-band aggregation with CI-coherent argmax (reference :1174-1371).

    Bands are half-open ``[low, high)``.  DELIBERATE DEVIATION from the
    reference, kept from the JAX package: the reference selects band bins
    with ``np.take(spectrograms, boolean_mask, axis=...)``
    (signal_features.py:1292), which NumPy reads as integer indices 0/1,
    so it aggregates frequency bins 0 and 1 for EVERY band.  This
    implementation uses ``np.compress`` (true boolean selection).
    """
    if frequency_bands is None:
        frequency_bands = FREQUENCY_BANDS
    min_ndim = 2 + int(pre_aggregate_axis is not None)
    if spectrograms.ndim < min_ndim:
        raise ValueError(
            f"spectrograms must have at least {min_ndim} dimensions, got "
            f"shape {spectrograms.shape}")
    if (lower_array is None) != (upper_array is None):
        raise ValueError(
            "lower_array and upper_array must both be provided or both be "
            "None")
    has_bounds = lower_array is not None
    if has_bounds and (lower_array.shape != spectrograms.shape
                       or upper_array.shape != spectrograms.shape):
        raise ValueError("bounds arrays must match spectrograms shape")
    if len(freqs) != spectrograms.shape[frequency_axis]:
        raise ValueError(
            f"freqs length ({len(freqs)}) must match spectrograms frequency "
            f"axis ({spectrograms.shape[frequency_axis]})")
    if not frequency_bands:
        raise ValueError("frequency_bands dict cannot be empty")

    if pre_aggregate_axis is not None:
        ax, beh = pre_aggregate_axis
        red = {'max': np.max, 'mean': np.mean}.get(beh)
        if red is None:
            raise ValueError(
                f"Unknown behavior for pre_aggregate_axis '{beh}'")
        spectrograms = red(spectrograms, axis=ax, keepdims=True)
        if has_bounds:
            lower_array = red(lower_array, axis=ax, keepdims=True)
            upper_array = red(upper_array, axis=ax, keepdims=True)

    out = {}
    for band_label, (min_freq, max_freq) in frequency_bands.items():
        if min_freq < freqs.min() or max_freq > freqs.max():
            raise ValueError(
                f"Band '{band_label}' range ({min_freq}, {max_freq}) "
                f"exceeds available frequencies "
                f"({freqs.min():.2f}, {freqs.max():.2f})")
        band_sel = (freqs >= min_freq) & (freqs < max_freq)
        subset = np.compress(band_sel, spectrograms, axis=frequency_axis)
        if log_transform:
            subset = np.log10(subset + log_epsilon)
        if has_bounds:
            lo_sub = np.compress(band_sel, lower_array, axis=frequency_axis)
            hi_sub = np.compress(band_sel, upper_array, axis=frequency_axis)

        if behaviour == 'max':
            idx = np.argmax(subset, axis=frequency_axis, keepdims=True)
            condensed = np.take_along_axis(subset, idx, axis=frequency_axis)
            if has_bounds:
                c_lo = np.take_along_axis(lo_sub, idx, axis=frequency_axis)
                c_hi = np.take_along_axis(hi_sub, idx, axis=frequency_axis)
        elif behaviour == 'mean':
            condensed = np.mean(subset, axis=frequency_axis, keepdims=True)
            if has_bounds:
                c_lo = np.mean(lo_sub, axis=frequency_axis, keepdims=True)
                c_hi = np.mean(hi_sub, axis=frequency_axis, keepdims=True)
        else:
            raise ValueError(f"Unknown behaviour '{behaviour}'")

        squeeze_axes = ((frequency_axis, pre_aggregate_axis[0])
                        if pre_aggregate_axis is not None
                        else frequency_axis)
        condensed = np.squeeze(condensed, axis=squeeze_axes)
        if has_bounds:
            out[band_label] = (condensed,
                               np.squeeze(c_lo, axis=squeeze_axes),
                               np.squeeze(c_hi, axis=squeeze_axes))
        else:
            out[band_label] = condensed
    return out


# named frequency slices of the PSD aggregator (reference :1374-1502's
# inline band table); shared with the band-aggregate artifact layer below
# so both code paths select the SAME inclusive [low, high] bins
AGGREGATE_BANDS = {'all': (0, 250), 'slow': (0, 40), 'fast': (60, 250),
                   'delta': (0.5, 4), 'theta': (4, 8), 'alpha': (8, 12),
                   'beta': (13, 30), 'gamma': (30, 100)}


def aggregate_psd_spectrogram(psd_spectrograms: np.ndarray,
                              psd_freqs: np.ndarray = None,
                              normalize_mvc: bool = False,
                              is_log_scaled: bool = False,
                              freq_slice=None,
                              channel_indices: list[int] = None,
                              aggregation_ops: list[tuple] = None
                              ) -> np.ndarray:
    """Multi-stage PSD aggregation (reference :1374-1502).

    Order: MVC normalisation → frequency slice (inclusive ``[low,
    high]``) → channel slice → sequential mean/max reductions.
    """
    bands = AGGREGATE_BANDS
    result = psd_spectrograms.copy()
    if normalize_mvc and not is_log_scaled:
        mvc = np.max(np.max(result, axis=0, keepdims=True), axis=1,
                     keepdims=True)
        result = result / mvc * 100
    if freq_slice is not None:
        if psd_freqs is None:
            raise ValueError(
                "psd_freqs must be provided when using freq_slice")
        if isinstance(freq_slice, str):
            if freq_slice not in bands:
                raise ValueError(
                    f"Unknown frequency band '{freq_slice}'. Available "
                    f"bands: {', '.join(bands)}")
            low, high = bands[freq_slice]
        else:
            low, high = freq_slice
        result = result[:, (psd_freqs >= low) & (psd_freqs <= high), :]
    if channel_indices is not None:
        result = result[:, :, channel_indices]
    if aggregation_ops is not None:
        for operator, axis in aggregation_ops:
            if operator == 'mean':
                result = np.nanmean(result, axis=axis)
            elif operator == 'max':
                result = np.nanmax(result, axis=axis)
            else:
                raise ValueError(
                    f"Unknown operator '{operator}'. Supported operators: "
                    f"'mean', 'max'")
    return result


# --------------------------------------------------------------------------
# band-aggregate artifacts (lean feature store)
# --------------------------------------------------------------------------
class BandAggregates:
    """Per-band {mean, max}-over-frequency reduction of a spectrogram.

    Every downstream consumer of a full ``(windows, freqs, channels)``
    spectrogram (the statistics frame's hypothesis aggregates,
    the CBPA band-power extraction) reduces it to one named band at
    once, so the artifact stores only ``(windows, n_bands, channels,
    2[mean|max])``.  Band selection uses the same inclusive ``[low,
    high]`` bins as :func:`aggregate_psd_spectrogram`
    (``AGGREGATE_BANDS``), and the stored per-(window, channel) band
    mean/max commutes with the channel-axis reductions applied
    downstream.
    """

    STAT_INDEX = {'mean': 0, 'max': 1}

    def __init__(self, payload: np.ndarray, time_centers: np.ndarray,
                 band_names: list[str], band_edges: np.ndarray,
                 modality: str = ""):
        payload = np.asarray(payload)
        if payload.ndim != 4 or payload.shape[3] != 2:
            raise ValueError(
                f"BandAggregates payload must be (windows, bands, "
                f"channels, 2), got {payload.shape}")
        if payload.shape[1] != len(band_names):
            raise ValueError(
                f"payload has {payload.shape[1]} bands but "
                f"{len(band_names)} band names given")
        self.payload = payload
        self.time_centers = np.asarray(time_centers)
        self.band_names = list(band_names)
        self.band_edges = np.asarray(band_edges, dtype=np.float64)
        self.modality = modality

    @property
    def n_windows(self) -> int:
        return self.payload.shape[0]

    @property
    def n_channels(self) -> int:
        return self.payload.shape[2]

    def select(self, band: str, stat: Literal['mean', 'max'],
               channel_indices: list[int] | None = None) -> np.ndarray:
        """(windows, channels) band values — the downstream working set."""
        if band not in self.band_names:
            raise ValueError(
                f"Band '{band}' not stored in this artifact "
                f"(available: {self.band_names})")
        if stat not in self.STAT_INDEX:
            raise ValueError(f"Unknown stat '{stat}' (mean|max)")
        out = self.payload[:, self.band_names.index(band), :,
                           self.STAT_INDEX[stat]]
        if channel_indices is not None:
            out = out[:, channel_indices]
        return out


def _band_agg_device(spec: torch.Tensor, spans: tuple) -> torch.Tensor:
    """(windows, freqs, channels) → (windows, bands, channels, 2) band
    reduction on ``spec``'s device over static contiguous frequency
    spans.  NaN-aware: the host path's nanmean / nanmax, with an all-NaN
    band giving NaN.  The mean sums in float64 (no float64 copy is made):
    the host's pairwise float32 sum then differs from it by its own
    rounding only, well inside 1e-6, where a float32 sum in the device's
    order could differ by more."""
    cols = []
    for lo, hi in spans:
        sub = spec[:, lo:hi]
        nan = torch.isnan(sub)
        mean = (torch.nansum(sub, dim=1, dtype=torch.float64)
                / (~nan).sum(dim=1)).to(spec.dtype)
        mx = torch.where(nan.all(dim=1), torch.nan,
                         torch.where(nan, -torch.inf, sub).amax(dim=1))
        cols.append(torch.stack([mean, mx], dim=-1))
    return torch.stack(cols, dim=1)


def band_aggregate_spectrogram(spectrogram, freqs,
                               bands: dict | None = None):
    """Reduce (windows, freqs, channels) → (windows, bands, channels, 2).

    Stat axis is ``[mean, max]`` over the band's frequency bins, selected
    with the same inclusive ``(freqs >= low) & (freqs <= high)`` rule as
    :func:`aggregate_psd_spectrogram`.  A torch tensor is reduced on its
    device and the payload comes back there, as a tensor; anything else
    is reduced on the host (NaN-aware, as the aggregator's
    nanmean/nanmax).  Bands whose range has no bin on the frequency axis
    are dropped.  Returns (payload, band names, band edges).
    """
    if bands is None:
        bands = AGGREGATE_BANDS
    freqs = np.asarray(freqs)
    names, edges, masks = [], [], []
    for name, (low, high) in bands.items():
        sel = (freqs >= low) & (freqs <= high)
        if not sel.any():
            continue
        names.append(name)
        edges.append((low, high))
        masks.append(sel)
    if not names:
        raise ValueError("No requested band overlaps the frequency axis")

    if isinstance(spectrogram, torch.Tensor):
        # bands are contiguous on a monotone frequency axis: one slice each
        spans = tuple((int(np.flatnonzero(sel)[0]),
                       int(np.flatnonzero(sel)[-1]) + 1)
                      for sel in masks)
        payload = _band_agg_device(spectrogram, spans)
    else:
        spectrogram = np.asarray(spectrogram)
        cols = []
        with np.errstate(all='ignore'), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for sel in masks:
                sub = np.compress(sel, spectrogram, axis=1)
                cols.append(np.stack([np.nanmean(sub, axis=1),
                                      np.nanmax(sub, axis=1)], axis=-1))
        payload = np.stack(cols, axis=1)
    return payload, names, np.asarray(edges, dtype=np.float64)


def save_band_aggregates(payload, time_centers: np.ndarray,
                         band_names: list[str], band_edges: np.ndarray,
                         modality: str, save_dir: str | Path,
                         identifier_suffix: str = "") -> Path:
    """Persist a :class:`BandAggregates` artifact (single ``.npz``); a
    device tensor payload is downloaded."""
    save_dir = Path(save_dir)
    if isinstance(payload, torch.Tensor):
        payload = payload.cpu().numpy()
    payload = np.asarray(payload, dtype=np.float32)
    sfx = f" {identifier_suffix}" if identifier_suffix else ""
    title = (f"{modality} Band Aggregates {payload.shape[2]}ch "
             f"{payload.shape[1]}bands{sfx}")
    path = save_dir / filemgmt.file_title(title, ".npz")
    np.savez(path, payload=payload,
             time_centers=np.asarray(time_centers),
             band_names=np.asarray(band_names),
             band_edges=np.asarray(band_edges, dtype=np.float64))
    print(f"Saved {modality} band aggregates of shape {payload.shape} "
          f"to {path}")
    return path


def fetch_band_aggregates(dir: Path | str, modality: str,
                          file_identifier=None) -> BandAggregates:
    """Load the most recent band-aggregate artifact matching keywords."""
    ids = ([file_identifier] if isinstance(file_identifier, str)
           else file_identifier if file_identifier is not None else [])
    path = filemgmt.most_recent_file(
        dir, ".npz", [modality, "Band Aggregates"] + ids)
    with np.load(path, allow_pickle=False) as z:
        return BandAggregates(
            z["payload"].astype(np.float32), z["time_centers"],
            [str(s) for s in z["band_names"]], z["band_edges"],
            modality=modality)
