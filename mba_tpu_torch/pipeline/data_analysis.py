"""Timestamp/window algebra and phase normalization.

Parity target: reference ``src/pipeline/data_analysis.py`` — the glue layer
between raw time-indexed measurements and per-segment statistics:

- :func:`apply_window_operator`      ↔ :66-309
- :func:`interpolate_per_window`     ↔ :312-448
- :func:`add_time_index`             ↔ :451-683
- :func:`make_timezone_aware`        ↔ :686-800
- :func:`create_trial_bins`          ↔ :803-956
- :func:`phase_normalize_cycles`     ↔ :960-1233
- :func:`circular_smooth`            ↔ :1236-1240

These are host-side pandas/numpy (they manipulate irregular timestamped
frames, not dense arrays); the dense per-cycle interpolation inside
``phase_normalize_cycles`` is vectorised numpy.

A host copy of ``mba_tpu/pipeline/data_analysis.py`` (the port never
imports ``mba_tpu``).
"""
from __future__ import annotations

import logging
import warnings
from typing import Literal, Union

import numpy as np
import pandas as pd
from scipy.interpolate import interp1d
from scipy.ndimage import uniform_filter1d


def _normalize_to_datetimeindex(timestamps, name: str = "timestamps"
                                ) -> pd.DatetimeIndex:
    """Convert timestamp-like input to ``pd.DatetimeIndex`` (UTC parse).

    Always returns nanosecond resolution: downstream comparisons use
    raw ``asi8`` integers, and pandas ≥ 2 infers DIFFERENT datetime64
    units from different sources (string parses → [us], computed
    ``Timestamp + Timedelta`` stamps → [ns]) — mixing units in asi8
    space silently mis-assigns every sample.
    """
    if isinstance(timestamps, pd.DatetimeIndex):
        return timestamps.as_unit("ns")
    arr = np.asarray(timestamps)
    if np.issubdtype(arr.dtype, np.number):
        raise TypeError(
            f"'{name}' cannot be numeric (int/float). Numeric timestamps "
            f"are ambiguous — convert explicitly, e.g. "
            f"pd.to_datetime(array, unit='s', utc=True).")
    try:
        dt_idx = pd.to_datetime(arr, utc=True)
    except Exception as e:
        raise TypeError(
            f"Could not interpret '{name}' as datetime: {e}") from e
    return pd.DatetimeIndex(dt_idx).as_unit("ns")


def _column_mode(col: np.ndarray):
    """First (smallest) mode of a column, NaN-dropping — matches
    ``pd.Series(col).mode().iloc[0]`` (ascending mode order) without
    constructing a Series per window×feature (stage-4 hot path)."""
    vals = col[~pd.isna(col)]
    if len(vals) == 0:
        return np.nan
    try:
        uniq, counts = np.unique(vals, return_counts=True)
    except TypeError:           # mixed/unorderable object values
        mode = pd.Series(vals).mode()
        return mode.iloc[0] if len(mode) > 0 else np.nan
    return uniq[counts.argmax()]


def apply_window_operator(
        window_timestamps,
        target_array,
        target_timestamps=None,
        window_size: float | None = None,
        is_time_center: bool | None = None,
        operation: Literal['min', 'max', 'mean', 'median', 'mode',
                           'std'] = 'mean',
        axis: int = 0,
        first_valid_slot: int = 0,
        window_timestamps_ends=None,
) -> np.ndarray:
    """Aggregate values inside timestamp-defined windows along an axis.

    Window boundaries are inclusive on both sides; overlapping windows
    assign each sample to the LAST matching window (reference
    data_analysis.py:234-239 overwrite semantics).  Output windows with no
    samples stay NaN.
    """
    if window_size is None and window_timestamps_ends is None:
        raise ValueError(
            "Either 'window_size' or 'window_timestamps_ends' must be "
            "provided.")
    if window_size is not None and is_time_center is None:
        raise ValueError(
            "When 'window_size' is provided, 'is_time_center' must also be "
            "specified.")

    if isinstance(target_array, pd.Series):
        if target_timestamps is None:
            if isinstance(target_array.index, pd.DatetimeIndex):
                target_timestamps = target_array.index
            else:
                raise ValueError(
                    "target_timestamps is None and target_array (pd.Series) "
                    "does not have a DatetimeIndex.")
        target_array = target_array.values
    elif target_timestamps is None:
        raise ValueError(
            "target_timestamps is None and target_array is ndarray.")

    target_array = np.asarray(target_array)
    if target_array.ndim == 0:
        raise ValueError("target_array must be at least 1D")
    if axis < 0 or axis >= target_array.ndim:
        raise ValueError(
            f"axis={axis} out of bounds for array with {target_array.ndim} "
            f"dimensions")

    window_times = _normalize_to_datetimeindex(window_timestamps,
                                               "window_timestamps")
    target_times = _normalize_to_datetimeindex(target_timestamps,
                                               "target_timestamps")
    if window_timestamps_ends is not None:
        window_ends_idx = _normalize_to_datetimeindex(
            window_timestamps_ends, "window_timestamps_ends")
        if len(window_ends_idx) != len(window_times):
            raise ValueError(
                f"window_timestamps_ends length ({len(window_ends_idx)}) "
                f"must match window_timestamps length ({len(window_times)})")
        window_starts, window_ends = window_times, window_ends_idx
    else:
        delta = pd.Timedelta(seconds=float(window_size))
        if is_time_center:
            window_starts = window_times - delta / 2
            window_ends = window_times + delta / 2
        else:
            window_starts = window_times
            window_ends = window_times + delta

    if len(target_times) != target_array.shape[axis]:
        raise ValueError(
            f"Length of target_timestamps ({len(target_times)}) does not "
            f"match target_array.shape[{axis}] ({target_array.shape[axis]}).")

    if (window_starts.min() < target_times.min()
            or window_ends.max() > target_times.max()):
        raise ValueError(
            f"Window boundaries [{window_starts.min()}, {window_ends.max()}]"
            f" exceed target timestamp range "
            f"[{target_times.min()}, {target_times.max()}].")

    # assign samples → windows (later windows overwrite earlier on overlap)
    tvals = target_times.asi8
    window_indices = np.full(len(tvals), -1, dtype=np.int64)
    starts_i8 = window_starts.asi8
    ends_i8 = window_ends.asi8
    if target_times.is_monotonic_increasing:
        # samples inside [start, end] form one contiguous slice of the
        # sorted time axis; writing slices in window order preserves the
        # last-window-wins overlap semantics at O(W log N) instead of
        # the O(W·N) boolean-mask sweep (stage-4 hot path: ~85k serial
        # samples × up to 300 segments × ~10 columns per subject)
        lo = np.searchsorted(tvals, starts_i8, side="left")
        hi = np.searchsorted(tvals, ends_i8, side="right")
        for i in range(len(starts_i8)):
            window_indices[lo[i]:hi[i]] = i
    else:
        for i, (start, end) in enumerate(zip(starts_i8, ends_i8)):
            window_indices[(tvals >= start) & (tvals <= end)] = i

    moved = np.moveaxis(target_array, axis, 0)
    moved_shape = moved.shape
    flat = moved.reshape(moved_shape[0], -1)

    n_windows = len(window_times)
    n_features = flat.shape[1]
    result = np.full((n_windows, n_features), np.nan, dtype=object)

    def _is_all_null(data):
        if data.dtype == object:
            return bool(np.all(pd.isna(data)))
        try:
            return bool(np.all(np.isnan(data)))
        except TypeError:
            return False

    # group samples by assigned window: one stable argsort replaces the
    # per-window `window_indices == w` sweep (O(N log N) vs O(W·N));
    # stable sort keeps each group in original sample order, matching
    # the boolean mask's ascending gather exactly
    order = np.argsort(window_indices, kind="stable")
    sorted_wi = window_indices[order]
    grp_lo = np.searchsorted(sorted_wi, np.arange(n_windows), side="left")
    grp_hi = np.searchsorted(sorted_wi, np.arange(n_windows),
                             side="right")
    sizes = grp_hi - grp_lo
    max_size = int(sizes.max()) if n_windows else 0

    numeric = (np.issubdtype(flat.dtype, np.floating)
               or np.issubdtype(flat.dtype, np.integer))
    if (operation in ('mean', 'median', 'min', 'max', 'std') and numeric
            and max_size > 0 and n_features > 0
            and n_windows * max_size * n_features <= 50_000_000):
        # Vectorized fast path: scatter every window's samples into one
        # NaN-padded (window, slot, feature) cube and reduce along the
        # slot axis in a single nan-call. The per-window loop below
        # spends ~0.5 ms per nanmedian on tiny slices (numpy routes
        # small inputs through masked arrays) — the stage-4 hot path
        # (serial medians over hundreds of segments) is ~40× faster
        # through the cube. The reduction runs in the loop path's dtype
        # (floating inputs keep their own dtype — the nan-reductions
        # accumulate in the input dtype either way; integer inputs need
        # a float cube for the NaN padding, and the loop's nan-calls on
        # integers return float64 too), so the two paths agree even
        # when the 50M-element guard flips path selection. The only
        # remaining difference is suppressed numpy RuntimeWarnings for
        # empty/all-NaN windows (which the loop skips silently anyway).
        cube_dtype = (flat.dtype if np.issubdtype(flat.dtype, np.floating)
                      else np.float64)
        gathered = flat[order].astype(cube_dtype, copy=False)
        valid = sorted_wi >= 0
        rows = sorted_wi[valid]
        cols = np.arange(len(sorted_wi))[valid] - grp_lo[rows]
        padded = np.full((n_windows, max_size, n_features), np.nan,
                         dtype=cube_dtype)
        padded[rows, cols, :] = gathered[valid]
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            if operation == 'mean':
                red = np.nanmean(padded, axis=1)
            elif operation == 'median':
                red = np.nanmedian(padded, axis=1)
            elif operation == 'min':
                red = np.nanmin(padded, axis=1)
            elif operation == 'max':
                red = np.nanmax(padded, axis=1)
            else:
                red = np.nanstd(padded, axis=1)
            n_nonnan = (~np.isnan(padded)).sum(axis=(1, 2))
            abs_max = np.nanmax(np.abs(padded), axis=(1, 2))
        # parity with the loop's all-zeros warning: plain min/max are
        # NaN-propagating, so it only fires when a window has no NaN at
        # all and every value is exactly 0
        no_nan = n_nonnan == sizes * n_features
        for w in np.nonzero((sizes > 0) & no_nan & (abs_max == 0.0))[0]:
            logging.warning(
                "[mba_tpu.pipeline.data_analysis.apply_window_operator] "
                f"Window {w} only contains NULL values.")
        filled = np.nonzero(sizes > 0)[0]
        result[filled] = red[filled]
        out_shape = list(moved_shape)
        out_shape[0] = n_windows
        return np.moveaxis(result.reshape(out_shape), 0, axis)

    for w in range(n_windows):
        if grp_lo[w] == grp_hi[w]:
            continue
        data = flat[order[grp_lo[w]:grp_hi[w]], :]
        if _is_all_null(data) and w < first_valid_slot:
            continue  # expected NaN pad before the first valid slot
        try:
            if (data.min() == 0.0) & (data.max() == 0.0):
                logging.warning(
                    "[mba_tpu.pipeline.data_analysis.apply_window_operator] "
                    f"Window {w} only contains NULL values.")
        except TypeError:
            pass
        if operation == 'mean':
            result[w, :] = np.nanmean(data, axis=0)
        elif operation == 'median':
            result[w, :] = np.nanmedian(data, axis=0)
        elif operation == 'min':
            result[w, :] = np.nanmin(data, axis=0)
        elif operation == 'max':
            result[w, :] = np.nanmax(data, axis=0)
        elif operation == 'std':
            result[w, :] = np.nanstd(data, axis=0)
        elif operation == 'mode':
            for j in range(n_features):
                result[w, j] = _column_mode(data[:, j])
        else:
            raise ValueError(f"Unknown operation: {operation}")

    out_shape = list(moved_shape)
    out_shape[0] = n_windows
    return np.moveaxis(result.reshape(out_shape), 0, axis)


def interpolate_per_window(
        window_time_steps: np.ndarray,
        target_series: pd.Series,
        method: Literal['linear', 'nearest', 'cubic'] = 'linear',
        window_size: float | None = None,
        is_time_center: bool = False,
        extrapolate: bool = False,
        return_type: Literal['pandas', 'numpy'] = 'numpy'):
    """Interpolate a time-indexed series at requested window time points."""
    if not isinstance(target_series, pd.Series):
        raise TypeError(
            f"target_series must be pd.Series, got {type(target_series)}")
    if len(target_series) == 0:
        raise ValueError("target_series cannot be empty")

    window_time_steps = np.asarray(window_time_steps, dtype=float)
    if isinstance(target_series.index, pd.DatetimeIndex):
        source_times = ((target_series.index - target_series.index[0])
                        .total_seconds().values)
    else:
        source_times = target_series.index.values.astype(float)

    if window_size is None:
        if len(target_series) < 2:
            raise ValueError(
                "target_series must have at least 2 points for "
                "interpolation")
        f = interp1d(source_times, target_series.values, kind=method,
                     bounds_error=not extrapolate,
                     fill_value='extrapolate' if extrapolate else np.nan)
        try:
            result = f(window_time_steps)
        except ValueError as e:
            raise ValueError(
                f"Interpolation failed. Ensure window_time_steps are within "
                f"[{source_times.min()}, {source_times.max()}] or set "
                f"extrapolate=True") from e
    else:
        result = np.full(len(window_time_steps), np.nan)
        for i, t in enumerate(window_time_steps):
            start = t - window_size / 2 if is_time_center else t
            end = start + window_size
            sel = (source_times >= start) & (source_times < end)
            if sel.sum() < 2:
                continue
            try:
                result[i] = interp1d(source_times[sel],
                                     target_series.values[sel],
                                     kind=method, bounds_error=False,
                                     fill_value=np.nan)(t)
            except ValueError:
                continue
        if extrapolate and np.isnan(result).any():
            f = interp1d(source_times, target_series.values, kind=method,
                         bounds_error=False, fill_value='extrapolate')
            nan_sel = np.isnan(result)
            try:
                result[nan_sel] = f(window_time_steps[nan_sel])
            except ValueError:
                pass

    if return_type == 'pandas':
        return pd.Series(result, index=window_time_steps,
                         name=target_series.name)
    if return_type == 'numpy':
        return result
    raise ValueError(
        f"return_type must be 'pandas' or 'numpy', got {return_type}")


def add_time_index(start_timestamp: pd.Timestamp,
                   end_timestamp: pd.Timestamp,
                   target_array=None,
                   n_timesteps: int | None = None):
    """Attach an evenly spaced DatetimeIndex over [start, end]."""
    if not isinstance(start_timestamp, pd.Timestamp):
        raise TypeError(
            f"start_timestamp must be pd.Timestamp, got "
            f"{type(start_timestamp)}")
    if not isinstance(end_timestamp, pd.Timestamp):
        raise TypeError(
            f"end_timestamp must be pd.Timestamp, got {type(end_timestamp)}")
    if (start_timestamp.tz is None) != (end_timestamp.tz is None):
        raise ValueError(
            "start_timestamp and end_timestamp must have matching timezone "
            "awareness")
    if start_timestamp >= end_timestamp:
        raise ValueError(
            f"start_timestamp ({start_timestamp}) must be strictly before "
            f"end_timestamp ({end_timestamp})")

    data_type = None
    if target_array is not None:
        if isinstance(target_array, pd.DataFrame):
            if len(target_array) == 0:
                raise ValueError("target_array DataFrame cannot be empty")
            n_timesteps = len(target_array)
            data_type = 'dataframe'
        elif isinstance(target_array, pd.Series):
            target_array = target_array.to_numpy()
            if len(target_array) == 0:
                raise ValueError("target_array Series cannot be empty")
            n_timesteps = len(target_array)
            data_type = 'series'
        elif isinstance(target_array, np.ndarray):
            if target_array.ndim != 1:
                raise ValueError(
                    f"target_array must be 1-dimensional, got shape "
                    f"{target_array.shape}")
            if len(target_array) == 0:
                raise ValueError("target_array array cannot be empty")
            n_timesteps = len(target_array)
            data_type = 'array'
        else:
            raise TypeError(
                f"target_array must be pd.Series, pd.DataFrame, or "
                f"np.ndarray, got {type(target_array)}")
    else:
        if n_timesteps is None:
            raise ValueError(
                "Either target_array or n_timesteps must be provided.")
        if not isinstance(n_timesteps, (int, np.integer)):
            raise TypeError(
                f"n_timesteps must be an integer, got {type(n_timesteps)}")
        if n_timesteps <= 0:
            raise ValueError(
                f"n_timesteps must be a positive integer, got {n_timesteps}")

    time_index = pd.date_range(start=start_timestamp, end=end_timestamp,
                               periods=n_timesteps)
    if data_type == 'dataframe':
        result = target_array.copy()
        result.index = time_index
        return result
    if data_type in ('series', 'array'):
        return pd.Series(target_array, index=time_index)
    return time_index


def make_timezone_aware(dt_index, timezone: str = 'utc'):
    """Localize naive datetimes; aware inputs pass through unchanged."""
    timezone = timezone.lower()
    if isinstance(dt_index, pd.DatetimeIndex):
        return dt_index if dt_index.tz is not None \
            else dt_index.tz_localize(timezone)
    if isinstance(dt_index, pd.Series):
        if not isinstance(dt_index.index, pd.DatetimeIndex):
            raise TypeError(
                f"Series must have a DatetimeIndex, got "
                f"{type(dt_index.index)}")
        if dt_index.index.tz is not None:
            return dt_index
        result = dt_index.copy()
        result.index = result.index.tz_localize(timezone)
        return result
    if isinstance(dt_index, pd.Timestamp):
        return dt_index if dt_index.tz is not None \
            else dt_index.tz_localize(timezone)
    raise TypeError(
        f"dt_index must be pd.DatetimeIndex, pd.Series, or pd.Timestamp, "
        f"got {type(dt_index)}")


def create_trial_bins(df, columns_to_bin, n_bins_dict,
                      subject_col='Subject ID', trial_col='Trial ID'):
    """Intra-subject percentile binning of trial-averaged variables.

    Few-unique-value columns get rank bins (each distinct value its own
    bin); continuous columns get pd.qcut percentile bins; 1-indexed.
    """
    df_result = df.copy()
    grouping_cols = [subject_col, trial_col]
    to_aggregate = [c for c in columns_to_bin if c not in grouping_cols]
    if to_aggregate:
        trial_avg = df.groupby(grouping_cols,
                               as_index=False)[to_aggregate].mean()
    else:
        trial_avg = df[grouping_cols].drop_duplicates().reset_index(
            drop=True)

    for col in columns_to_bin:
        n_bins = n_bins_dict.get(col, 5)
        bin_col = f"{col}_bin"
        assignments = []
        for subject_id in trial_avg[subject_col].unique():
            sub = trial_avg[trial_avg[subject_col] == subject_id].copy()
            vals = sub[col]
            if vals.isna().all():
                sub[bin_col] = np.nan
            else:
                n_unique = vals.dropna().nunique()
                if n_unique == 1:
                    sub[bin_col] = vals.notna().astype(float)
                    sub.loc[vals.isna(), bin_col] = np.nan
                elif n_unique <= n_bins:
                    value_to_bin = {v: i + 1 for i, v in
                                    enumerate(sorted(vals.dropna().unique()))}
                    sub[bin_col] = vals.map(value_to_bin)
                else:
                    try:
                        bins = pd.qcut(vals, q=min(n_bins, n_unique),
                                       labels=False, duplicates='drop')
                    except Exception:
                        bins = pd.cut(vals, bins=min(n_bins, n_unique),
                                      labels=False, duplicates='drop')
                    sub[bin_col] = np.nan
                    sub.loc[vals.notna(), bin_col] = bins.dropna() + 1
            assignments.append(sub[[subject_col, trial_col, bin_col]])
        bin_df = pd.concat(assignments, ignore_index=True)
        df_result = df_result.merge(bin_df, on=grouping_cols, how='left')

    for col in columns_to_bin:
        bin_col = f"{col}_bin"
        if bin_col in df_result.columns:
            df_result[bin_col] = df_result[bin_col].astype('Int64')
    return df_result


def phase_normalize_cycles(
        signal: np.ndarray,
        t_rel: np.ndarray,
        task_freq: float,
        trial_dur_sec: float,
        phase_grid: np.ndarray,
        min_samples_per_cycle: int,
        start_offset_sec: float = 0.0,
        min_cycle_coverage_ratio: float = 0.8,
        use_interpolation: bool = True,
        interpolation_kind: Literal['linear', 'nearest'] = 'linear',
        phase_wraparound_coverage_threshold: float = 0.8,
        verbose: bool = True,
) -> list[np.ndarray]:
    """Phase-normalize a trial into cycle-wise profiles on a 0–360° grid.

    Parity: reference data_analysis.py:960-1233 — cycle segmentation at
    1/task_freq, per-cycle coverage checks, duplicate-phase averaging via
    bincount, ±360° wrap-around padding for near-complete cycles,
    linear/nearest interpolation or circular nearest-bin averaging, and
    closed-axis closure (last bin forced equal to first).
    """
    if not (0.0 <= float(min_cycle_coverage_ratio) <= 1.0):
        raise ValueError("min_cycle_coverage_ratio must be within [0, 1].")
    if use_interpolation and interpolation_kind not in {'linear', 'nearest'}:
        raise ValueError("interpolation_kind must be 'linear' or 'nearest'.")

    signal_arr = np.asarray(signal)
    t_rel_arr = np.asarray(t_rel, dtype=float)
    if signal_arr.shape[0] != t_rel_arr.shape[0]:
        raise ValueError(
            "signal and t_rel must have the same length along axis 0.")
    if task_freq <= 0 or signal_arr.shape[0] < min_samples_per_cycle:
        return []

    is_1d = signal_arr.ndim == 1
    cycle_dur = 1.0 / task_freq
    eps = 1e-9
    first_cycle = int(np.floor(start_offset_sec * task_freq))
    n_total_cycles = int(np.floor(trial_dur_sec * task_freq + eps))
    if n_total_cycles <= 0:
        return []

    phase_grid_arr = np.asarray(phase_grid, dtype=float)
    if phase_grid_arr.size == 0:
        return []
    phase_span = np.mod(phase_grid_arr - phase_grid_arr[0], 360.0)
    closed_axis = (len(phase_grid_arr) >= 2
                   and np.isclose(phase_span[-1], 0.0, atol=eps))

    order = np.argsort(t_rel_arr)
    t_rel_arr = t_rel_arr[order]
    signal_arr = signal_arr[order]

    if (verbose and use_interpolation
            and phase_wraparound_coverage_threshold
            > min_cycle_coverage_ratio):
        print("[mba_tpu phase_normalize_cycles WARNING] cycles with "
              f"coverage in [{min_cycle_coverage_ratio:.2f}, "
              f"{phase_wraparound_coverage_threshold:.2f}) are included "
              "without wrap-around padding and may carry boundary NaNs.")

    out: list[np.ndarray] = []
    for cycle_idx in range(first_cycle, n_total_cycles):
        t0 = cycle_idx * cycle_dur
        t1 = (cycle_idx + 1) * cycle_dur
        in_cycle = (t_rel_arr >= t0) & (t_rel_arr < t1)
        if int(in_cycle.sum()) < min_samples_per_cycle:
            continue

        t_cycle = t_rel_arr[in_cycle]
        sig_vals = signal_arr[in_cycle]
        phase_vals = np.clip(((t_cycle - t0) / cycle_dur) * 360.0,
                             0.0, 360.0 - eps)
        p_order = np.argsort(phase_vals)
        phase_vals = phase_vals[p_order]
        sig_vals = sig_vals[p_order]

        coverage = (phase_vals[-1] - phase_vals[0]) / 360.0
        if coverage < min_cycle_coverage_ratio:
            continue

        if use_interpolation:
            unique_ph, inv_idx, counts = np.unique(
                phase_vals, return_inverse=True, return_counts=True)
            if unique_ph.size < 2:
                continue
            if is_1d:
                avg = np.bincount(inv_idx, weights=sig_vals) / counts
            else:
                n_ch = sig_vals.shape[1]
                avg = np.zeros((len(unique_ph), n_ch))
                for ch in range(n_ch):
                    avg[:, ch] = (np.bincount(inv_idx,
                                              weights=sig_vals[:, ch])
                                  / counts)
            n_pad = max(1, len(unique_ph) // 4)
            if coverage >= phase_wraparound_coverage_threshold:
                interp_ph = np.concatenate([unique_ph[-n_pad:] - 360.0,
                                            unique_ph,
                                            unique_ph[:n_pad] + 360.0])
                interp_sig = np.concatenate(
                    [avg[-n_pad:], avg, avg[:n_pad]], axis=0)
            else:
                interp_ph, interp_sig = unique_ph, avg
            profile = interp1d(interp_ph, interp_sig,
                               kind=interpolation_kind, axis=0,
                               bounds_error=False, fill_value=np.nan,
                               assume_sorted=True)(phase_grid_arr)
            profile = (np.asarray(profile, float) if is_1d else
                       np.asarray(profile, float).reshape(
                           len(phase_grid_arr), -1))
        else:
            dist = np.abs(phase_vals[:, None] - phase_grid_arr[None, :])
            nearest = np.minimum(dist, 360.0 - dist).argmin(axis=1)
            counts = np.bincount(nearest, minlength=len(phase_grid_arr))
            valid = counts > 0
            if is_1d:
                profile = np.full(len(phase_grid_arr), np.nan)
                sums = np.bincount(nearest, weights=sig_vals,
                                   minlength=len(phase_grid_arr))
                profile[valid] = sums[valid] / counts[valid]
            else:
                n_ch = sig_vals.shape[1]
                profile = np.full((len(phase_grid_arr), n_ch), np.nan)
                for ch in range(n_ch):
                    sums = np.bincount(nearest, weights=sig_vals[:, ch],
                                       minlength=len(phase_grid_arr))
                    profile[valid, ch] = sums[valid] / counts[valid]

        if closed_axis:
            profile[-1] = profile[0]
        out.append(profile)
    return out


def circular_smooth(profile: np.ndarray, kernel_bins: int = 5) -> np.ndarray:
    """Smooth a phase-averaged profile with wrap-around padding."""
    padded = np.concatenate([profile[-kernel_bins:], profile,
                             profile[:kernel_bins]])
    smoothed = uniform_filter1d(padded, size=kernel_bins, mode='nearest')
    return smoothed[kernel_bins:-kernel_bins]
