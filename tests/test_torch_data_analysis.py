"""The port's window and phase algebra (``pipeline.data_analysis``, a host
copy) against ``mba_tpu`` on the CPU: every function gives the JAX
package's result, equal (``tests/_torch_study.assert_same``), or raises
the same error.  The inputs are those of
``tests/test_pipeline_data_analysis.py``, plus the mixed ``datetime64``
units the statistics frames meet (spans parsed from the log's strings
in [us], serial stamps from timestamp arithmetic in [ns]) in both
directions, and tz-aware windows over a tz-aware trace.
"""
import numpy as np
import pandas as pd
import pytest

from mba_tpu.pipeline import data_analysis as J
from mba_tpu_torch.pipeline import data_analysis as T

from _torch_study import assert_same


def _series(n=100, fs=10.0, start="2024-01-01 12:00:00"):
    idx = pd.date_range(start, periods=n, freq=pd.Timedelta(seconds=1 / fs))
    return pd.Series(np.arange(n, dtype=float), index=idx)


def _nan_laden():
    rng = np.random.default_rng(42)
    n, n_feat = 300, 3
    idx = pd.date_range("2024-01-01", periods=n, freq="100ms")
    data = rng.standard_normal((n, n_feat))
    data[rng.random((n, n_feat)) < 0.15] = np.nan
    data[40:60] = np.nan
    starts = pd.DatetimeIndex([idx[0], idx[10], idx[5], idx[40],
                               idx[200], idx[250], idx[299]])
    ends = pd.DatetimeIndex([idx[8], idx[30], idx[20], idx[59],
                             idx[230], idx[249], idx[299]])
    return data, idx, starts, ends


def _mixed_units(windows_unit, target_unit):
    anchor = pd.Timestamp("2026-01-01 12:00:00", tz="UTC")
    target = pd.DatetimeIndex([anchor + pd.Timedelta(seconds=i * 0.1)
                               for i in range(100)]).as_unit(target_unit)
    starts = pd.DatetimeIndex(pd.to_datetime(
        ["2026-01-01 12:00:01", "2026-01-01 12:00:05"], utc=True))
    ends = pd.DatetimeIndex(pd.to_datetime(
        ["2026-01-01 12:00:03.050", "2026-01-01 12:00:08.000"], utc=True))
    return (starts.as_unit(windows_unit), ends.as_unit(windows_unit),
            target)


def _window_cases():
    s = _series()
    cases = {
        "centers_mean": lambda m: m.apply_window_operator(
            pd.date_range("2024-01-01 12:00:02", periods=3, freq="2s"), s,
            window_size=1.0, is_time_center=True),
        "starts_mean": lambda m: m.apply_window_operator(
            s.index[[10, 40]], s, window_size=1.5, is_time_center=False),
        "2d_target": lambda m: m.apply_window_operator(
            pd.DatetimeIndex([s.index[50]]),
            np.stack([s.values, s.values * 2], axis=1),
            target_timestamps=s.index, window_size=1.0,
            is_time_center=True),
        "first_valid_slot": lambda m: m.apply_window_operator(
            s.index[[20, 60]], s, window_size=1.0, is_time_center=True,
            first_valid_slot=1),
        "mode_strings": lambda m: m.apply_window_operator(
            pd.DatetimeIndex(pd.date_range("2024-01-01", periods=6,
                                           freq="1s")[[0, 3]]),
            pd.Series(["a", "a", "b", "c", "c", "c"],
                      index=pd.date_range("2024-01-01", periods=6,
                                          freq="1s")),
            window_timestamps_ends=pd.DatetimeIndex(pd.date_range(
                "2024-01-01", periods=6, freq="1s")[[2, 5]]),
            operation="mode"),
        "mode_objects_2d": lambda m: m.apply_window_operator(
            s.index[[0, 30, 60]],
            np.array([[i % 3, None if i % 5 == 0 else "x" * (i % 2)]
                      for i in range(100)], dtype=object),
            target_timestamps=s.index,
            window_timestamps_ends=s.index[[29, 59, 99]],
            operation="mode"),
        "integer_median": lambda m: m.apply_window_operator(
            pd.DatetimeIndex(pd.date_range("2024-01-01", periods=20,
                                           freq="1s")[[0, 10]]),
            np.arange(20, dtype=np.int64),
            target_timestamps=pd.date_range("2024-01-01", periods=20,
                                            freq="1s"),
            window_timestamps_ends=pd.DatetimeIndex(pd.date_range(
                "2024-01-01", periods=20, freq="1s")[[9, 19]]),
            operation="median"),
        "tz_aware": lambda m: m.apply_window_operator(
            m.make_timezone_aware(s.index[[0, 50]]),
            pd.Series(s.values, index=m.make_timezone_aware(s.index)),
            window_timestamps_ends=m.make_timezone_aware(s.index[[40, 99]]),
            operation="std"),
    }
    data, idx, starts, ends = _nan_laden()
    for op in ("mean", "median", "min", "max", "std"):
        cases[f"nan_laden_{op}"] = (
            lambda m, op=op: m.apply_window_operator(
                starts, data, target_timestamps=idx,
                window_timestamps_ends=ends, operation=op))
    for wu, tu in (("us", "ns"), ("ns", "us"), ("s", "ns"), ("ms", "us")):
        cases[f"units_{wu}_windows_{tu}_target"] = (
            lambda m, wu=wu, tu=tu: m.apply_window_operator(
                *_mixed_units(wu, tu)[:1], np.arange(100, dtype=np.float64),
                target_timestamps=_mixed_units(wu, tu)[2],
                window_timestamps_ends=_mixed_units(wu, tu)[1],
                operation="mean", axis=0))
    return cases


CASES = {
    **{f"window_{k}": v for k, v in _window_cases().items()},
    "interpolate_linear": lambda m: m.interpolate_per_window(
        np.array([10.5, 20.25]), _series(fs=1.0)),
    "interpolate_extrapolate": lambda m: m.interpolate_per_window(
        np.array([50.0, -2.0]), _series(fs=1.0, n=10), extrapolate=True),
    "time_index_series": lambda m: m.add_time_index(
        pd.Timestamp("2024-01-01"), pd.Timestamp("2024-01-02"),
        target_array=np.arange(5.0)),
    "time_index_n": lambda m: m.add_time_index(
        pd.Timestamp("2026-01-05 10:00:00.75", tz="UTC"),
        pd.Timestamp("2026-01-05 10:04:22", tz="UTC"), n_timesteps=2088),
    "time_index_naive_n": lambda m: m.add_time_index(
        pd.Timestamp("2024-01-01"), pd.Timestamp("2024-01-01 00:01"),
        n_timesteps=7),
    "tz_index": lambda m: m.make_timezone_aware(
        pd.date_range("2024-01-01", periods=3)),
    "tz_passthrough": lambda m: m.make_timezone_aware(
        pd.date_range("2024-01-01", periods=3, tz="Europe/Berlin")),
    "tz_series": lambda m: m.make_timezone_aware(_series(n=5)),
    "tz_timestamp": lambda m: m.make_timezone_aware(
        pd.Timestamp("2024-01-01")),
    "trial_bins_percentile": lambda m: m.create_trial_bins(
        pd.DataFrame({"Subject ID": [0] * 10 + [1] * 10,
                      "Trial ID": list(range(10)) * 2,
                      "force": list(np.arange(10.0))
                      + list(np.arange(10.0) * 100)}),
        ["force"], {"force": 5}),
    "trial_bins_rank": lambda m: m.create_trial_bins(
        pd.DataFrame({"Subject ID": [0] * 6, "Trial ID": range(6),
                      "level": [1.0, 1.0, 2.0, 2.0, 3.0, 3.0]}),
        ["level"], {"level": 5}),
    "phase_interpolated": lambda m: m.phase_normalize_cycles(
        signal=np.arange(0.0, 3.0, 0.1), t_rel=np.arange(0.0, 3.0, 0.1),
        task_freq=1.0, trial_dur_sec=3.0,
        phase_grid=np.array([0.0, 90.0, 180.0, 270.0, 360.0]),
        min_samples_per_cycle=2, min_cycle_coverage_ratio=0.0,
        use_interpolation=True, verbose=False),
    "phase_partial_cycle": lambda m: m.phase_normalize_cycles(
        signal=np.sin(2 * np.pi * np.array(
            [0.0, 0.2, 0.4, 0.6, 0.8, 1.2, 1.4, 1.6, 1.8])),
        t_rel=np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.2, 1.4, 1.6, 1.8]),
        task_freq=1.0, trial_dur_sec=2.0,
        phase_grid=np.array([0.0, 90.0, 180.0, 270.0]),
        min_samples_per_cycle=2, min_cycle_coverage_ratio=0.0,
        use_interpolation=True, verbose=False),
    "phase_2d": lambda m: m.phase_normalize_cycles(
        np.stack([np.arange(0.0, 2.0, 0.05), -np.arange(0.0, 2.0, 0.05)],
                 axis=1), np.arange(0.0, 2.0, 0.05), task_freq=1.0,
        trial_dur_sec=2.0, phase_grid=np.linspace(0, 360, 13),
        min_samples_per_cycle=2, min_cycle_coverage_ratio=0.0,
        verbose=False),
    "phase_offset_coverage": lambda m: m.phase_normalize_cycles(
        np.cos(np.arange(0.0, 31.0, 0.5)), np.arange(0.0, 31.0, 0.5),
        task_freq=0.1, trial_dur_sec=31.0,
        phase_grid=np.linspace(0, 360, 36, endpoint=False),
        min_samples_per_cycle=2, start_offset_sec=10.0, verbose=True),
    "phase_low_coverage": lambda m: m.phase_normalize_cycles(
        np.ones(3), np.array([0.0, 0.05, 0.1]), task_freq=1.0,
        trial_dur_sec=1.0, phase_grid=np.linspace(0, 360, 5),
        min_samples_per_cycle=2, min_cycle_coverage_ratio=0.8,
        verbose=False),
    "phase_nearest_bin": lambda m: m.phase_normalize_cycles(
        np.sin(2 * np.pi * np.arange(0.0, 1.0, 0.01)),
        np.arange(0.0, 1.0, 0.01), task_freq=1.0, trial_dur_sec=1.0,
        phase_grid=np.array([0.0, 90.0, 180.0, 270.0]),
        min_samples_per_cycle=2, min_cycle_coverage_ratio=0.0,
        use_interpolation=False, verbose=False),
    "circular_smooth": lambda m: m.circular_smooth(
        np.where(np.arange(36) == 0, 36.0, 0.0), kernel_bins=3),
    "circular_smooth_2d": lambda m: m.circular_smooth(
        np.random.default_rng(3).standard_normal((36, 4)), kernel_bins=5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    assert_same(CASES[name](T), CASES[name](J), name)


def test_mixed_units_land_in_their_windows():
    """The regression ``tests/test_pipeline_data_analysis.py:268`` pins,
    on the port: [us] windows over an [ns] trace find their samples."""
    starts, ends, target = _mixed_units("us", "ns")
    out = T.apply_window_operator(
        window_timestamps=starts, window_timestamps_ends=ends,
        target_array=np.arange(100, dtype=np.float64),
        target_timestamps=target, operation="mean", axis=0)
    np.testing.assert_allclose(out.astype(float), [np.mean(np.arange(10, 31)),
                                                   np.mean(np.arange(50, 81))])


ERRORS = {
    "window_out_of_range": lambda m: m.apply_window_operator(
        pd.DatetimeIndex([_series().index[-1] + pd.Timedelta(seconds=60)]),
        _series(), window_size=1.0, is_time_center=True),
    "window_needs_spec": lambda m: m.apply_window_operator(
        _series().index[:2], _series()),
    "window_needs_center_flag": lambda m: m.apply_window_operator(
        _series().index[:2], _series(), window_size=1.0),
    "window_numeric_rejected": lambda m: m.apply_window_operator(
        np.array([1.0, 2.0]), _series(), window_size=1.0,
        is_time_center=True),
    "window_ndarray_needs_timestamps": lambda m: m.apply_window_operator(
        _series().index[:2], np.arange(100.0), window_size=1.0,
        is_time_center=True),
    "interpolate_outside": lambda m: m.interpolate_per_window(
        np.array([50.0]), _series(fs=1.0, n=10)),
    "time_index_order": lambda m: m.add_time_index(
        pd.Timestamp("2024-01-01"), pd.Timestamp("2024-01-01"),
        n_timesteps=3),
    "time_index_timezones": lambda m: m.add_time_index(
        pd.Timestamp("2024-01-01"), pd.Timestamp("2024-01-02", tz="UTC"),
        n_timesteps=3),
    "time_index_steps_type": lambda m: m.add_time_index(
        pd.Timestamp("2024-01-01"), pd.Timestamp("2024-01-02"),
        n_timesteps=2.5),
    "tz_wrong_type": lambda m: m.make_timezone_aware(np.arange(3)),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_raises_as_jax(name):
    raised = []
    for mod in (T, J):
        with pytest.raises(Exception) as info:
            ERRORS[name](mod)
        raised.append((type(info.value), str(info.value)))
    assert raised[0] == raised[1]
