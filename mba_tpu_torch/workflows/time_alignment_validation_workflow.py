"""Clock-drift audit + EMG-vs-force muscle-identity validation.

Parity target: reference ``src/time_alignment_validation_workflow.py``
(1415 LoC): ``calculate_actual_sampling_rate`` (file samples vs
serial-measured duration → actual fs; :23-164), a cohort sweep
(:167-341), and EMG-vs-force validation (correlation + lag + power ratio;
flexor-dominance / co-contraction interpretation; :342-897, :1144-1415).

Port of ``mba_tpu/workflows/time_alignment_validation_workflow.py``: the
resampling of :func:`validate_muscle_identity` and the Welch PSD of
:func:`emg_power_ratio` run on ``device`` (the card unless ``"cpu"``);
the rest is a host copy.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from mba_tpu_torch._device import entry_device, to_device
from mba_tpu_torch.pipeline import data_integration as di
from mba_tpu_torch.pipeline import data_analysis
from mba_tpu_torch.ops.spectral import welch_psd
from mba_tpu_torch.ops.framing import resample_linear


def calculate_actual_sampling_rate(n_file_samples: int,
                                   log_df: pd.DataFrame,
                                   nominal_fs: float = 2048.0) -> dict:
    """Actual fs = file samples / trigger-anchored recording duration
    (reference :23-164).  Reports the drift against nominal."""
    start, end = di.get_qtc_measurement_start_end(log_df, verbose=False)
    duration = (end - start).total_seconds()
    actual_fs = n_file_samples / duration
    drift_ppm = 1e6 * (actual_fs - nominal_fs) / nominal_fs
    return {"duration_sec": duration, "n_samples": n_file_samples,
            "actual_fs": actual_fs, "nominal_fs": nominal_fs,
            "drift_ppm": drift_ppm,
            "drift_sec_per_hour": 3600 * (actual_fs - nominal_fs)
            / nominal_fs}


def validate_muscle_identity(emg_rms_envelope: np.ndarray,
                             force: np.ndarray,
                             fs_emg: float, fs_force: float,
                             max_lag_sec: float = 1.0,
                             device=None) -> dict:
    """EMG-envelope vs force correlation + lag + interpretation
    (reference :342-897).

    Flexor grids must correlate positively with grip force at small lag;
    anti-phase or weak correlation flags swapped grids / co-contraction.
    """
    device = entry_device(device)
    common_fs = min(fs_emg, fs_force, 32.0)
    env = resample_linear(to_device(
        np.asarray(emg_rms_envelope, np.float32), device), fs_emg,
        common_fs).cpu().numpy()
    frc = resample_linear(to_device(
        np.asarray(force, np.float32), device), fs_force,
        common_fs).cpu().numpy()
    n = min(len(env), len(frc))
    env, frc = env[:n], frc[:n]
    env = (env - env.mean()) / (env.std() + 1e-12)
    frc = (frc - frc.mean()) / (frc.std() + 1e-12)

    max_lag = int(max_lag_sec * common_fs)
    xc = np.correlate(env, frc, mode="full") / n
    mid = n - 1
    window = xc[mid - max_lag:mid + max_lag + 1]
    best = int(np.argmax(np.abs(window))) - max_lag
    corr_at_best = float(window[best + max_lag])
    zero_lag_corr = float(xc[mid])
    lag_sec = best / common_fs

    if corr_at_best > 0.4 and abs(lag_sec) < 0.5:
        interpretation = "flexor-dominant (envelope tracks force)"
    elif corr_at_best < -0.3:
        interpretation = ("anti-phase: possible swapped grids or "
                          "antagonist channel")
    elif abs(corr_at_best) < 0.2:
        interpretation = "weak coupling: co-contraction or noisy channel"
    else:
        interpretation = "moderate coupling"
    return {"zero_lag_corr": zero_lag_corr,
            "best_corr": corr_at_best, "best_lag_sec": lag_sec,
            "interpretation": interpretation}


def emg_power_ratio(flexor: np.ndarray, extensor: np.ndarray,
                    fs: float, band=(20.0, 250.0), device=None) -> float:
    """Flexor/extensor band-power ratio (reference power-ratio check)."""
    device = entry_device(device)

    def band_power(x):
        f, p = welch_psd(x, fs, nperseg=int(min(fs * 2, len(x))),
                         device=device)
        sel = (f >= band[0]) & (f <= band[1])
        return float(p[sel].mean())
    return band_power(flexor) / max(band_power(extensor), 1e-20)


def load_emg_psd_both_muscles(
        subject_ind: int,
        feature_data_dir: Path,
        experiment_data_dir: Path,
        emg_frequency_band: tuple[float, float] = (30, 250),
        psd_time_window_size_sec: float = .25,
) -> dict:
    """Load precomputed EMG PSD band power for flexor + extensor.

    Parity: reference time_alignment_validation_workflow.py:342-454 —
    same artifact lookup keywords ("PSD Spectrograms"/"Timecenters"/
    "Frequencies" + ``emg_1_flexor``/``emg_2_extensor``), the same
    half-window-inset absolute time index stretched over the QTC
    measurement span (explicit sampling-drift handling), band-mean
    power over (freqs, channels), and the same force-column search
    order.  Returns ``{'force_series': …, 'flexor': (power, times) |
    None, 'extensor': …}``.
    """
    from mba_tpu_torch.utils import file_management as filemgmt

    subject_feature_dir = Path(feature_data_dir) \
        / f"subject_{subject_ind:02}"
    subject_experiment_dir = Path(experiment_data_dir) \
        / f"subject_{subject_ind:02}"

    log_frame = di.fetch_enriched_log_frame(
        subject_experiment_dir, set_time_index=True, verbose=False)
    qtc_start, qtc_end = di.get_qtc_measurement_start_end(
        log_frame, verbose=False)
    serial_frame = di.fetch_enriched_serial_frame(
        subject_experiment_dir, set_time_index=True)
    if serial_frame.index.tz is not None:
        if qtc_start.tz is None:
            qtc_start = qtc_start.tz_localize(serial_frame.index.tz)
        if qtc_end.tz is None:
            qtc_end = qtc_end.tz_localize(serial_frame.index.tz)

    force_col = None
    for name in ('fsr', 'Force [N]', 'Force', 'force',
                 'Force Level [N]', 'Raw Force [N]'):
        if name in serial_frame.columns:
            force_col = name
            break
    if force_col is None:
        candidates = [c for c in serial_frame.columns
                      if 'force' in c.lower() or 'fsr' in c.lower()]
        if not candidates:
            raise ValueError(
                f"No force column found in serial frame. Available "
                f"columns: {serial_frame.columns.tolist()}")
        force_col = candidates[0]
    results = {'force_series': serial_frame[force_col]}

    for muscle_name, muscle_id in (('flexor', 'emg_1_flexor'),
                                   ('extensor', 'emg_2_extensor')):
        try:
            emg_psd = np.load(filemgmt.most_recent_file(
                subject_feature_dir, ".npy",
                ["PSD Spectrograms", muscle_id]))
            psd_times_sec = np.load(filemgmt.most_recent_file(
                subject_feature_dir, ".npy",
                ["PSD Timecenters", muscle_id]))
            psd_freqs = np.load(filemgmt.most_recent_file(
                subject_feature_dir, ".npy",
                ["PSD Frequencies", muscle_id]))
            half = pd.Timedelta(seconds=psd_time_window_size_sec / 2)
            psd_times = data_analysis.add_time_index(
                start_timestamp=qtc_start + half,
                end_timestamp=qtc_end - half,
                n_timesteps=len(psd_times_sec))
            fmask = ((psd_freqs >= emg_frequency_band[0])
                     & (psd_freqs <= emg_frequency_band[1]))
            power = np.mean(emg_psd[:, fmask, :], axis=(1, 2))
            results[muscle_name] = (power, psd_times)
        except (FileNotFoundError, ValueError) as e:
            print(f"Could not load {muscle_name}: {e}")
            results[muscle_name] = None
    return results


def cohort_sampling_rate_sweep(subject_ids, experiment_data_dir,
                               feature_data_dir,
                               nominal_fs: float = 2048.0
                               ) -> pd.DataFrame:
    """Per-subject drift table (reference :167-341)."""
    from mba_tpu_torch.utils import file_management as filemgmt
    rows = []
    for subject in subject_ids:
        exp_dir = Path(experiment_data_dir) / f"subject_{subject:02}"
        feat_dir = Path(feature_data_dir) / f"subject_{subject:02}"
        try:
            log_df = di.fetch_enriched_log_frame(exp_dir, verbose=False)
            eeg_path = filemgmt.most_recent_file(feat_dir, ".npy",
                                                 ["eeg"])
            n_samples = np.load(eeg_path, mmap_mode='r').shape[0]
        except (ValueError, FileNotFoundError):
            continue
        rows.append({"Subject ID": subject,
                     **calculate_actual_sampling_rate(
                         n_samples, log_df, nominal_fs)})
    return pd.DataFrame(rows)


def analyze_task_alignment(emg_power: np.ndarray,
                           psd_times: pd.DatetimeIndex,
                           force_series: pd.Series,
                           task_start: pd.Timestamp,
                           task_end: pd.Timestamp,
                           task_name: str,
                           min_peak_distance: float = 2.0,
                           max_matching_delay: float = 5.0) -> dict:
    """EMG-power vs force alignment for one task (reference
    time_alignment_validation_workflow.py:455-586): peak matching within
    a delay window + windowed normalized cross-correlation.

    Returns match counts/rates, matched-peak lag stats and the optimal
    cross-correlation lag — the per-task drill-down behind
    :func:`validate_muscle_identity`.
    """
    from scipy import signal as sps

    psd_mask = (psd_times >= task_start) & (psd_times <= task_end)
    emg_task = np.asarray(emg_power)[psd_mask]
    times_task = psd_times[psd_mask]
    force_task = force_series[(force_series.index >= task_start)
                              & (force_series.index <= task_end)]
    if len(emg_task) < 10 or len(force_task) < 10:
        return {"task_name": task_name,
                "duration_sec": (task_end
                                 - task_start).total_seconds(),
                "n_emg_samples": int(len(emg_task)),
                "n_force_samples": int(len(force_task)),
                "error": "Insufficient data"}

    dt = np.median((times_task[1:] - times_task[:-1]).total_seconds())
    fs_psd = 1.0 / dt
    dist = max(int(min_peak_distance * fs_psd), 1)

    emg_peaks, _ = sps.find_peaks(
        emg_task, distance=dist,
        prominence=np.percentile(emg_task, 80) - np.median(emg_task))
    t_sec = (times_task - times_task[0]).total_seconds().to_numpy()
    f_sec = (force_task.index - times_task[0]).total_seconds() \
        .to_numpy()
    force_resampled = np.interp(t_sec, f_sec,
                                force_task.to_numpy(float))
    force_peaks, _ = sps.find_peaks(
        force_resampled, distance=dist,
        prominence=np.percentile(force_resampled, 75)
        - np.median(force_resampled))

    lags = []
    for pe in t_sec[emg_peaks]:
        delays = t_sec[force_peaks] - pe
        ok = np.abs(delays) <= max_matching_delay
        if ok.any():
            lags.append(delays[ok][np.argmin(np.abs(delays[ok]))])

    emg_n = (emg_task - emg_task.mean()) / (emg_task.std() + 1e-10)
    frc_n = (force_resampled - force_resampled.mean()) \
        / (force_resampled.std() + 1e-10)
    corr = sps.correlate(frc_n, emg_n, mode="same") / len(emg_task)
    center = len(corr) // 2
    max_lag = int(10.0 * fs_psd)
    lo = max(center - max_lag, 0)
    hi = min(center + max_lag + 1, len(corr))
    window = corr[lo:hi]
    lag_axis = (np.arange(lo, hi) - center) / fs_psd
    best = int(np.argmax(window))

    return {"task_name": task_name,
            "duration_sec": (task_end - task_start).total_seconds(),
            "n_emg_peaks": int(len(emg_peaks)),
            "n_force_peaks": int(len(force_peaks)),
            "n_matched_peaks": int(len(lags)),
            "match_rate": len(lags) / max(len(emg_peaks), 1),
            "mean_lag_sec": float(np.mean(lags)) if lags else np.nan,
            "median_lag_sec": float(np.median(lags)) if lags
            else np.nan,
            "std_lag_sec": float(np.std(lags)) if lags else np.nan,
            "cross_corr_optimal_lag_sec": float(lag_axis[best]),
            "cross_corr_max": float(window[best]),
            "error": None}


def create_multi_task_comparison_plot(task_results: list[dict],
                                      save_dir=None, show: bool = False):
    """Per-task alignment dashboard (reference :~900-1000): matched-peak
    lags + cross-correlation optima across tasks."""
    from mba_tpu_torch.pipeline.visualizations import (_pyplot,
                                                        smart_save_fig)
    plt = _pyplot()

    valid = [r for r in task_results if not r.get("error")]
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    names = [r["task_name"] for r in valid]
    axes[0].bar(names, [r["median_lag_sec"] for r in valid],
                yerr=[r["std_lag_sec"] for r in valid], capsize=3)
    axes[0].axhline(0, color="k", lw=0.8)
    axes[0].set_ylabel("median matched-peak lag [s]")
    axes[0].set_title("EMG-force peak alignment per task")
    axes[1].scatter([r["cross_corr_optimal_lag_sec"] for r in valid],
                    [r["cross_corr_max"] for r in valid])
    for r in valid:
        axes[1].annotate(r["task_name"],
                         (r["cross_corr_optimal_lag_sec"],
                          r["cross_corr_max"]), fontsize=7)
    axes[1].set_xlabel("optimal lag [s]")
    axes[1].set_ylabel("max cross-correlation")
    for ax in axes:
        ax.tick_params(axis="x", rotation=45, labelsize=7)
    fig.tight_layout()
    if save_dir is not None:
        smart_save_fig(save_dir, "Task Alignment Comparison", fig=fig)
    if show:                       # pragma: no cover - needs a display
        plt.show()
    else:
        plt.close(fig)
    return fig


def create_power_comparison_plot(flexor_power: np.ndarray,
                                 extensor_power: np.ndarray,
                                 psd_times, force_series: pd.Series,
                                 save_dir=None, show: bool = False):
    """Flexor vs extensor band power over force (reference :~1000-1100):
    visual check that the flexor envelope tracks grip force."""
    from mba_tpu_torch.pipeline.visualizations import (_pyplot,
                                                        smart_save_fig)
    plt = _pyplot()

    fig, ax1 = plt.subplots(figsize=(12, 4))
    ax1.plot(psd_times, flexor_power, lw=0.8, label="flexor power")
    ax1.plot(psd_times, extensor_power, lw=0.8, label="extensor power")
    ax1.set_ylabel("EMG band power")
    ax2 = ax1.twinx()
    ax2.plot(force_series.index, force_series.values, lw=0.8,
             color="tab:green", alpha=0.6, label="force")
    ax2.set_ylabel("force [V]")
    lines1, labels1 = ax1.get_legend_handles_labels()
    lines2, labels2 = ax2.get_legend_handles_labels()
    ax1.legend(lines1 + lines2, labels1 + labels2, fontsize=8)
    ax1.set_title("EMG power vs force")
    if save_dir is not None:
        smart_save_fig(save_dir, "Power Comparison", fig=fig)
    if show:                       # pragma: no cover - needs a display
        plt.show()
    else:
        plt.close(fig)
    return fig


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    paths = StudyPaths().ensure()
    sweep = cohort_sampling_rate_sweep(range(12), paths.experiment_data,
                                       paths.feature_data)
    print(sweep.to_string(index=False))
