"""Ad-hoc serial-modality inspection script.

Parity target: reference ``src/pipeline/serial_testing.py`` (:13-96) —
plot one serial modality (fsr / ecg / gsr) for a subject and optionally
overlay the derived heart rate / HRV.  Rebuilt headless: figures save to
disk instead of requiring a display.  A copy of
``mba_tpu/workflows/serial_testing_workflow.py`` that imports matplotlib
only to draw (the card machine has none).
"""
from __future__ import annotations

from pathlib import Path

from mba_tpu_torch.pipeline import data_integration
from mba_tpu_torch.pipeline import signal_features as features
from mba_tpu_torch.pipeline.visualizations import _pyplot, smart_save_fig


def inspect_serial_modality(subject_experiment_dir: str | Path,
                            modality: str = "ecg",
                            compute_hr: bool = True,
                            max_seconds: float | None = None,
                            save_dir: str | Path | None = None,
                            show: bool = False):
    """Plot one serial modality, optionally with HR/HRV overlay
    (reference serial_testing.py:13-96)."""
    serial_df = data_integration.fetch_serial_measurements(
        Path(subject_experiment_dir))
    if modality not in serial_df.columns:
        raise ValueError(f"modality {modality!r} not in serial frame "
                         f"(have {list(serial_df.columns)})")
    series = serial_df[modality]
    if max_seconds is not None and len(series) > 1:
        span = (series.index[-1] - series.index[0]).total_seconds()
        if span > max_seconds:
            series = series.iloc[:int(len(series) * max_seconds / span)]

    plt = _pyplot()
    n_rows = 2 if (compute_hr and modality == "ecg") else 1
    fig, axes = plt.subplots(n_rows, 1, figsize=(12, 3 * n_rows),
                             sharex=True, squeeze=False)
    axes[0, 0].plot(series.index, series.values, lw=0.6)
    axes[0, 0].set_ylabel(f"{modality} [V]")
    axes[0, 0].set_title(f"Serial modality: {modality}")

    if n_rows == 2:
        bpm, hrv = features.compute_heart_rate_and_variability(
            serial_df["ecg"], verbose=False)
        axes[1, 0].plot(serial_df.index[:len(bpm)], bpm, lw=0.8,
                        label="heart rate [bpm]")
        ax2 = axes[1, 0].twinx()
        ax2.plot(serial_df.index[:len(hrv)], hrv, lw=0.8,
                 color="tab:orange", label="HRV (RMSSD) [ms]")
        axes[1, 0].set_ylabel("bpm")
        ax2.set_ylabel("RMSSD [ms]")
        axes[1, 0].legend(loc="upper left", fontsize=8)
        ax2.legend(loc="upper right", fontsize=8)
    axes[-1, 0].set_xlabel("time")

    if save_dir is not None:
        smart_save_fig(save_dir, f"Serial Testing {modality}", fig=fig)
    if show:                       # pragma: no cover - needs a display
        plt.show()
    else:
        plt.close(fig)
    return fig


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    subject = 0
    modality = "ecg"
    paths = StudyPaths()
    inspect_serial_modality(paths.subject_experiment_dir(subject),
                            modality=modality,
                            save_dir=paths.output_dir, show=False)
