"""Presentation layer: plotting for every pipeline stage.

A host copy of ``mba_tpu/pipeline/visualizations.py``: electrode
heatmaps, frequency-domain plots, spectrograms, scatters, CI line plots,
forest plots and mosaics, CMC per-category lineplots, phase-average
figures, CBPA t-map + cluster figures, the category-reassignment flow
(a matplotlib ribbon plot), MI barplots and descriptive box mosaics.

matplotlib is imported only when a function draws (headless, Agg), so
the package loads on a machine without it.
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Literal

import numpy as np
import pandas as pd

from mba_tpu_torch.channel_layout import EEG_CHANNELS, eeg_positions_3d
from mba_tpu_torch.utils import file_management as filemgmt


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


# ── electrode coordinate tables (reference visualizations.py:61-137) ──
_pos3d = eeg_positions_3d(EEG_CHANNELS)
EEG_POSITIONS: dict[str, tuple[float, float]] = {
    ch: (float(_pos3d[i, 0]), float(_pos3d[i, 1]))
    for i, ch in enumerate(EEG_CHANNELS)}
EMG_POSITIONS: dict[str, tuple[float, float]] = {
    f"EMG{i:02d}": (float(i % 8), float(i // 8)) for i in range(64)}


def smart_save_fig(save_dir: str | Path, title: str,
                   suffix: str = ".png", fig=None, dpi: int = 150
                   ) -> Path:
    """Save the current (or given) figure with a timestamped title."""
    save_dir = Path(save_dir)
    filemgmt.assert_dir(save_dir)
    path = save_dir / filemgmt.file_title(title, suffix)
    (fig or _pyplot().gcf()).savefig(path, dpi=dpi, bbox_inches="tight")
    return path


# ══════════════════════════════════════════════════════════════════════
#  frequency / spectrogram family (reference :522-921)
# ══════════════════════════════════════════════════════════════════════
def plot_freq_domain(amplitude_spectrum: np.ndarray, freqs: np.ndarray,
                     title: str = "Amplitude Spectrum",
                     log_scale: bool = False,
                     save_dir: str | Path | None = None,
                     show: bool = False):
    """Amplitude-vs-frequency plot (reference :522)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    amp = np.atleast_2d(amplitude_spectrum.T).T
    for ch in range(amp.shape[1]):
        ax.plot(freqs, amp[:, ch], lw=0.8, alpha=0.8)
    if log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("Frequency [Hz]")
    ax.set_ylabel("Amplitude")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax


def plot_spectrogram(spectrogram: np.ndarray,
                     timestamps: np.ndarray | None = None,
                     frequencies: np.ndarray | None = None,
                     title: str = "Spectrogram",
                     cmap: str = "viridis",
                     vlim: tuple | None = None,
                     frequency_range: tuple | None = None,
                     colorbar_label: str = "Power",
                     phase_series: pd.Series | None = None,
                     save_dir: str | Path | None = None,
                     show: bool = False):
    """Time × frequency imshow spectrogram (reference :589-921), with an
    optional experiment-phase strip below (``phase_series``: Phase labels
    indexed by time, reference :846-903)."""
    spec = np.asarray(spectrogram)
    t = (timestamps if timestamps is not None
         else np.arange(spec.shape[0]))
    f = (frequencies if frequencies is not None
         else np.arange(spec.shape[1]))
    plt = _pyplot()
    if phase_series is not None:
        fig, (ax, ax_phase) = plt.subplots(
            2, 1, figsize=(10, 6), sharex=False,
            gridspec_kw={"height_ratios": (5, 1), "hspace": 0.35})
    else:
        fig, ax = plt.subplots(figsize=(10, 5))
        ax_phase = None
    if frequency_range is not None and frequencies is not None:
        sel = (f >= frequency_range[0]) & (f <= frequency_range[1])
        spec = spec[:, sel]
        f = f[sel]
    vmin, vmax = vlim if vlim is not None else (None, None)
    im = ax.imshow(spec.T, aspect="auto", origin="lower", cmap=cmap,
                   extent=[t[0], t[-1], f[0], f[-1]],
                   vmin=vmin, vmax=vmax)
    ax.set_xlabel("Time [s]")
    ax.set_ylabel("Frequency [Hz]")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label=colorbar_label)
    if ax_phase is not None:
        plot_phase_band_subplot(ax_phase, phase_series,
                                (float(t[0]), float(t[-1])))
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax


def initialise_electrode_heatmap(data: np.ndarray,
                                 positions: dict | None = None,
                                 add_head_shape: bool = True,
                                 value_label: str = "Value",
                                 plot_title: str = "Electrode Heatmap",
                                 timestep: int = 0,
                                 save_dir: str | Path | None = None,
                                 show: bool = False):
    """Scalp/grid electrode heatmap at one timestep (reference :317-520).

    data: (n_channels, n_timesteps) or (n_channels,).
    """
    positions = positions or EEG_POSITIONS
    values = np.asarray(data)
    if values.ndim == 2:
        values = values[:, timestep]
    names = list(positions.keys())[:len(values)]
    xs = np.array([positions[ch][0] for ch in names])
    ys = np.array([positions[ch][1] for ch in names])
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(xs, ys, c=values[:len(names)], s=350,
                    cmap="RdBu_r", edgecolors="k", zorder=3)
    for x, y, ch in zip(xs, ys, names):
        ax.annotate(ch, (x, y), ha="center", va="center", fontsize=5,
                    zorder=4)
    if add_head_shape:
        r = 1.15 * max(np.abs(xs).max(), np.abs(ys).max())
        ax.add_patch(plt.Circle((0, 0), r, fill=False, lw=1.5))
        ax.plot([0, -0.08 * r, 0.08 * r, 0],
                [r, r * 1.08, r * 1.08, r], "k-", lw=1.0)
    ax.set_aspect("equal")
    ax.axis("off")
    ax.set_title(plot_title)
    fig.colorbar(sc, ax=ax, label=value_label, shrink=0.7)
    if save_dir is not None:
        smart_save_fig(save_dir, plot_title, fig=fig)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax


def plot_psd_avg_with_std(freq_psd_dict: dict,
                          sampling_freq: float,
                          figsize=(14, 7), linewidth: float = 2.5,
                          std_factor: float = 0.1,
                          std_alpha: float = 0.25,
                          colors: list | None = None,
                          title: str = "Frequency Bands - Power "
                                       "Spectral Density Over Time",
                          save_dir: str | Path | None = None,
                          show: bool = False):
    """Per-band channel-averaged PSD traces with shaded ±std·factor
    regions (reference visualizations.py:1151-1233).

    freq_psd_dict: {band name: (n_samples, n_channels) array}.
    """
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=figsize)
    palette = colors or [f"C{i}" for i in range(10)]
    for i, (band, values) in enumerate(freq_psd_dict.items()):
        values = np.asarray(values)
        if values.ndim == 1:
            values = values[:, None]
        t = np.arange(values.shape[0]) / sampling_freq
        mean = np.nanmean(values, axis=1)
        std = np.nanstd(values, axis=1) * std_factor
        color = palette[i % len(palette)]
        ax.plot(t, mean, lw=linewidth, color=color, label=band)
        ax.fill_between(t, mean - std, mean + std, color=color,
                        alpha=std_alpha)
    ax.set_xlabel("Time [s]")
    ax.set_ylabel("PSD")
    ax.set_title(title)
    ax.legend(fontsize=9)
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax


def animate_electrode_heatmap(data: np.ndarray,
                              positions: dict | None = None,
                              add_head_shape: bool = True,
                              value_label: str = "Value",
                              plot_title: str = "Electrode Heatmap",
                              fps: float = 10.0,
                              max_frames: int | None = None,
                              save_path: str | Path | None = None,
                              show: bool = False):
    """Animated scalp/grid heatmap over time (reference :317-520, the
    FuncAnimation branch of the electrode-heatmap family).

    data: (n_channels, n_timesteps).  Color limits are fixed to the
    global range so frames are comparable.  Returns (fig, animation);
    with ``save_path`` the animation is written as a GIF via
    PillowWriter (no ffmpeg dependency).
    """
    from matplotlib.animation import FuncAnimation, PillowWriter

    positions = positions or EEG_POSITIONS
    values = np.asarray(data)
    if values.ndim != 2:
        raise ValueError("animate_electrode_heatmap expects "
                         "(n_channels, n_timesteps)")
    n_frames = values.shape[1] if max_frames is None \
        else min(values.shape[1], max_frames)
    names = list(positions.keys())[:values.shape[0]]
    xs = np.array([positions[ch][0] for ch in names])
    ys = np.array([positions[ch][1] for ch in names])
    vmin, vmax = (float(np.nanmin(values)), float(np.nanmax(values)))

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(xs, ys, c=values[:len(names), 0], s=350,
                    cmap="RdBu_r", edgecolors="k", zorder=3,
                    vmin=vmin, vmax=vmax)
    for x, y, ch in zip(xs, ys, names):
        ax.annotate(ch, (x, y), ha="center", va="center", fontsize=5,
                    zorder=4)
    if add_head_shape:
        r = 1.15 * max(np.abs(xs).max(), np.abs(ys).max())
        ax.add_patch(plt.Circle((0, 0), r, fill=False, lw=1.5))
    ax.set_aspect("equal")
    ax.axis("off")
    title = ax.set_title(f"{plot_title} — t=0")
    fig.colorbar(sc, ax=ax, label=value_label, shrink=0.7)

    def update(frame):
        sc.set_array(values[:len(names), frame])
        title.set_text(f"{plot_title} — t={frame}")
        return [sc, title]

    anim = FuncAnimation(fig, update, frames=n_frames,
                         interval=1000.0 / fps, blit=False,
                         cache_frame_data=False)
    if save_path is not None:
        anim.save(str(save_path), writer=PillowWriter(fps=fps))
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, anim


# ══════════════════════════════════════════════════════════════════════
#  scatter / CI-line family (reference :924-1743)
# ══════════════════════════════════════════════════════════════════════
def plot_scatter(x, y, x_label: str = "x", y_label: str = "y",
                 category_list: list | None = None,
                 category_label: str = "Category",
                 add_regression: bool = True,
                 title: str | None = None,
                 save_dir: str | Path | None = None,
                 show: bool = False):
    """Scatter with optional per-category colouring and OLS trend line
    (reference :924)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    if category_list is not None:
        cats = pd.Series(category_list)
        for cat in cats.unique():
            sel = (cats == cat).to_numpy()
            ax.scatter(x[sel], y[sel], label=f"{category_label} {cat}",
                       alpha=0.8)
        ax.legend(fontsize=8)
    else:
        ax.scatter(x, y, alpha=0.8)
    if add_regression and len(x) > 2 and np.std(x) > 0:
        coeffs = np.polyfit(x, y, 1)
        xs = np.linspace(x.min(), x.max(), 50)
        ax.plot(xs, np.polyval(coeffs, xs), "k--", lw=1,
                label=f"slope={coeffs[0]:.3f}")
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    title = title or f"{y_label} vs {x_label}"
    ax.set_title(title)
    ax.grid(alpha=0.3)
    if save_dir is not None:
        smart_save_fig(save_dir, f"Scatter {x_label[:30]}", fig=fig)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax


def plot_array_with_ci(values: np.ndarray,
                       lower: np.ndarray | None = None,
                       upper: np.ndarray | None = None,
                       x_axis: np.ndarray | None = None,
                       label: str | None = None,
                       x_label: str = "Time [s]",
                       y_label: str = "Value",
                       title: str = "Signal with CI",
                       hline: float | None = None,
                       ax=None,
                       save_dir: str | Path | None = None,
                       show: bool = False):
    """Line plot with a shaded confidence band (reference :1235-1743)."""
    own_fig = ax is None
    plt = _pyplot()
    if own_fig:
        fig, ax = plt.subplots(figsize=(10, 4))
    else:
        fig = ax.figure
    x = x_axis if x_axis is not None else np.arange(len(values))
    ax.plot(x, values, lw=1.5, label=label)
    if lower is not None and upper is not None:
        ax.fill_between(x, lower, upper, alpha=0.25)
    if hline is not None:
        ax.axhline(hline, color="r", ls=":", lw=1,
                   label=f"threshold {hline:.3f}")
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    if label or hline is not None:
        ax.legend(fontsize=8)
    if own_fig and save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if own_fig and not show:
        plt.close(fig)
    return fig, ax


# ══════════════════════════════════════════════════════════════════════
#  forest plots (reference :1783-2441)
# ══════════════════════════════════════════════════════════════════════
def draw_forest_plot(results_df: pd.DataFrame,
                     coef_col: str = "Coefficient",
                     se_col: str = "SE",
                     p_col: str = "p_value_for_plot",
                     param_col: str = "Parameter",
                     title: str = "Forest Plot",
                     alpha: float = 0.05,
                     ax=None,
                     save_dir: str | Path | None = None,
                     show: bool = False):
    """β ± 1.96·SE forest plot, significant effects highlighted
    (reference :1783-2011)."""
    df = results_df.copy()
    df = df[~df[param_col].astype(str).str.startswith("__")]
    df = df[df[param_col] != "Intercept"]
    if df.empty:
        return None, None
    plt = _pyplot()
    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(
            figsize=(8, max(2, 0.45 * len(df))))
    else:
        fig = ax.figure
    y = np.arange(len(df))[::-1]
    coefs = pd.to_numeric(df[coef_col], errors="coerce").to_numpy()
    ses = pd.to_numeric(df[se_col], errors="coerce").to_numpy()
    pvals = (pd.to_numeric(df[p_col], errors="coerce").to_numpy()
             if p_col in df.columns else np.ones(len(df)))
    sig = pvals < alpha
    ax.errorbar(coefs, y, xerr=1.96 * ses, fmt="none", ecolor="gray",
                capsize=3)
    ax.scatter(coefs[~sig], y[~sig], c="gray", zorder=3)
    ax.scatter(coefs[sig], y[sig], c="crimson", zorder=3,
               label=f"p < {alpha}")
    ax.axvline(0, color="k", lw=1)
    ax.set_yticks(y)
    ax.set_yticklabels(df[param_col], fontsize=7)
    ax.set_xlabel("Coefficient (95% CI)")
    ax.set_title(title, fontsize=9)
    if sig.any():
        ax.legend(fontsize=7)
    if own_fig and save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if own_fig and not show:
        plt.close(fig)
    return fig, ax


def draw_forest_mosaic(results_df: pd.DataFrame,
                       facet_col: str = "Dependent_Variable",
                       model_type: str = "LME",
                       title: str = "Forest Mosaic",
                       save_dir: str | Path | None = None,
                       show: bool = False):
    """Grid of forest plots, one per DV (reference :2230-2441)."""
    df = results_df[results_df.get("Model_Type", model_type)
                    == model_type]
    facets = df[facet_col].dropna().unique()
    if len(facets) == 0:
        return None
    plt = _pyplot()
    n_cols = min(4, len(facets))
    n_rows = -(-len(facets) // n_cols)
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(5 * n_cols, 3.2 * n_rows),
                             squeeze=False)
    for i, facet in enumerate(facets):
        ax = axes[i // n_cols][i % n_cols]
        draw_forest_plot(df[df[facet_col] == facet],
                         title=str(facet), ax=ax)
    for j in range(len(facets), n_rows * n_cols):
        axes[j // n_cols][j % n_cols].axis("off")
    fig.suptitle(title)
    fig.tight_layout()
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if not show:
        plt.close(fig)
    return fig


def _resolve_p_column(df: pd.DataFrame,
                      significance_source: Literal["autocorr", "fdr",
                                                   "auto"] = "auto",
                      fdr_col: str = "p_value_fdr",
                      autocorr_col: str = "p_value_adjusted",
                      fallback_col: str = "p_value_for_plot") -> str:
    """Name of the p-value column for significance colouring
    (reference :1745-1781 semantics).

    'auto'     → p_value_for_plot if present (FDR where available,
                 autocorr-adjusted elsewhere), else p_value_adjusted
    'fdr'      → p_value_fdr; warn + fall back if absent/all-NaN
    'autocorr' → always p_value_adjusted
    """
    if significance_source == "autocorr":
        return autocorr_col
    if significance_source == "fdr":
        if fdr_col not in df.columns or df[fdr_col].isna().all():
            warnings.warn(
                f"[Forest plot] significance_source='fdr' but '{fdr_col}' "
                f"is absent or all-NaN. Falling back to '{autocorr_col}'.")
            return autocorr_col
        return fdr_col
    if fallback_col in df.columns and not df[fallback_col].isna().all():
        return fallback_col
    return autocorr_col


def plot_hypothesis_forest_mosaic(
        result_frame: pd.DataFrame,
        hypotheses: list[str],
        exclude_intercepts: bool = True,
        model_type: str | None = "LME",
        output_dir: Path | None = None,
        file_identifier_suffix: str | None = None,
        hidden: bool = False,
        plot_size: tuple[int, int] | Literal["auto"] = "auto",
        significance_source: Literal["autocorr", "fdr", "auto"] = "auto",
        show_title: bool = False,
        rename_dict: dict[str, str] | None = None,
        show_hypothesis_number: bool = False):
    """One forest subplot per hypothesis, shared parameter axis
    (reference :2342-2441; same slicing, formula-term cleanup and p-column
    resolution — rendered via :func:`draw_forest_plot`)."""
    df = result_frame.copy()
    if exclude_intercepts:
        df = df[df["Parameter"] != "Intercept"]
    if model_type is not None and "Model_Type" in df.columns:
        df = df[df["Model_Type"] == model_type]
    df = df[~df["Parameter"].isin({"__re_std__", "__residual_std__"})]
    for tok in ("C(", "Q(", "'", ")"):
        df["Parameter"] = df["Parameter"].astype(str).str.replace(
            tok, "", regex=False)
    if rename_dict:
        df["Parameter"] = df["Parameter"].replace(rename_dict)
    if plot_size == "auto":
        n_params = df["Parameter"].nunique(dropna=True)
        plot_size = (12, max(2.0, n_params / 3))
    plt = _pyplot()
    fig, axs = plt.subplots(1, max(len(hypotheses), 1), figsize=plot_size,
                            constrained_layout=True, squeeze=False)
    axs = axs.flatten()
    for col, hyp in enumerate(hypotheses):
        sub = df[df["Hypothesis"] == hyp]
        if sub.empty:
            axs[col].axis("off")
            continue
        p_col = _resolve_p_column(sub, significance_source)
        label = (f"{hyp}" if show_hypothesis_number
                 else str(sub["Dependent_Variable"].iloc[0])
                 if "Dependent_Variable" in sub.columns else str(hyp))
        draw_forest_plot(sub, p_col=p_col, title=label, ax=axs[col])
        if col > 0:
            axs[col].set_yticklabels([])
    fig_title = (f"Coefficient Overview"
                 f"{f' ({model_type} models)' if model_type else ''}"
                 f"{f' ({file_identifier_suffix})' if file_identifier_suffix else ''}")
    if show_title:
        fig.suptitle(fig_title)
    if output_dir is not None:
        smart_save_fig(output_dir, fig_title, fig=fig)
    if hidden:
        plt.close(fig)
    return fig


# ══════════════════════════════════════════════════════════════════════
#  CMC / phase-average family (reference :2446-4029)
# ══════════════════════════════════════════════════════════════════════
def plot_cmc_per_category(band_values_by_category: dict[str, np.ndarray],
                          x_axis: np.ndarray | None = None,
                          y_label: str = "CMC",
                          title: str = "CMC per Category",
                          save_dir: str | Path | None = None,
                          show: bool = False):
    """Per-category mean ± SEM lineplot (reference :2446-2632)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 5))
    for cat, arr in band_values_by_category.items():
        arr = np.atleast_2d(arr)
        mean = np.nanmean(arr, axis=0)
        sem = (np.nanstd(arr, axis=0)
               / np.sqrt(max(arr.shape[0], 1)))
        x = x_axis if x_axis is not None else np.arange(len(mean))
        ax.plot(x, mean, label=cat, lw=1.5)
        ax.fill_between(x, mean - sem, mean + sem, alpha=0.2)
    ax.set_ylabel(y_label)
    ax.set_title(title)
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if not show:
        plt.close(fig)
    return fig, ax


def plot_phase_average(profiles_by_condition: dict[str, list[np.ndarray]],
                       phase_grid: np.ndarray,
                       y_label: str = "Value",
                       title: str = "Phase Average",
                       show_target_sine: bool = False,
                       target_sine_min: float = 7.5,
                       target_sine_max: float = 22.5,
                       save_dir: str | Path | None = None,
                       show: bool = False):
    """Cycle-phase average figure with optional target-sine panel
    (reference :2968-4029: plot_cmc_accuracy_phase_average /
    plot_emg_psd_phase_average_plot / target-sine panels)."""
    n_rows = 2 if show_target_sine else 1
    plt = _pyplot()
    fig, axes = plt.subplots(n_rows, 1, figsize=(10, 4 * n_rows),
                             sharex=True, squeeze=False)
    ax = axes[0][0]
    for cond, profiles in profiles_by_condition.items():
        stack = np.stack([np.asarray(p, float).reshape(len(phase_grid),
                                                       -1).mean(axis=1)
                          for p in profiles])
        mean = np.nanmean(stack, axis=0)
        sem = np.nanstd(stack, axis=0) / np.sqrt(max(len(stack), 1))
        ax.plot(phase_grid, mean, label=f"{cond} (n={len(profiles)})")
        ax.fill_between(phase_grid, mean - sem, mean + sem, alpha=0.2)
    ax.set_ylabel(y_label)
    ax.set_title(title)
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    if show_target_sine:
        ax2 = axes[1][0]
        mid = (target_sine_min + target_sine_max) / 2
        amp = (target_sine_max - target_sine_min) / 2
        ax2.plot(phase_grid,
                 mid + amp * np.sin(np.deg2rad(phase_grid)), "k-")
        ax2.set_ylabel("Target force [%MVC]")
        ax2.set_xlabel("Force-cycle phase [deg]")
        ax2.grid(alpha=0.3)
    else:
        ax.set_xlabel("Force-cycle phase [deg]")
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if not show:
        plt.close(fig)
    return fig


def plot_cbpa_results(results: dict, cfg=None,
                      save_dir: str | Path | None = None,
                      show: bool = False):
    """t-map + significant-cluster contours + cluster time courses
    (reference :4030-4199)."""
    plt = _pyplot()
    t_obs = results["t_obs"]
    time_grid = results["time_grid"]
    ch_names = results["ch_names"]
    good = results["good_cluster_inds"]
    clusters = results["clusters"]
    t_ax = (time_grid if time_grid is not None
            else np.arange(t_obs.shape[0]))

    n_panels = 1 + min(len(good), 3)
    fig, axes = plt.subplots(n_panels, 1,
                             figsize=(11, 3.2 * n_panels),
                             squeeze=False)
    ax = axes[0][0]
    vmax = max(np.abs(t_obs).max(), 1e-6)
    im = ax.imshow(t_obs.T, aspect="auto", origin="lower",
                   cmap="RdBu_r", vmin=-vmax, vmax=vmax,
                   extent=[t_ax[0], t_ax[-1], -0.5,
                           t_obs.shape[1] - 0.5])
    for idx in good:
        mask = clusters[int(idx)]
        ys, xs = np.where(mask.T)
        ax.scatter(t_ax[xs], ys, s=4, c="k", marker="s", alpha=0.5)
    ax.set_yticks(range(len(ch_names)))
    ax.set_yticklabels(ch_names, fontsize=6)
    label = results.get("cfg")
    ax.set_title(f"Observed t-map "
                 f"({len(good)} significant cluster(s))")
    fig.colorbar(im, ax=ax, label="t")

    for panel, idx in enumerate(good[:3], start=1):
        mask = clusters[int(idx)]
        axc = axes[panel][0]
        cluster_t = np.where(mask, t_obs, np.nan)
        with np.errstate(invalid="ignore"):
            import warnings as _w
            with _w.catch_warnings():
                _w.simplefilter("ignore", RuntimeWarning)
                trace = np.nanmean(cluster_t, axis=1)
        axc.plot(t_ax, trace, lw=1.5)
        axc.axhline(0, color="k", lw=0.8)
        axc.set_title(f"Cluster #{int(idx) + 1} mean t "
                      f"(p={results['cluster_pv'][int(idx)]:.4f})")
        axc.grid(alpha=0.3)
    fig.tight_layout()
    out_dir = save_dir or (getattr(cfg, "output_dir", None))
    if out_dir is not None:
        label = getattr(cfg, "hypothesis_label", "cbpa")
        smart_save_fig(out_dir, f"CBPA {label}", fig=fig)
    if not show:
        plt.close(fig)
    return fig


# ══════════════════════════════════════════════════════════════════════
#  categorical flow / MI / descriptive mosaics (reference :149-316 etc.)
# ══════════════════════════════════════════════════════════════════════
def plot_category_reassignment_sankey(
        category_reassignment_frame: pd.DataFrame,
        song_colors: dict[str, str] | None = None,
        preferred_order: list[str] | None = None,
        rename_dict: dict[str, str] | None = None,
        show_title: bool = False,
        output_dir: str | Path | None = None,
        width: int = 600,
        height: int = 370):
    """Category reassignments as a two-column flow diagram
    (reference :149-316; signature-compatible — the frame's ``from``/``to``
    columns drive :func:`plot_category_sankey`'s native matplotlib ribbon
    rendering instead of plotly)."""
    del song_colors, width, height  # plotly-renderer specifics
    src = category_reassignment_frame[["from", "to"]].dropna()
    if len(src) == 0:
        print("No category reassignments available for Sankey plot.")
        return None
    del preferred_order  # ordering is frequency-driven natively
    # the save filename keeps the stable title either way; show_title
    # only controls the on-figure heading
    fig, _ = plot_category_sankey(
        src["from"].tolist(), src["to"].tolist(),
        title="Category Reassignment",
        rename_dict=rename_dict or {},
        save_dir=output_dir)
    if not show_title:
        for ax in fig.axes:
            ax.set_title("")
    return fig


def plot_category_sankey(source_labels: list, target_labels: list,
                         title: str = "Category Reassignment",
                         rename_dict: dict | None = None,
                         group_dict: dict | None = None,
                         save_dir: str | Path | None = None,
                         show: bool = False):
    """Category-flow diagram (the reference used a plotly Sankey,
    :149-316; rendered natively here as a two-column ribbon plot)."""
    rename_dict = rename_dict or {}
    group_dict = group_dict or {}

    def canon(lbl):
        lbl = rename_dict.get(lbl, lbl)
        return group_dict.get(lbl, lbl)

    src = [canon(s) for s in source_labels]
    tgt = [canon(t) for t in target_labels]
    flows = pd.crosstab(pd.Series(src, name="from"),
                        pd.Series(tgt, name="to"))
    cats_l = list(flows.index)
    cats_r = list(flows.columns)
    plt = _pyplot()
    from matplotlib.patches import Rectangle
    fig, ax = plt.subplots(figsize=(8, 6))
    l_sizes = flows.sum(axis=1)
    r_sizes = flows.sum(axis=0)
    l_pos, acc = {}, 0.0
    for c in cats_l:
        l_pos[c] = acc
        acc += l_sizes[c] + 1
    r_pos, acc = {}, 0.0
    for c in cats_r:
        r_pos[c] = acc
        acc += r_sizes[c] + 1
    cmap = plt.get_cmap("tab10")
    l_off = {c: 0.0 for c in cats_l}
    r_off = {c: 0.0 for c in cats_r}
    for i, s in enumerate(cats_l):
        ax.add_patch(Rectangle((0, l_pos[s]), 0.08, l_sizes[s],
                               color=cmap(i % 10)))
        ax.text(-0.03, l_pos[s] + l_sizes[s] / 2, s, ha="right",
                va="center", fontsize=8)
        for t in cats_r:
            n = flows.loc[s, t]
            if n == 0:
                continue
            y0 = l_pos[s] + l_off[s]
            y1 = r_pos[t] + r_off[t]
            xs = np.linspace(0.08, 0.92, 40)
            blend = (1 - np.cos(np.linspace(0, np.pi, 40))) / 2
            ys_lo = y0 * (1 - blend) + y1 * blend
            ax.fill_between(xs, ys_lo, ys_lo + n,
                            color=cmap(i % 10), alpha=0.4, lw=0)
            l_off[s] += n
            r_off[t] += n
    for j, t in enumerate(cats_r):
        ax.add_patch(Rectangle((0.92, r_pos[t]), 0.08, r_sizes[t],
                               color="gray", alpha=0.6))
        ax.text(1.03, r_pos[t] + r_sizes[t] / 2, t, ha="left",
                va="center", fontsize=8)
    ax.set_xlim(-0.35, 1.35)
    ax.axis("off")
    ax.set_title(title)
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if not show:
        plt.close(fig)
    return fig, flows


def plot_mi_barplot(feature_importance: dict, target_label: str,
                    plot_save_dir: str | Path | None = None,
                    figsize=(10, 6), show: bool = False):
    """MI feature-importance barplot (reference signal_features
    :2033-2063)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=figsize)
    features = list(feature_importance.keys())
    scores = list(feature_importance.values())
    bars = ax.bar(range(len(features)), scores, color="steelblue",
                  alpha=0.7, edgecolor="navy")
    ax.set_xlabel("Features", fontweight="bold")
    ax.set_ylabel("Mutual Information Score", fontweight="bold")
    ax.set_title(f"Feature Importance (MI: Feature <-> {target_label})",
                 fontweight="bold")
    ax.set_xticks(range(len(features)))
    ax.set_xticklabels(features, rotation=45, ha="right")
    top = max(scores) if scores else 1.0
    for bar, score in zip(bars, scores):
        ax.text(bar.get_x() + bar.get_width() / 2,
                bar.get_height() + top * 0.01, f"{score:.3f}",
                ha="center", va="bottom", fontsize=9)
    fig.tight_layout()
    if plot_save_dir is not None:
        smart_save_fig(plot_save_dir, "Mutual_Information_Barplot",
                       fig=fig)
    if not show:
        plt.close(fig)
    return fig, ax


def plot_combined_descriptive_mosaic(frames: dict[str, pd.Series],
                                     title: str = "Cohort Descriptives",
                                     save_dir: str | Path | None = None,
                                     show: bool = False):
    """Box-plot mosaic of cohort descriptives (reference
    descriptive_statistics_workflow.py:398-554)."""
    items = [(k, pd.to_numeric(v, errors="coerce").dropna())
             for k, v in frames.items()]
    items = [(k, v) for k, v in items if len(v)]
    if not items:
        return None
    n_cols = min(4, len(items))
    n_rows = -(-len(items) // n_cols)
    plt = _pyplot()
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(3.2 * n_cols, 3.0 * n_rows),
                             squeeze=False)
    for i, (name, series) in enumerate(items):
        ax = axes[i // n_cols][i % n_cols]
        ax.boxplot(series, orientation="vertical")
        ax.scatter(np.random.default_rng(0).normal(1, 0.04, len(series)),
                   series, alpha=0.5, s=12)
        ax.set_title(name, fontsize=8)
        ax.grid(alpha=0.3)
    for j in range(len(items), n_rows * n_cols):
        axes[j // n_cols][j % n_cols].axis("off")
    fig.suptitle(title)
    fig.tight_layout()
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if not show:
        plt.close(fig)
    return fig


def plot_cross_resolution_results(results_df: pd.DataFrame,
                                  parameter: str,
                                  dep_var: str,
                                  model_type: str = "LME",
                                  save_dir: str | Path | None = None,
                                  show: bool = False):
    """Coefficient ± CI across time resolutions (reference omnibus
    workflow :689-712)."""
    sub = results_df[(results_df["Parameter"] == parameter)
                     & (results_df["Dependent_Variable"] == dep_var)
                     & (results_df["Model_Type"] == model_type)]
    if sub.empty or "N. Segments" not in sub.columns:
        return None
    sub = sub.sort_values("N. Segments")
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.errorbar(sub["N. Segments"], sub["Coefficient"],
                yerr=1.96 * pd.to_numeric(sub["SE"], errors="coerce"),
                fmt="o-", capsize=4)
    ax.axhline(0, color="k", lw=1)
    ax.set_xlabel("N within-trial segments")
    ax.set_ylabel("Coefficient (95% CI)")
    ax.set_title(f"{dep_var}: {parameter} across resolutions",
                 fontsize=9)
    ax.grid(alpha=0.3)
    if save_dir is not None:
        smart_save_fig(save_dir, f"Cross Resolution {dep_var[:30]}",
                       fig=fig)
    if not show:
        plt.close(fig)
    return fig


# ══════════════════════════════════════════════════════════════════════
#  time-resolution forest family (reference :2011-2341)
# ══════════════════════════════════════════════════════════════════════
def draw_time_resolution_forest_plot(
        ax,
        effects_frame: pd.DataFrame,
        parameter: str,
        comparison_level,
        n_segments_column: str = "N. Segments",
        hypothesis: str | None = None,
        hypothesis_column: str = "Hypothesis",
        param_column: str = "Parameter",
        comparison_lvl_column: str = "Comparison_Level",
        model_type_column: str = "Model_Type",
        coeff_column: str = "Coefficient",
        se_column: str = "SE",
        p_column: str = "p_value",
        y_axis_label: str = "Model Time Resolution [sec]",
        CI_z_score: float = 1.96,
        significant_pos_color: str = "green",
        significant_neg_color: str = "red",
        insignificant_color: str = "#AAAAAA",
        include_y_labels: bool = True,
        rename_dict: dict | None = None,
        show_hypothesis_number: bool = False,
):
    """Forest plot of ONE parameter at ONE comparison level across time
    resolutions (reference :2011-2227): the y-axis holds one row per
    (time resolution × model type); markers are colored by significance
    and coefficient sign; whiskers are ±z·SE."""
    sel = ((effects_frame[param_column] == parameter)
           & (effects_frame[comparison_lvl_column] == comparison_level))
    if hypothesis is not None:
        sel &= effects_frame[hypothesis_column] == hypothesis
    sub = effects_frame[sel].copy()
    if sub.empty:
        ax.text(0.5, 0.5, "no rows", ha="center", va="center",
                transform=ax.transAxes, color="gray")
        return ax

    sub = sub.sort_values([n_segments_column, model_type_column])
    labels, y = [], 0
    for _, row in sub.iterrows():
        coeff = float(row[coeff_column])
        se = float(pd.to_numeric(row[se_column], errors="coerce"))
        p = float(pd.to_numeric(row[p_column], errors="coerce"))
        if np.isfinite(p) and p < 0.05:
            color = (significant_pos_color if coeff > 0
                     else significant_neg_color)
        else:
            color = insignificant_color
        ax.errorbar(coeff, y, xerr=CI_z_score * se, fmt="o", color=color,
                    ecolor=color, capsize=3, markersize=5)
        labels.append(f"{row[n_segments_column]} · "
                      f"{row[model_type_column]}")
        y += 1
    ax.axvline(0.0, color="black", lw=0.8, ls="--", alpha=0.6)
    ax.set_yticks(range(len(labels)))
    ax.set_yticklabels(labels if include_y_labels else [""] * len(labels),
                       fontsize=7)
    if include_y_labels:
        ax.set_ylabel(y_axis_label, fontsize=8)
    shown = (rename_dict or {}).get(parameter, parameter)
    if show_hypothesis_number and hypothesis is not None:
        shown = f"{hypothesis}\n{shown}"
    elif hypothesis is not None:
        shown = f"{hypothesis.split(':')[0]}\n{shown}" \
            if ":" in str(hypothesis) else shown
    ax.set_title(shown, fontsize=8)
    ax.grid(alpha=0.25, axis="x")
    return ax


def plot_time_resolution_forest_mosaic(
        result_frame: pd.DataFrame,
        hypotheses: list,
        parameter: str,
        comparison_level,
        n_segments_column: str = "N. Segments",
        exclude_intercepts: bool = True,
        model_type: str | None = None,
        y_axis_label: str = "Intra-Trial Segments",
        output_dir: str | Path | None = None,
        file_identifier_suffix: str | None = None,
        hidden: bool = True,
        plot_size="auto",
        significance_source: str = "auto",
        rename_dict: dict | None = None,
        show_hypothesis_number: bool = False,
        hypothesis_column: str = "Hypothesis",
):
    """Mosaic of time-resolution forest plots — one column per hypothesis,
    all showing one parameter at one comparison level (reference
    :2230-2341).  ``significance_source='auto'`` prefers the FDR-adjusted
    p column when present."""
    frame = result_frame
    if exclude_intercepts and "Parameter" in frame.columns:
        frame = frame[~frame["Parameter"].astype(str)
                      .str.lower().str.startswith(("intercept", "const"))]
    if model_type is not None:
        frame = frame[frame["Model_Type"] == model_type]

    p_col = "p_value"
    if significance_source in ("fdr", "auto") \
            and "p_value_fdr" in frame.columns \
            and frame["p_value_fdr"].notna().any():
        p_col = "p_value_fdr"

    plt = _pyplot()
    n = max(len(hypotheses), 1)
    if plot_size == "auto":
        plot_size = (2.2 * n + 1.5, 3.2)
    fig, axes = plt.subplots(1, n, figsize=plot_size, sharex=True)
    axes = np.atleast_1d(axes)
    for i, (ax, hyp) in enumerate(zip(axes, hypotheses)):
        draw_time_resolution_forest_plot(
            ax, frame, parameter, comparison_level,
            n_segments_column=n_segments_column, hypothesis=hyp,
            hypothesis_column=hypothesis_column, p_column=p_col,
            y_axis_label=y_axis_label, include_y_labels=(i == 0),
            rename_dict=rename_dict,
            show_hypothesis_number=show_hypothesis_number)
    fig.suptitle(f"{parameter} @ {comparison_level}", fontsize=9)
    fig.tight_layout()
    if output_dir is not None:
        suffix = f" {file_identifier_suffix}" if file_identifier_suffix \
            else ""
        smart_save_fig(output_dir,
                       f"Time Resolution Forest {parameter[:40]}{suffix}",
                       fig=fig)
    if hidden:
        plt.close(fig)
    return fig


# ══════════════════════════════════════════════════════════════════════
#  CMC line-plot family (reference :2446-2793)
# ══════════════════════════════════════════════════════════════════════
def _cmc_threshold(n_tapers: int, alpha: float) -> float:
    from mba_tpu_torch.ops.coherence import cmc_independence_threshold
    return cmc_independence_threshold(n_tapers, alpha=alpha)


def plot_cmc_lineplots_per_category(
        all_subject_data_frame: pd.DataFrame,
        category_column: str,
        muscle: str,
        cmc_operator: str,
        n_within_trial_segments: int,
        bands: tuple = ("beta", "gamma"),
        cmc_plot_min: float | None = None,
        cmc_plot_max: float | None = None,
        include_std_dev: bool = True,
        std_dev_factor: float = 0.2,
        colormap="tab10",
        save_dir: str | Path | None = None,
        show_significance_threshold: bool = True,
        n_tapers: int = 5,
        alpha: float = 0.2,
        subject_ids_subset: list | None = None,
        plot_size: tuple = (12, 6),
        show_legend: bool = True,
        show: bool = False,
) -> dict:
    """CMC across within-trial segments, one line per category (reference
    :2446-2630).  Consumes the combined-statistics frame's
    ``CMC_{muscle}_{operator}_{band}`` DVs with 'Segment ID' as trial
    time; mean across (subjects × trials) per category, optional ±factor·SD
    band and the Beta(K−2,K−2) independence threshold line."""
    frame = all_subject_data_frame
    if subject_ids_subset is not None:
        frame = frame[frame["Subject ID"].isin(subject_ids_subset)]
    plt = _pyplot()
    if isinstance(colormap, (list, tuple)):
        colors = list(colormap)
    else:
        cmap = plt.colormaps[colormap]
        colors = [cmap(i) for i in range(20)]

    figures = {}
    for band in bands:
        col = f"CMC_{muscle}_{cmc_operator}_{band}"
        if col not in frame.columns:
            continue
        fig, ax = plt.subplots(figsize=plot_size)
        for ci, (cat, grp) in enumerate(frame.groupby(category_column)):
            by_seg = grp.groupby("Segment ID")[col]
            x = by_seg.mean().index.to_numpy()
            mean = by_seg.mean().to_numpy()
            ax.plot(x, mean, color=colors[ci % len(colors)], lw=1.6,
                    label=str(cat))
            if include_std_dev:
                sd = by_seg.std().to_numpy()
                ax.fill_between(x, mean - std_dev_factor * sd,
                                mean + std_dev_factor * sd,
                                color=colors[ci % len(colors)], alpha=0.15)
        if show_significance_threshold:
            thr = _cmc_threshold(n_tapers, alpha)
            ax.axhline(thr, color="black", ls=":", lw=1,
                       label=f"independence threshold (α={alpha})")
        if cmc_plot_min is not None or cmc_plot_max is not None:
            ax.set_ylim(cmc_plot_min, cmc_plot_max)
        ax.set_xlabel(f"Within-trial segment "
                      f"(of {n_within_trial_segments})")
        ax.set_ylabel(f"{muscle} CMC ({cmc_operator}, {band})")
        if show_legend:
            ax.legend(fontsize=7)
        ax.grid(alpha=0.25)
        title = (f"CMC per {category_column} {muscle} {cmc_operator} "
                 f"{band} {n_within_trial_segments}seg")
        if save_dir is not None:
            smart_save_fig(save_dir, title, fig=fig)
        if not show:
            plt.close(fig)
        figures[band] = fig
    return figures


def plot_cmc_lineplot_normalised(
        all_subject_data_frame: pd.DataFrame,
        muscle: str,
        cmc_operator: str,
        n_within_trial_segments: int,
        bands: tuple = ("beta", "gamma"),
        cmc_plot_min: float = 80.0,
        cmc_plot_max: float = 120.0,
        trial_color: str = "tab:blue",
        trial_alpha: float = 0.4,
        line_width: float = 0.8,
        corridor_std_factor: float = 0.5,
        corridor_color: str = "grey",
        corridor_alpha: float = 0.15,
        save_dir: str | Path | None = None,
        subject_ids_subset: list | None = None,
        plot_size: tuple = (12, 6),
        show: bool = False,
) -> dict:
    """Per-trial CMC time courses normalised to each trial's own mean
    (= 100 %), with a cross-trial mean ± factor·SD corridor (reference
    :2632-2793) — exposes within-trial dynamics independent of the
    between-trial level differences."""
    frame = all_subject_data_frame
    if subject_ids_subset is not None:
        frame = frame[frame["Subject ID"].isin(subject_ids_subset)]

    figures = {}
    plt = _pyplot()
    for band in bands:
        col = f"CMC_{muscle}_{cmc_operator}_{band}"
        if col not in frame.columns:
            continue
        fig, ax = plt.subplots(figsize=plot_size)
        profiles = []
        for (_, _), grp in frame.groupby(["Subject ID", "Trial ID"]):
            grp = grp.sort_values("Segment ID")
            vals = grp[col].to_numpy(dtype=float)
            if len(vals) < 2 or not np.isfinite(vals).all() \
                    or vals.mean() == 0:
                continue
            prof = 100.0 * vals / vals.mean()
            ax.plot(grp["Segment ID"], prof, color=trial_color,
                    alpha=trial_alpha, lw=line_width)
            profiles.append(prof)
        if profiles:
            lens = {len(p) for p in profiles}
            if len(lens) == 1:
                arr = np.stack(profiles)
                x = np.arange(arr.shape[1])
                m, sd = arr.mean(axis=0), arr.std(axis=0)
                ax.plot(x, m, color="black", lw=1.8, label="mean")
                ax.fill_between(x, m - corridor_std_factor * sd,
                                m + corridor_std_factor * sd,
                                color=corridor_color,
                                alpha=corridor_alpha,
                                label=f"±{corridor_std_factor}·SD")
        ax.set_ylim(cmc_plot_min, cmc_plot_max)
        ax.set_xlabel(f"Within-trial segment "
                      f"(of {n_within_trial_segments})")
        ax.set_ylabel(f"{muscle} CMC ({cmc_operator}, {band}) "
                      f"[% of trial mean]")
        ax.axhline(100.0, color="black", lw=0.8, ls="--", alpha=0.5)
        ax.grid(alpha=0.25)
        title = (f"Normalised CMC {muscle} {cmc_operator} {band} "
                 f"{n_within_trial_segments}seg")
        if save_dir is not None:
            smart_save_fig(save_dir, title, fig=fig)
        if not show:
            plt.close(fig)
        figures[band] = fig
    return figures


# ══════════════════════════════════════════════════════════════════════
#  phase-average figure family (reference :3143-4029)
# ══════════════════════════════════════════════════════════════════════
def target_sine_values(x: np.ndarray, cfg) -> np.ndarray:
    """Target-force sine in %MVC (reference :3879-3903): starts at the
    mid value at x=0; ``x`` is phase in degrees under phase
    normalisation, seconds otherwise."""
    x = np.asarray(x, float)
    mid = 0.5 * (cfg.target_sine_min_pct_mvc + cfg.target_sine_max_pct_mvc)
    amp = 0.5 * (cfg.target_sine_max_pct_mvc - cfg.target_sine_min_pct_mvc)
    if getattr(cfg, "use_phase_normalization", False):
        rad = 2.0 * np.pi * x / 360.0
    else:
        rad = 2.0 * np.pi * cfg.target_sine_frequency_hz * x
    return mid + amp * np.sin(rad)


def plot_target_sine_panel(ax, x: np.ndarray, cfg, x_label: str,
                           show_ylabel: bool = True,
                           dynamometer_force_y: np.ndarray | None = None,
                           dynamometer_force_sd: np.ndarray | None = None,
                           is_unscaled_force: bool = True):
    """Bottom strip: the task's target sine, optionally overlaid with the
    measured mean dynamometer force ± SD (reference :3905-4029)."""
    y = target_sine_values(x, cfg)
    ax.plot(x, y, color="tab:green", lw=1.4, label="target")
    if dynamometer_force_y is not None:
        ax.plot(x, dynamometer_force_y, color="tab:orange", lw=1.2,
                label="measured force")
        if dynamometer_force_sd is not None:
            ax.fill_between(x, dynamometer_force_y - dynamometer_force_sd,
                            dynamometer_force_y + dynamometer_force_sd,
                            color="tab:orange", alpha=0.2)
    ax.set_xlim(float(x[0]), float(x[-1]))
    ax.set_xlabel(x_label, fontsize=8)
    if show_ylabel:
        ax.set_ylabel("Force\n[%MVC]" if not is_unscaled_force
                      else "Force", fontsize=8)
    ax.tick_params(labelsize=7)
    ax.grid(alpha=0.25)
    return ax


def load_avg_dynamometer_force_per_phase(
        subject_ids: list,
        experiment_results_dir: str | Path,
        phase_grid: np.ndarray,
        cfg,
        use_unscaled_force: bool = True,
        return_std: bool = False,
):
    """Average phase-normalised dynamometer force across all trials of all
    subjects (reference :3736-3876): per trial, the (scaled or raw) force
    from the enriched serial frame is cycle-segmented at the trial's task
    frequency and interpolated onto ``phase_grid``; profiles are averaged
    across every cycle of every trial of every subject."""
    from mba_tpu_torch.pipeline import data_integration as di
    from mba_tpu_torch.pipeline import data_analysis as da

    experiment_results_dir = Path(experiment_results_dir)
    col = "fsr" if use_unscaled_force else "Task-wise Scaled Force"
    profiles = []
    for subject in subject_ids:
        sdir = experiment_results_dir / f"subject_{int(subject):02}"
        try:
            serial = di.fetch_enriched_serial_frame(sdir)
            log_df = di.fetch_enriched_log_frame(sdir, verbose=False)
        except (FileNotFoundError, ValueError):
            continue
        if col not in serial.columns:
            alt = [c for c in serial.columns
                   if c.lower() in ("fsr", "force")]
            if not alt:
                continue
            use_col = alt[0]
        else:
            use_col = col
        spans = di.get_all_task_start_ends(log_df, "dict")
        for trial_id, (t_start, t_end) in spans.items():
            sel = log_df["Trial ID"] == trial_id
            freqs = pd.to_numeric(log_df.loc[sel, "Task Frequency"],
                                  errors="coerce").dropna()
            if freqs.empty or freqs.iloc[0] <= 0:
                continue
            task_freq = float(freqs.iloc[0])
            seg = serial.loc[t_start:t_end, use_col].dropna()
            if len(seg) < 4:
                continue
            t_rel = (seg.index - t_start).total_seconds().to_numpy()
            cycles = da.phase_normalize_cycles(
                signal=seg.to_numpy(float)[:, None], t_rel=t_rel,
                task_freq=task_freq,
                trial_dur_sec=(t_end - t_start).total_seconds(),
                phase_grid=phase_grid,
                min_samples_per_cycle=cfg.min_samples_per_cycle,
                verbose=False)
            for prof in cycles:
                profiles.append(np.asarray(prof).reshape(len(phase_grid)))
    if not profiles:
        return (None, None) if return_std else None
    arr = np.stack(profiles)
    mean = np.nanmean(arr, axis=0)
    if return_std:
        return mean, np.nanstd(arr, axis=0)
    return mean


def _phase_map_panel(ax, phase_grid, data_map, ch_labels, vlims, cmap,
                     phase_xticks, phase_marker_lines, title):
    im = ax.imshow(np.asarray(data_map).T, aspect="auto", origin="lower",
                   cmap=cmap,
                   extent=[float(phase_grid[0]), float(phase_grid[-1]),
                           -0.5, data_map.shape[1] - 0.5],
                   vmin=vlims[0], vmax=vlims[1])
    for pm in phase_marker_lines:
        ax.axvline(pm, color="white", lw=0.6, ls="--", alpha=0.7)
    ax.set_xticks(list(phase_xticks))
    if ch_labels is not None:
        ax.set_yticks(range(len(ch_labels)))
        ax.set_yticklabels(ch_labels, fontsize=6)
    ax.set_title(title, fontsize=9)
    ax.tick_params(labelsize=7)
    return im


def plot_cmc_accuracy_phase_average(
        phase_grid: np.ndarray,
        cmc_map: np.ndarray,
        accuracy_profiles: dict,
        cfg=None,
        map_grid: np.ndarray | None = None,
        cmc_channel_labels: list | None = None,
        accuracy_sd_factor: float = 0.25,
        cmc_percentile_limits: tuple = (3.0, 97.0),
        phase_xticks: tuple = (0.0, 90.0, 180.0, 270.0, 360.0),
        phase_marker_lines: tuple = (90.0, 270.0),
        force_mean: np.ndarray | None = None,
        force_sd: np.ndarray | None = None,
        save_dir: str | Path | None = None,
        title: str = "CMC + accuracy phase average",
        show: bool = False,
):
    """CBPA-style phase figure (reference :3143-3516): left panel the
    cohort-mean CMC map over (phase × EEG channel) with percentile color
    limits; right panel the phase-normalised accuracy profiles per
    condition (mean ± factor·SD); optional bottom strip with the target
    sine + measured force (when ``cfg.show_target_sine``).

    Data-first divergence from the reference: the maps/profiles arrive as
    arrays (produced by pipeline.cbpa / phase_normalize_cycles) instead of
    being loaded from the artifact store inside the plot function.
    """
    plt = _pyplot()
    with_sine = cfg is not None and bool(
        getattr(cfg, "show_target_sine", False))
    nrows = 2 if with_sine else 1
    fig = plt.figure(figsize=(12, 6 if with_sine else 5))
    gs = fig.add_gridspec(nrows, 4, width_ratios=(1.0, 0.05, 0.14, 1.0),
                          height_ratios=(5.0, 1.0) if with_sine else None,
                          wspace=0.25, hspace=0.3)
    ax_map = fig.add_subplot(gs[0, 0])
    ax_cb = fig.add_subplot(gs[0, 1])
    ax_acc = fig.add_subplot(gs[0, 3])

    vlims = np.percentile(cmc_map, cmc_percentile_limits)
    mgrid = phase_grid if map_grid is None else np.asarray(map_grid)
    phase_mode = map_grid is None
    im = _phase_map_panel(ax_map, mgrid, cmc_map, cmc_channel_labels,
                          vlims, "viridis",
                          phase_xticks if phase_mode else
                          np.linspace(mgrid[0], mgrid[-1], 5),
                          phase_marker_lines if phase_mode else (),
                          "mean CMC")
    ax_map.set_xlabel("Phase [deg]" if phase_mode else "Time [s]",
                      fontsize=8)
    fig.colorbar(im, cax=ax_cb, label="CMC")

    for cond, profs in accuracy_profiles.items():
        arr = np.stack([np.asarray(p).reshape(len(phase_grid))
                        for p in profs])
        m = np.nanmean(arr, axis=0)
        sd = np.nanstd(arr, axis=0)
        line, = ax_acc.plot(phase_grid, m, lw=1.5, label=str(cond))
        ax_acc.fill_between(phase_grid, m - accuracy_sd_factor * sd,
                            m + accuracy_sd_factor * sd,
                            color=line.get_color(), alpha=0.15)
    for pm in phase_marker_lines:
        ax_acc.axvline(pm, color="gray", lw=0.6, ls="--", alpha=0.7)
    ax_acc.set_xticks(list(phase_xticks))
    ax_acc.set_xlabel("Phase [deg]", fontsize=8)
    ax_acc.set_ylabel("Accuracy (squared error)", fontsize=8)
    ax_acc.legend(fontsize=7)
    ax_acc.grid(alpha=0.25)
    ax_acc.set_title("phase-normalised accuracy", fontsize=9)

    if with_sine:
        ax_sine = fig.add_subplot(gs[1, 0])
        plot_target_sine_panel(ax_sine, phase_grid, cfg, "Phase [deg]",
                               dynamometer_force_y=force_mean,
                               dynamometer_force_sd=force_sd)
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if not show:
        plt.close(fig)
    return fig


def plot_emg_psd_phase_average_plot(
        phase_grid: np.ndarray,
        flexor_map: np.ndarray,
        extensor_map: np.ndarray,
        cfg=None,
        emg_percentile_limits: tuple = (3.0, 97.0),
        phase_xticks: tuple = (0.0, 90.0, 180.0, 270.0, 360.0),
        phase_marker_lines: tuple = (90.0, 270.0),
        show_channel_labels: bool = True,
        force_mean: np.ndarray | None = None,
        force_sd: np.ndarray | None = None,
        save_dir: str | Path | None = None,
        title: str = "EMG PSD phase average",
        show: bool = False,
):
    """Phase-normalised average EMG-PSD figure, flexor left / extensor
    right with a shared color scale (reference :3519-3733); optional
    bottom target-sine strip with measured force.  Maps are
    (n_phase_bins × n_emg_channels)."""
    plt = _pyplot()
    with_sine = cfg is not None and bool(
        getattr(cfg, "show_target_sine", False))
    nrows = 2 if with_sine else 1
    fig = plt.figure(figsize=(12, 6 if with_sine else 5))
    gs = fig.add_gridspec(nrows, 4, width_ratios=(1.0, 0.05, 0.14, 1.0),
                          height_ratios=(5.0, 1.0) if with_sine else None,
                          wspace=0.25, hspace=0.3)
    ax_fl = fig.add_subplot(gs[0, 0])
    ax_cb = fig.add_subplot(gs[0, 1])
    ax_ex = fig.add_subplot(gs[0, 3])

    both = np.concatenate([np.asarray(flexor_map).ravel(),
                           np.asarray(extensor_map).ravel()])
    vlims = np.percentile(both, emg_percentile_limits)
    labels = ([f"EMG{i:02d}" for i in range(flexor_map.shape[1])]
              if show_channel_labels else None)
    im = _phase_map_panel(ax_fl, phase_grid, flexor_map, labels, vlims,
                          "magma", phase_xticks, phase_marker_lines,
                          "Flexor EMG PSD")
    _phase_map_panel(ax_ex, phase_grid, extensor_map, labels, vlims,
                     "magma", phase_xticks, phase_marker_lines,
                     "Extensor EMG PSD")
    ax_fl.set_xlabel("Phase [deg]", fontsize=8)
    ax_ex.set_xlabel("Phase [deg]", fontsize=8)
    fig.colorbar(im, cax=ax_cb, label="PSD")

    if with_sine:
        ax_sine = fig.add_subplot(gs[1, 0])
        plot_target_sine_panel(ax_sine, phase_grid, cfg, "Phase [deg]",
                               dynamometer_force_y=force_mean,
                               dynamometer_force_sd=force_sd)
    if save_dir is not None:
        smart_save_fig(save_dir, title, fig=fig)
    if not show:
        plt.close(fig)
    return fig


def plot_phase_band_subplot(ax_phase, phase_series: pd.Series,
                            time_extent: tuple,
                            phase_cmap: str = "tab10"):
    """Experiment-phase strip under a spectrogram: contiguous phase
    stretches as shaded, labeled spans (reference :846-903)."""
    import textwrap

    ax_phase.set_ylim(0, 1)
    ax_phase.set_xlim(*time_extent)
    ax_phase.set_yticks([])
    ax_phase.set_ylabel("Phase", fontsize=9)
    for side in ("top", "right", "left"):
        ax_phase.spines[side].set_visible(False)
    clean = phase_series.dropna() if phase_series is not None else None
    if clean is None or len(clean) == 0:
        ax_phase.text(0.5, 0.5, "No phases within time snippet",
                      ha="center", va="center",
                      transform=ax_phase.transAxes, fontsize=9,
                      color="gray")
        return ax_phase

    if isinstance(phase_series.index, pd.DatetimeIndex):
        secs = ((phase_series.index - phase_series.index[0])
                .total_seconds())
        times = pd.Series(np.asarray(secs))
    else:
        times = pd.Series(np.asarray(phase_series.index, float))
    filled = phase_series.fillna("No phase").reset_index(drop=True)
    run_ids = (filled != filled.shift(1)).cumsum()
    plt = _pyplot()
    cmap = plt.colormaps[phase_cmap]
    uniq = [p for p in filled.unique() if p != "No phase"]
    color_of = {p: cmap(i / max(len(uniq), 1))
                for i, p in enumerate(uniq)}
    for rid, grp in filled.groupby(run_ids):
        phase = grp.iloc[0]
        if phase == "No phase":
            continue
        start = float(times[grp.index].min())
        end = float(times[grp.index].max())
        ax_phase.axvspan(start, end, alpha=0.6, color=color_of[phase])
        ax_phase.text((start + end) / 2, 0.5,
                      textwrap.fill(str(phase), 12), ha="center",
                      va="center", fontsize=7)
    return ax_phase
