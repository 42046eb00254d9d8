"""Presentation layer: the plots the omnibus workflow draws.

A subset of ``mba_tpu/pipeline/visualizations.py`` (host code, copied):
``smart_save_fig``, the forest plot and mosaic, the p-column resolver and
the time-resolution forest plot and mosaic; the CBPA figure; the MI
barplot; the phase-average figures of the RQ-A post-hoc workflow with
their target-sine strip and the phase-averaged dynamometer force.  The
rest of the module comes later (ROADMAP A8b).

matplotlib is imported only when a function draws (headless, Agg), so
the package loads on a machine without it.
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Literal

import numpy as np
import pandas as pd

from mba_tpu_torch.utils import file_management as filemgmt


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


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
