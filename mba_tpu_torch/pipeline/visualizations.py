"""Presentation layer: the plots the omnibus workflow draws.

A subset of ``mba_tpu/pipeline/visualizations.py`` (host code, copied):
``smart_save_fig``, the forest plot and mosaic, the p-column resolver and
the time-resolution forest plot and mosaic.  The rest of the module comes
later (ROADMAP A8b).

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
