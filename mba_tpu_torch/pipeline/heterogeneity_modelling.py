"""Subject-heterogeneity analysis pipeline.

Parity target: reference ``src/pipeline/heterogeneity_modelling.py``
(877 LoC), five blocks (:1-13):

1. Responder-rate summary            (:54-80)
2. Mutual-information analysis       (:87-241)
3. MI summary with tercile ranking   (:248-305)
4. Ward agglomerative clustering with silhouette-based k selection and
   a minimum-cluster-size constraint (:312-605)
5. Cluster-coloured moderator scatters (:612-669)

Entry point :func:`run_heterogeneity_modelling` (:676-877) consumes the
omnibus CSVs (influence, all-time-resolutions results, subject effect
summary) plus per-subject personal data.

A host copy of ``mba_tpu/pipeline/heterogeneity_modelling.py``.  sklearn,
``scipy.cluster.hierarchy`` and matplotlib are imported inside the
functions that use them, so the package loads without them.
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Literal

import numpy as np
import pandas as pd

from mba_tpu_torch.pipeline.signal_features import \
    compute_feature_mi_importance
from mba_tpu_torch.utils import file_management as filemgmt

PlotKey = Literal["cooks_d", "dfbeta", "contrast"]

_METRIC_ORDER: dict[str, int] = {"DFBETA": 0, "CooksD": 1, "Contrast": 2}
_CLUSTER_PALETTE: list[str] = ["#e377c2", "#17becf", "#2ca02c", "#9467bd",
                               "#8c564b"]


# ══════════════════════════════════════════════════════════════════════
#  Block 1 — responder rates
# ══════════════════════════════════════════════════════════════════════
def compute_responder_summary(subject_contrast_frame: pd.DataFrame,
                              dep_vars: list[str],
                              conditions_to_evaluate: dict,
                              subj_col: str = "Subject_ID",
                              dep_var_col: str = "Dependent_Variable"
                              ) -> pd.DataFrame:
    """Tidy responder-rate table across DVs, levels, conditions."""
    rows = []
    for dep_var in dep_vars:
        sub = subject_contrast_frame.loc[
            subject_contrast_frame[dep_var_col] == dep_var]
        for level_key, (cond_var, conditions) in \
                conditions_to_evaluate.items():
            lvl = sub.loc[sub["Condition_Variable"] == cond_var]
            for condition in conditions:
                cond_rows = lvl.loc[lvl["Condition"] == condition]
                n_subj = cond_rows[subj_col].nunique()
                n_resp = cond_rows.loc[cond_rows["Responder_Flag"],
                                       subj_col].nunique()
                rows.append({
                    dep_var_col: dep_var, "Level": level_key,
                    "Condition_Variable": cond_var,
                    "Condition": condition, "N_Subjects": n_subj,
                    "N_Responders": n_resp,
                    "Responder_Rate": (round(n_resp / n_subj, 3)
                                       if n_subj > 0 else np.nan)})
    return pd.DataFrame(rows)


# ══════════════════════════════════════════════════════════════════════
#  Block 2 — mutual information
# ══════════════════════════════════════════════════════════════════════
def _run_mi_single(feature_df: pd.DataFrame, target_col: str,
                   target_type: str, dep_var: str, level: str,
                   cond_var: str, attr_cols: list[str],
                   condition: str | None = None) -> list[dict]:
    if not attr_cols:       # no varying numeric personal attributes
        return []           # (guard: sklearn rejects (n, 0) matrices)
    valid = feature_df.dropna(subset=[target_col])
    if len(valid) < 4 or valid[target_col].nunique() < 2:
        return []
    target_arr = (valid[target_col].astype(int).values
                  if target_type == "discrete"
                  else valid[target_col].astype(float).values)
    scores = compute_feature_mi_importance(
        feature_array=valid[attr_cols].values, target_array=target_arr,
        feature_labels=attr_cols, target_type=target_type,
        include_barplot=False)
    return [{"Dependent_Variable": dep_var, "Level": level,
             "Condition_Variable": cond_var, "Condition": condition,
             "Target": target_col, "Feature": feat, "MI_Score": score}
            for feat, score in scores.items()]


def compute_mi_results(dep_vars: list[str],
                       influence_frame: pd.DataFrame,
                       contrast_frame: pd.DataFrame,
                       coefficient_frame: pd.DataFrame,
                       personal_df: pd.DataFrame, attr_cols: list[str],
                       conditions_to_evaluate: dict,
                       plot_mi_categories: list | None = None,
                       alpha_omnibus: float = 0.05,
                       analyse_dfbetas: bool = True,
                       output_dir: Path | None = None,
                       subj_col: str = "Subject_ID",
                       dep_var_col: str = "Dependent_Variable",
                       primary_n_segments: int | None = None
                       ) -> pd.DataFrame:
    """MI of personal attributes vs Cook's D / DFBETA / contrasts."""
    all_rows: list[dict] = []
    if (primary_n_segments is not None
            and "N_Segments" in influence_frame.columns):
        influence_frame = influence_frame.loc[
            influence_frame["N_Segments"] == primary_n_segments].copy()

    for dep_var in dep_vars:
        influence_sub = influence_frame.loc[
            influence_frame[dep_var_col] == dep_var].copy()
        contrast_sub = contrast_frame.loc[
            contrast_frame[dep_var_col] == dep_var].copy()
        if influence_sub.empty:
            warnings.warn(f"[skip] No influence data for '{dep_var}'.")
            continue

        cooks = (influence_sub.groupby(subj_col, as_index=False)
                 ["CooksD"].mean()
                 .merge(personal_df, on=subj_col, how="left")
                 .dropna(subset=attr_cols + ["CooksD"]))
        if len(cooks) >= 4:
            all_rows.extend(_run_mi_single(
                cooks, "CooksD", "continuous", dep_var, "influence", "—",
                attr_cols))

        if analyse_dfbetas:
            sig_params = coefficient_frame.loc[
                (coefficient_frame[dep_var_col] == dep_var)
                & (coefficient_frame["Model_Type"] == "LME")
                & (coefficient_frame["p_value_adjusted"]
                   < alpha_omnibus), "Parameter"].unique()
            for param in sig_params:
                rows = (influence_sub.loc[
                        influence_sub["Parameter"] == param]
                        .merge(personal_df, on=subj_col, how="left")
                        .dropna(subset=attr_cols + ["DFBETA"]))
                if len(rows) >= 4:
                    all_rows.extend(_run_mi_single(
                        rows, "DFBETA", "continuous", dep_var,
                        "influence", "—", attr_cols, condition=param))

        for level_key, (cond_var, conditions) in \
                conditions_to_evaluate.items():
            lvl = contrast_sub.loc[
                contrast_sub["Condition_Variable"] == cond_var]
            for condition in conditions:
                cond_rows = (lvl.loc[lvl["Condition"] == condition]
                             .merge(personal_df, on=subj_col, how="left")
                             .dropna(subset=attr_cols))
                if len(cond_rows) < 4:
                    continue
                all_rows.extend(_run_mi_single(
                    cond_rows, "Responder_Flag", "discrete", dep_var,
                    level_key, cond_var, attr_cols,
                    condition=condition))
                all_rows.extend(_run_mi_single(
                    cond_rows, "Normalised_Contrast", "continuous",
                    dep_var, level_key, cond_var, attr_cols,
                    condition=condition))
    return pd.DataFrame(all_rows)


# ══════════════════════════════════════════════════════════════════════
#  Block 3 — MI summary with tercile bands
# ══════════════════════════════════════════════════════════════════════
def _assign_tercile_band(grp: pd.DataFrame) -> pd.Series:
    scores = grp["MI_Score"]
    t33, t67 = scores.quantile([1 / 3, 2 / 3])
    if t33 == t67:
        return pd.Series(["Medium"] * len(scores), index=scores.index)
    return scores.apply(lambda s: "High" if s >= t67
                        else ("Medium" if s >= t33 else "Low"))


def build_mi_summary(mi_df: pd.DataFrame,
                     min_mi_score: float = 0.05) -> pd.DataFrame:
    """(Condition × Target) × Feature MI matrix with candidates column."""
    if mi_df.empty or "MI_Score" not in mi_df.columns:
        # every MI probe was skipped (e.g. fewer than 4 subjects)
        warnings.warn("[MI Summary] No MI scores were computed.")
        return pd.DataFrame()
    mi_df = mi_df.loc[mi_df["MI_Score"] >= min_mi_score].copy()
    if mi_df.empty:
        warnings.warn(f"[MI Summary] No scores >= {min_mi_score}.")
        return pd.DataFrame()
    agg = (mi_df.groupby(["Condition", "Target", "Feature"],
                         as_index=False)["MI_Score"].max())
    pivoted = agg.pivot_table(index=["Condition", "Target"],
                              columns="Feature", values="MI_Score",
                              aggfunc="max").round(3)
    pivoted.columns.name = None
    pivoted = pivoted.reset_index().sort_values(
        ["Condition", "Target"]).reset_index(drop=True)
    feature_cols = [c for c in pivoted.columns
                    if c not in ("Condition", "Target")]
    pivoted["Moderating_Candidates"] = pivoted[feature_cols].apply(
        lambda row: ", ".join(f"{f} ({v:.2f})" for f, v in row.items()
                              if pd.notna(v)), axis=1)
    return pivoted


# ══════════════════════════════════════════════════════════════════════
#  Block 4 — clustering
# ══════════════════════════════════════════════════════════════════════
def _scaled_pivot(long_df: pd.DataFrame, index_col: str, col_col: str,
                  val_col: str) -> pd.DataFrame:
    from sklearn.preprocessing import StandardScaler

    piv = long_df.pivot_table(index=index_col, columns=col_col,
                              values=val_col, aggfunc="mean"
                              ).dropna(axis=1, how="any")
    return pd.DataFrame(StandardScaler().fit_transform(piv.values),
                        index=piv.index, columns=piv.columns)


def _sort_pivot_columns(df: pd.DataFrame) -> pd.DataFrame:
    return df.reindex(sorted(
        df.columns,
        key=lambda c: (_METRIC_ORDER.get(c.split("│")[0], 99),
                       c.split("│")[-1], c.split("│")[1]
                       if c.count("│") >= 2 else c)), axis=1)


def build_combined_pivot(influence_frame: pd.DataFrame,
                         contrast_frame: pd.DataFrame,
                         dep_vars: list[str], sig_pairs: pd.DataFrame,
                         conditions_to_evaluate: dict,
                         clustering_measures: list[str],
                         subj_col: str = "Subject_ID",
                         dep_var_col: str = "Dependent_Variable"
                         ) -> pd.DataFrame:
    """Standardised subject × feature matrix for clustering."""
    blocks = []
    if "dfbeta" in clustering_measures:
        d = influence_frame.merge(sig_pairs,
                                  on=[dep_var_col, "Parameter"],
                                  how="inner").copy()
        if not d.empty:
            d["col_key"] = ("DFBETA│"
                            + d[dep_var_col].str.replace("CMC_", "",
                                                         regex=False)
                            + "│" + d["Parameter"])
            blocks.append(_scaled_pivot(d, subj_col, "col_key", "DFBETA"))
    if "cooks_d" in clustering_measures:
        c = influence_frame.loc[
            influence_frame[dep_var_col].isin(dep_vars)].copy()
        c["col_key"] = ("CooksD│"
                        + c[dep_var_col].str.replace("CMC_", "",
                                                     regex=False))
        blocks.append(_scaled_pivot(c, subj_col, "col_key", "CooksD"))
    if "contrast" in clustering_measures:
        ct = pd.concat([
            contrast_frame.loc[
                contrast_frame[dep_var_col].isin(dep_vars)
                & (contrast_frame["Condition_Variable"] == cond_var)
                & (contrast_frame["Condition"].isin(conditions))]
            for _, (cond_var, conditions)
            in conditions_to_evaluate.items()], ignore_index=True)
        ct["col_key"] = ("Contrast│"
                         + ct[dep_var_col].str.replace("CMC_", "",
                                                       regex=False)
                         + "│" + ct["Condition"].astype(str))
        blocks.append(_scaled_pivot(ct, subj_col, "col_key",
                                    "Normalised_Contrast"))
    if not blocks:
        return pd.DataFrame()
    combined = blocks[0].copy()
    for blk in blocks[1:]:
        combined = combined.join(blk, how="inner")
    return _sort_pivot_columns(combined)


def select_best_k(X: np.ndarray, k_range: range,
                  min_cluster_size: int) -> tuple[int, dict]:
    """Best k by silhouette with a minimum-cluster-size constraint."""
    from sklearn.cluster import AgglomerativeClustering
    from sklearn.metrics import silhouette_score

    valid_scores: dict[int, float] = {}
    for k in k_range:
        labels = AgglomerativeClustering(
            n_clusters=k, linkage="ward").fit_predict(X)
        if np.all(np.bincount(labels) >= min_cluster_size):
            valid_scores[k] = silhouette_score(X, labels)
    if not valid_scores:
        warnings.warn(f"[Clustering] No valid k in {list(k_range)} with "
                      f"min_size={min_cluster_size}. Falling back to "
                      f"k=2.")
        return 2, valid_scores
    best_k = max(valid_scores, key=valid_scores.get)
    return best_k, valid_scores


def plot_clustering(combined_pivot: pd.DataFrame,
                    cluster_labels: np.ndarray,
                    linkage_matrix: np.ndarray, best_k: int,
                    clustering_measures: list[str], dep_vars: list[str],
                    output_dir: Path,
                    rename_dict: dict | None = None) -> None:
    """Ward dendrogram + standardised feature heatmap."""
    from scipy.cluster.hierarchy import dendrogram

    from mba_tpu_torch.pipeline.visualizations import _pyplot
    plt = _pyplot()
    fig, (ax_dendro, ax_heat) = plt.subplots(
        1, 2, figsize=(14, max(4, combined_pivot.shape[0] * 0.4)),
        gridspec_kw={"width_ratios": [1, 2.5]})
    dd = dendrogram(linkage_matrix, ax=ax_dendro, orientation="left",
                    labels=[str(i) for i in combined_pivot.index],
                    color_threshold=None)
    ax_dendro.set_title(f"Ward dendrogram (k={best_k})")
    order = [int(lbl) for lbl in dd["ivl"]][::-1]
    order_pos = [list(combined_pivot.index).index(s) for s in order]
    data = combined_pivot.values[order_pos]
    im = ax_heat.imshow(data, aspect="auto", cmap="RdBu_r",
                        vmin=-2.5, vmax=2.5)
    ax_heat.set_yticks(range(len(order)))
    ax_heat.set_yticklabels(
        [f"S{s} (c{cluster_labels[p]})"
         for s, p in zip(order, order_pos)])
    cols = combined_pivot.columns
    if rename_dict:
        cols = [rename_dict.get(c, c) for c in cols]
    ax_heat.set_xticks(range(len(cols)))
    ax_heat.set_xticklabels(cols, rotation=90, fontsize=6)
    fig.colorbar(im, ax=ax_heat, label="z-score")
    fig.suptitle(f"Subject clustering "
                 f"({', '.join(clustering_measures)})")
    fig.tight_layout()
    fig.savefig(Path(output_dir) / filemgmt.file_title(
        "Heterogeneity Combined Clustering", ".png"), dpi=150)
    plt.close(fig)


def run_clustering(combined_pivot: pd.DataFrame,
                   personal_df: pd.DataFrame,
                   clustering_measures: list[str], dep_vars: list[str],
                   min_cluster_size: int, output_dir: Path,
                   subj_col: str = "Subject_ID",
                   rename_dict: dict | None = None):
    """Ward clustering + artifact CSVs (reference :520-605)."""
    from scipy.cluster.hierarchy import linkage
    from sklearn.cluster import AgglomerativeClustering

    X = combined_pivot.values
    Z = linkage(X, method="ward", metric="euclidean")
    k_range = range(2, min(6, combined_pivot.shape[0]))
    best_k, sil_scores = select_best_k(X, k_range, min_cluster_size)
    cluster_labels = AgglomerativeClustering(
        n_clusters=best_k, linkage="ward").fit_predict(X)
    plot_clustering(combined_pivot, cluster_labels, Z, best_k,
                    clustering_measures, dep_vars, output_dir,
                    rename_dict=rename_dict)
    cluster_df = (pd.DataFrame({subj_col: combined_pivot.index,
                                "Cluster": cluster_labels})
                  .sort_values("Cluster")
                  .merge(personal_df, on=subj_col, how="left"))
    cluster_df.to_csv(Path(output_dir) / filemgmt.file_title(
        "Heterogeneity Subject Clusters", ".csv"), index=False)
    pd.DataFrame([{"k": k, "Silhouette": v}
                  for k, v in sil_scores.items()]).to_csv(
        Path(output_dir) / filemgmt.file_title(
            "Heterogeneity Silhouette Scores", ".csv"), index=False)
    return cluster_df, sil_scores


# ══════════════════════════════════════════════════════════════════════
#  Block 5 — moderator scatters
# ══════════════════════════════════════════════════════════════════════
def plot_moderator_scatters(cluster_df: pd.DataFrame,
                            contrast_frame: pd.DataFrame,
                            personal_df: pd.DataFrame,
                            mi_summary: pd.DataFrame,
                            dep_vars: list[str],
                            conditions_to_evaluate: dict, top_n: int,
                            output_dir: Path,
                            subj_col: str = "Subject_ID",
                            dep_var_col: str = "Dependent_Variable"
                            ) -> None:
    """Top-MI moderators vs mean contrast, coloured by cluster."""
    from mba_tpu_torch.pipeline.visualizations import plot_scatter

    feature_cols = [c for c in mi_summary.columns
                    if c not in ("Condition", "Target",
                                 "Moderating_Candidates")]
    if not feature_cols:
        return
    top = (mi_summary[feature_cols].mean(skipna=True).dropna()
           .sort_values(ascending=False).head(top_n).index.tolist())
    # y-axis contrast level: the reference scatters against its lvl_1
    # contrast; fall back to the first configured level when the study
    # evaluates a single level (e.g. integration tests)
    lvl_key = ("lvl_1" if "lvl_1" in conditions_to_evaluate
               else next(iter(conditions_to_evaluate)))
    lvl1_cond_var, lvl1_conditions = conditions_to_evaluate[lvl_key]
    mean_contrast = (contrast_frame.loc[
        contrast_frame[dep_var_col].isin(dep_vars)
        & (contrast_frame["Condition_Variable"] == lvl1_cond_var)
        & (contrast_frame["Condition"].isin(lvl1_conditions))]
        .groupby(subj_col, as_index=False)["Normalised_Contrast"].mean())
    scatter_df = (cluster_df[[subj_col, "Cluster"]]
                  .merge(mean_contrast, on=subj_col, how="left")
                  .merge(personal_df[[subj_col] + list(top)],
                         on=subj_col, how="left"))
    for moderator in top:
        valid = scatter_df.dropna(subset=[moderator,
                                          "Normalised_Contrast"])
        if len(valid) < 4:
            continue
        plot_scatter(
            x=valid[moderator].astype(float).values,
            y=valid["Normalised_Contrast"].astype(float).values,
            x_label=moderator,
            y_label=f"Mean Normalised Contrast ({lvl_key})",
            category_list=valid["Cluster"].astype(str).tolist(),
            category_label="Cluster", save_dir=output_dir)


# ══════════════════════════════════════════════════════════════════════
#  entry point
# ══════════════════════════════════════════════════════════════════════
def run_heterogeneity_modelling(
        dep_vars: list[str], conditions_to_evaluate: dict,
        clustering_measures: list[str],
        plot_mi_categories: list, top_n_moderators: int,
        min_cluster_size: int, output_dir: Path,
        omnibus_results_dir: Path, experiment_results_dir: Path,
        analyse_mi_for_dfbetas: bool = True,
        alpha_omnibus: float = 0.05,
        primary_n_segments: int | None = None,
        subj_col: str = "Subject_ID",
        dep_var_col: str = "Dependent_Variable",
        exclude_subjects: list[int] | None = None,
        rename_dict: dict | None = None) -> None:
    """Run the full five-block heterogeneity pipeline end-to-end."""
    from mba_tpu_torch.pipeline import data_integration

    output_dir = Path(output_dir)
    filemgmt.assert_dir(output_dir)
    exclude_subjects = exclude_subjects or []
    subject_dirs = sorted(Path(experiment_results_dir).glob("subject_*"))
    subject_ids = [int(d.name.split("_")[1]) for d in subject_dirs]
    subject_dirs = [d for d, i in zip(subject_dirs, subject_ids)
                    if i not in exclude_subjects]
    subject_ids = [i for i in subject_ids if i not in exclude_subjects]

    personal_df = pd.DataFrame([
        data_integration.fetch_personal_data(d) for d in subject_dirs])
    personal_df.insert(0, subj_col, subject_ids)
    personal_df["Is_Right-handed"] = (
        personal_df["Dominant hand"] == "Right").astype(int)
    personal_df["Is_Male"] = (personal_df["Gender"] == "Male").astype(int)
    attr_cols = [c for c in personal_df.columns
                 if c != subj_col
                 and personal_df[c].nunique(dropna=True) > 1
                 and pd.api.types.is_numeric_dtype(personal_df[c])]

    influence_frame = pd.read_csv(filemgmt.most_recent_file(
        omnibus_results_dir, ".csv", ["Influence Analysis Combined"]))
    coefficient_frame = pd.read_csv(filemgmt.most_recent_file(
        omnibus_results_dir, ".csv", ["All Time Resolutions Results"]))
    contrast_frame = pd.read_csv(filemgmt.most_recent_file(
        omnibus_results_dir, ".csv",
        ["Subject Effect Summary Combined"])).rename(
        columns={"Subject ID": subj_col})

    responder_df = compute_responder_summary(
        contrast_frame, dep_vars, conditions_to_evaluate, subj_col,
        dep_var_col)
    responder_df.to_csv(output_dir / filemgmt.file_title(
        "Heterogeneity Responder Summary", ".csv"), index=False)

    mi_df = compute_mi_results(
        dep_vars, influence_frame, contrast_frame, coefficient_frame,
        personal_df, attr_cols, conditions_to_evaluate,
        plot_mi_categories, alpha_omnibus=alpha_omnibus,
        analyse_dfbetas=analyse_mi_for_dfbetas, output_dir=output_dir,
        subj_col=subj_col, dep_var_col=dep_var_col,
        primary_n_segments=primary_n_segments)
    mi_df.to_csv(output_dir / filemgmt.file_title(
        "Heterogeneity MI Results Raw", ".csv"), index=False)

    mi_summary = build_mi_summary(mi_df)
    mi_summary.to_csv(output_dir / filemgmt.file_title(
        "Heterogeneity MI Summary", ".csv"), index=False)

    sig_pairs = coefficient_frame.loc[
        coefficient_frame[dep_var_col].isin(dep_vars)
        & (coefficient_frame["Model_Type"] == "LME")
        & (coefficient_frame["p_value_adjusted"] < alpha_omnibus),
        [dep_var_col, "Parameter"]].drop_duplicates()

    combined_pivot = build_combined_pivot(
        influence_frame, contrast_frame, dep_vars, sig_pairs,
        conditions_to_evaluate, clustering_measures, subj_col,
        dep_var_col)
    if combined_pivot.shape[1] < 2 or combined_pivot.shape[0] < 4:
        warnings.warn("[Clustering] Insufficient data — skipped.")
        return

    cluster_df, _ = run_clustering(
        combined_pivot, personal_df, clustering_measures, dep_vars,
        min_cluster_size, output_dir, subj_col,
        rename_dict=rename_dict)

    if not mi_summary.empty:
        plot_moderator_scatters(
            cluster_df, contrast_frame, personal_df, mi_summary,
            dep_vars, conditions_to_evaluate, top_n_moderators,
            output_dir, subj_col, dep_var_col)
