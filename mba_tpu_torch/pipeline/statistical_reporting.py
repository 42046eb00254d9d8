"""Markdown statistical report generator.

Parity target: reference ``src/pipeline/statistical_reporting.py``
(2355 LoC) — ``generate_statistical_report`` (:2115-2353) consumes the six
result frames (omnibus results + diagnostics, power analysis, influence,
subject heterogeneity, CBPA) plus MI summary and subject clusters, and
emits a Markdown report with: frame validation (:772-814), optional FDR
re-application (:816-869), level definitions (:1031), overview table
(:1097), predictor-quality ratings (power / relevance / generalisation /
time-consistency heuristics, :67-256), LME-based sample-size estimation
(:394-534), per-hypothesis findings / cross-resolution / trust / CBPA /
heterogeneity / diagnostics sections (:1186-1923), subject clusters and
MI summaries (:1924-2113), and pipeline-gap recommendations (:871-1029).

A host copy of ``mba_tpu/pipeline/statistical_reporting.py`` (the port
never imports ``mba_tpu``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path

import numpy as np
import pandas as pd
from scipy import stats

from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.pipeline.statistical_modelling import \
    apply_fdr_correction

_SENTINEL = {"__residual_std__", "__re_std__"}
_RATING_EMOJI = {"green": "🟢", "yellow": "🟡", "red": "🔴", "na": "—"}


@dataclass
class _ReportConfig:
    primary_n_segments: int = 1
    resolution_segments: list[int] = field(default_factory=lambda: [1, 5])
    alpha_adjusted: float = 0.05
    include_ols: bool = False
    target_power: float = 0.80
    p_col: str = "p_value_adjusted"


# ── small helpers (reference :49-770) ─────────────────────────────────
def _level_int(level_str) -> int | None:
    if isinstance(level_str, (int, float)) and not (
            isinstance(level_str, float) and np.isnan(level_str)):
        return int(level_str)
    # same pattern as the reference (statistical_reporting.py:49): the
    # level token need not lead the string, and "Foo 3" must NOT parse
    m = re.search(r"Level\s+(\d+)", str(level_str), re.IGNORECASE)
    return int(m.group(1)) if m else None


def _level_filter(df: pd.DataFrame, level_idx: int | None,
                  col: str = "Comparison_Level") -> pd.DataFrame:
    if level_idx is None or col not in df.columns:
        return df
    return df[df[col].apply(_level_int) == level_idx]


def _active_models(cfg: _ReportConfig) -> list[str]:
    return ["LME", "OLS"] if cfg.include_ols else ["LME"]


def _cohens_d_label(d: float) -> str:
    d = abs(d)
    if d >= 0.8:
        return "large"
    if d >= 0.5:
        return "medium"
    if d >= 0.2:
        return "small"
    return "negligible"


def _fmt_p(p) -> str:
    if p is None or (isinstance(p, float) and np.isnan(p)):
        return "—"
    return "< 0.001" if p < 0.001 else f"{p:.4f}"


def _fmt_float(x, decimals: int = 4) -> str:
    if x is None or (isinstance(x, float) and np.isnan(x)):
        return "—"
    return f"{x:.{decimals}f}"


def _stars(p) -> str:
    if p is None or (isinstance(p, float) and np.isnan(p)):
        return ""
    return ("***" if p < 0.001 else "**" if p < 0.01
            else "*" if p < 0.05 else "")


def _clean_param(param: str) -> str:
    """'C(Q('Category or Silence'))[T.Happy]' → 'Category or Silence: Happy'."""
    import re
    s = str(param)
    match = re.match(r"C\(Q?\(?'?([^')]+)'?\)?\)\[T\.(.+)\]", s)
    if match:
        return f"{match.group(1)}: {match.group(2)}"
    return s.replace("Q('", "").replace("')", "")


def _is_real_param(p: str) -> bool:
    return p not in _SENTINEL and not str(p).startswith("Intercept")


def validate_frames(frames: dict[str, pd.DataFrame]) -> list[str]:
    """Column checks per frame (reference :772-814)."""
    required = {
        "omnibus_results": {"Hypothesis", "Dependent_Variable",
                            "Model_Type", "Comparison_Level", "Parameter",
                            "Coefficient", "p_value_adjusted"},
        "omnibus_diagnostics": {"Hypothesis", "Dependent_Variable",
                                "Model_Type"},
        "power_analysis": {"Dependent_Variable", "Parameter",
                           "Power_at_Observed_Effect"},
        "influence_measures": {"Dependent_Variable", "Parameter",
                               "Subject_ID", "DFBETA", "CooksD"},
        "subject_heterogeneity": {"Hypothesis", "Dependent_Variable"},
        "cbpa_results": {"hypothesis", "p_value", "significant"},
    }
    warnings_list = []
    for name, cols in required.items():
        frame = frames.get(name)
        if frame is None or frame.empty:
            warnings_list.append(f"`{name}` frame is empty.")
            continue
        missing = cols - set(frame.columns)
        if missing:
            warnings_list.append(
                f"`{name}` missing columns: {sorted(missing)}")
    return warnings_list


# ── predictor-quality ratings (reference :67-256) ─────────────────────
def _rate_power(raw_params: set, dvs: set, power: pd.DataFrame,
                cfg: _ReportConfig,
                comparison_level: int | None = None) -> str:
    if power is None or power.empty:
        return "red"
    rows = _level_filter(power, comparison_level)
    rows = rows[rows["Parameter"].isin(raw_params)
                & rows["Dependent_Variable"].isin(dvs)]
    if rows.empty:
        return "red"
    n_well = int((rows["Power_at_Observed_Effect"]
                  >= cfg.target_power).sum())
    if n_well == len(rows):
        return "green"
    return "yellow" if n_well > 0 else "red"


def _rate_relevance(raw_params: set, dvs: set, res: pd.DataFrame,
                    cfg: _ReportConfig,
                    comparison_level: int | None = None) -> str:
    rows = _level_filter(res, comparison_level)
    rows = rows[(rows["N. Segments"] == cfg.primary_n_segments)
                & (rows["Model_Type"] == "LME")
                & (rows["p_value_adjusted"] < cfg.alpha_adjusted)
                & rows["Parameter"].isin(raw_params)
                & rows["Dependent_Variable"].isin(dvs)]
    if rows.empty:
        return "red"
    max_d = pd.to_numeric(rows["Cohen_d"], errors="coerce").abs().max()
    if max_d >= 0.5:
        return "green"
    return "yellow" if max_d >= 0.2 else "red"


def _rate_generalization(raw_params: set, dvs: set,
                         influence: pd.DataFrame, cfg: _ReportConfig,
                         comparison_level: int | None = None) -> str:
    if influence is None or influence.empty:
        return "na"
    rows = _level_filter(influence, comparison_level)
    rows = rows[(rows.get("N_Segments", cfg.primary_n_segments)
                 == cfg.primary_n_segments)
                & rows["Parameter"].isin(raw_params)
                & rows["Dependent_Variable"].isin(dvs)]
    if rows.empty:
        return "na"
    frac = rows["DFBETA_Flagged"].sum() / len(rows)
    if frac <= 0.025:
        return "green"
    return "yellow" if frac <= 0.10 else "red"


def _rate_time_consistency(raw_params: set, dvs: set, res: pd.DataFrame,
                           cfg: _ReportConfig,
                           comparison_level: int | None = None) -> str:
    filtered = _level_filter(res, comparison_level)
    primary = filtered[
        (filtered["N. Segments"] == cfg.primary_n_segments)
        & (filtered["Model_Type"] == "LME")
        & (filtered[cfg.p_col] < cfg.alpha_adjusted)
        & filtered["Parameter"].isin(raw_params)
        & filtered["Dependent_Variable"].isin(dvs)][
        ["Parameter", "Comparison_Level",
         "Dependent_Variable"]].drop_duplicates()
    if primary.empty:
        return "red"
    verdicts = []
    for _, pr in primary.iterrows():
        lvl = _level_int(pr["Comparison_Level"])
        sig_at = []
        avail = 0
        for n_seg in cfg.resolution_segments:
            match = res[(res["N. Segments"] == n_seg)
                        & (res["Model_Type"] == "LME")
                        & (res["Parameter"] == pr["Parameter"])
                        & (res["Comparison_Level"].apply(_level_int)
                           == lvl)
                        & (res["Dependent_Variable"]
                           == pr["Dependent_Variable"])]
            if not match.empty:
                avail += 1
                if match.iloc[0]["p_value_adjusted"] \
                        < cfg.alpha_adjusted:
                    sig_at.append(n_seg)
        if avail and len(sig_at) == avail:
            verdicts.append("green")
        elif len(sig_at) > 1:
            verdicts.append("yellow")
        else:
            verdicts.append("red")
    if all(v == "green" for v in verdicts):
        return "green"
    if all(v == "red" for v in verdicts):
        return "red"
    return "yellow"


# ── sample-size estimation (reference :394-660) ───────────────────────
def _required_n_subjects(d: float, icc: float, k: float,
                         alpha: float = 0.05,
                         target_power: float = 0.80) -> int | None:
    """Minimum subjects for a within-subject LME fixed-effect test.

    Reference ``statistical_reporting.py:394-443``: treats the test as a
    one-sample t-test on subject-level effects with *k* repeated
    observations per subject.  Effective n under the repeated-measures
    design effect:

        deff  = 1 + (k − 1) · ICC
        n_eff = n_subjects · k / deff
        λ     = d · √n_eff

    Starts from the one-sample z-approximation, then refines upward with
    the exact noncentral-t power until power ≥ *target_power* with
    df = n_subjects − 1.  Returns None for invalid inputs (d ≈ 0, ICC or
    k missing).
    """
    if d is None or not np.isfinite(d) or abs(d) < 1e-8:
        return None
    if icc is None or not np.isfinite(icc):
        return None
    if k is None or k < 1:
        return None
    d = abs(float(d))
    deff = 1.0 + (float(k) - 1.0) * float(icc)
    z = stats.norm.ppf(1 - alpha / 2) + stats.norm.ppf(target_power)
    n_eff_needed = (z / d) ** 2
    n_start = max(2, int(np.ceil(n_eff_needed * deff / k)))
    for n in range(max(2, n_start - 3), n_start + 200):
        n_eff = n * k / deff
        df = max(1, n - 1)
        ncp = d * np.sqrt(n_eff)
        crit = stats.t.ppf(1 - alpha / 2, df)
        power = (1.0 - stats.nct.cdf(crit, df, ncp)
                 + stats.nct.cdf(-crit, df, ncp))
        if power >= target_power:
            return n
    return n_start + 200


def _lookup_icc(diagnostics: pd.DataFrame, dv: str,
                lvl_idx: int | None, cfg: _ReportConfig) -> float | None:
    """ICC of the LME matching (dv, level, primary resolution).

    Reference ``statistical_reporting.py:606-631``.
    """
    if diagnostics is None or diagnostics.empty:
        return None
    sub = diagnostics[(diagnostics["Dependent_Variable"] == dv)
                      & (diagnostics["Model_Type"] == "LME")]
    if "N. Segments" in sub.columns:
        sub = sub[sub["N. Segments"] == cfg.primary_n_segments]
    if lvl_idx is not None:
        sub = _level_filter(sub, lvl_idx)
    if sub.empty:
        return None
    icc = sub.iloc[0].get("ICC")
    return float(icc) if pd.notna(icc) else None


def _lookup_k(diagnostics: pd.DataFrame, dv: str, lvl_idx: int | None,
              cfg: _ReportConfig, n_subjects: int) -> float | None:
    """Observations per subject = N_Observations / n_subjects.

    Reference ``statistical_reporting.py:634-660``.
    """
    if diagnostics is None or diagnostics.empty or n_subjects < 1:
        return None
    sub = diagnostics[(diagnostics["Dependent_Variable"] == dv)
                      & (diagnostics["Model_Type"] == "LME")]
    if "N. Segments" in sub.columns:
        sub = sub[sub["N. Segments"] == cfg.primary_n_segments]
    if lvl_idx is not None:
        sub = _level_filter(sub, lvl_idx)
    if sub.empty:
        return None
    n_obs = sub.iloc[0].get("N_Observations")
    if not pd.notna(n_obs) or n_obs < 1:
        return None
    return float(n_obs) / n_subjects


def _estimate_n_for_cell(pred_canonical: str, dv: str,
                         group_res: pd.DataFrame, power: pd.DataFrame,
                         diagnostics: pd.DataFrame, cfg: _ReportConfig,
                         n_subjects: int) -> dict:
    """Required-n estimate for one (predictor, DV) cell.

    Reference ``statistical_reporting.py:535-603``: picks the level with
    the largest |Cohen's d| for the cleaned predictor, short-circuits to
    'well_powered' if the power frame already shows power ≥ target, else
    solves the noncentral-t sample size from (d, ICC, k).

    Returns ``{'status': 'well_powered'|'estimated'|'missing',
    'n_req', 'd', 'icc'}``.
    """
    empty = {"status": "missing", "n_req": None, "d": None, "icc": None}
    cand = group_res[
        (group_res["N. Segments"] == cfg.primary_n_segments)
        & (group_res["Model_Type"] == "LME")
        & (group_res["Dependent_Variable"] == dv)
        & (group_res["Parameter"].apply(_clean_param) == pred_canonical)]
    if cand.empty:
        return empty
    d_abs = pd.to_numeric(cand["Cohen_d"], errors="coerce").abs()
    if d_abs.isna().all():
        return empty
    best = cand.loc[d_abs.idxmax()]
    cohen_d = best.get("Cohen_d")
    lvl_idx = _level_int(best["Comparison_Level"])

    if power is not None and not power.empty:
        pwr = power[(power["Dependent_Variable"] == dv)
                    & (power["Parameter"] == best["Parameter"])]
        if "N_Segments" in pwr.columns:
            pwr = pwr[pwr["N_Segments"] == cfg.primary_n_segments]
        if lvl_idx is not None:
            pwr = _level_filter(pwr, lvl_idx)
        if not pwr.empty:
            obs = pwr.iloc[0].get("Power_at_Observed_Effect")
            if pd.notna(obs) and obs >= cfg.target_power:
                return {"status": "well_powered", "n_req": None,
                        "d": None, "icc": None}

    if cohen_d is None or not np.isfinite(cohen_d):
        return empty
    icc = _lookup_icc(diagnostics, dv, lvl_idx, cfg)
    if icc is None:
        return empty
    k = _lookup_k(diagnostics, dv, lvl_idx, cfg, n_subjects)
    if k is None:
        return empty
    n_req = _required_n_subjects(cohen_d, icc, k, cfg.alpha_adjusted,
                                 cfg.target_power)
    if n_req is None:
        return empty
    return {"status": "estimated", "n_req": n_req, "d": abs(cohen_d),
            "icc": icc}


# ── section builders ──────────────────────────────────────────────────
def _section_level_definitions(level_defs: list[dict]) -> str:
    lines = ["## Comparison Levels\n",
             "| Level | Condition vars | Explanatory vars | "
             "Interactions |", "|---|---|---|---|"]
    for i, d in enumerate(level_defs):
        lines.append(
            f"| {i} | {', '.join(d.get('condition_vars', {}))} "
            f"| {', '.join(d.get('explanatory_vars', []))} "
            f"| {'yes' if d.get('moderation_pairs') else '—'} |")
    return "\n".join(lines) + "\n"


def _section_overview_table(res: pd.DataFrame, power: pd.DataFrame,
                            cfg: _ReportConfig) -> str:
    sub = res[(res["N. Segments"] == cfg.primary_n_segments)
              & res["Model_Type"].isin(_active_models(cfg))
              & res["Parameter"].apply(_is_real_param)]
    lines = ["## Overview — significant effects at the primary "
             "resolution\n",
             "| Hypothesis | DV | Level | Parameter | β | p | d | "
             "Powered |", "|---|---|---|---|---|---|---|---|"]
    sig = sub[sub[cfg.p_col] < cfg.alpha_adjusted]
    if sig.empty:
        lines.append("| *(no significant effects)* | | | | | | | |")
    for _, r in sig.sort_values(["Hypothesis",
                                 "Dependent_Variable"]).iterrows():
        powered = "—"
        if power is not None and not power.empty:
            match = power[(power["Parameter"] == r["Parameter"])
                          & (power["Dependent_Variable"]
                             == r["Dependent_Variable"])]
            if not match.empty:
                powered = ("✅" if match.iloc[0][
                    "Power_at_Observed_Effect"] >= cfg.target_power
                    else "⚠️")
        lines.append(
            f"| {r['Hypothesis']} | `{r['Dependent_Variable']}` "
            f"| {_level_int(r['Comparison_Level'])} "
            f"| {_clean_param(r['Parameter'])} "
            f"| {_fmt_float(r['Coefficient'])} "
            f"| {_fmt_p(r[cfg.p_col])}{_stars(r[cfg.p_col])} "
            f"| {_fmt_float(r.get('Cohen_d'), 2)} | {powered} |")
    return "\n".join(lines) + "\n"


def _section_predictor_quality(hypothesis_groups: list[dict],
                               res: pd.DataFrame, power: pd.DataFrame,
                               influence: pd.DataFrame,
                               cfg: _ReportConfig) -> str:
    lines = ["## Predictor Quality Ratings\n",
             "| Group | Predictor | Power | Relevance | "
             "Generalisation | Time consistency |",
             "|---|---|---|---|---|---|"]
    for grp in hypothesis_groups:
        dvs = set(grp.get("dvs", []))
        level = grp.get("comparison_level")
        for canonical, raw_params in grp.get("predictors", {}).items():
            raw = set(raw_params)
            lines.append(
                f"| {grp.get('name', '—')} | {canonical} "
                f"| {_RATING_EMOJI[_rate_power(raw, dvs, power, cfg, level)]} "
                f"| {_RATING_EMOJI[_rate_relevance(raw, dvs, res, cfg, level)]} "
                f"| {_RATING_EMOJI[_rate_generalization(raw, dvs, influence, cfg, level)]} "
                f"| {_RATING_EMOJI[_rate_time_consistency(raw, dvs, res, cfg, level)]} |")
    return "\n".join(lines) + "\n"


def _section_sample_size_estimation(hypothesis_groups: list[dict],
                                    res: pd.DataFrame,
                                    power: pd.DataFrame,
                                    diagnostics: pd.DataFrame,
                                    cfg: _ReportConfig, n_subjects: int,
                                    predictors_to_evaluate=None) -> str:
    """Section VI-b — required n per (predictor, DV) cell.

    Reference ``statistical_reporting.py:445-532``: per hypothesis
    group, a predictor×DV grid where each cell is ✅ (already
    well-powered), **n=X** with the d/ICC it was solved from, or blank
    (insufficient data).  Groups may scope rows via ``hypotheses``
    (reference schema) or ``dvs`` (ours); when *predictors_to_evaluate*
    is None the canonical predictor set is derived from the group's own
    real parameters instead of the reference's hard-coded study list.
    """
    lines = [
        "## Sample-Size Estimation\n",
        f"> Minimum subjects (n) required to achieve "
        f"{cfg.target_power:.0%} power at the observed effect size, "
        f"corrected for repeated-measures design effect via ICC "
        f"(current n={n_subjects}).  \n"
        "> ✅ = already well-powered · blank = insufficient data for "
        "estimation.\n"]
    for grp in hypothesis_groups:
        label = grp.get("name", grp.get("label", "Unnamed Group"))
        lines.append(f"### {label}\n")
        if grp.get("hypotheses"):
            group_res = res[res["Hypothesis"].isin(grp["hypotheses"])]
        elif grp.get("dvs"):
            group_res = res[res["Dependent_Variable"].isin(grp["dvs"])]
        else:
            group_res = res
        dvs = sorted(group_res["Dependent_Variable"].unique())
        if group_res.empty or not dvs:
            lines.append("> No results for this group.\n")
            continue
        if predictors_to_evaluate is not None:
            preds = list(predictors_to_evaluate)
        else:
            real = group_res[group_res["Parameter"].apply(_is_real_param)]
            preds = sorted(real["Parameter"].apply(_clean_param).unique())
        lines.append(f"| Predictor | {' | '.join(dvs)} |")
        lines.append(f"|---{'|---' * len(dvs)}|")
        for pred in preds:
            cells = []
            for dv in dvs:
                info = _estimate_n_for_cell(pred, dv, group_res, power,
                                            diagnostics, cfg, n_subjects)
                if info["status"] == "well_powered":
                    cells.append("✅")
                elif info["status"] == "estimated":
                    cells.append(f"**n={info['n_req']}** "
                                 f"d={info['d']:.2f} "
                                 f"ICC={info['icc']:.2f}")
                else:
                    cells.append("")
            lines.append(f"| {pred} | {' | '.join(cells)} |")
        lines.append("")
    return "\n".join(lines) + "\n"


def _section_findings(hyp: str, dv: str, res_sub: pd.DataFrame,
                      cfg: _ReportConfig) -> str:
    sub = res_sub[(res_sub["N. Segments"] == cfg.primary_n_segments)
                  & res_sub["Model_Type"].isin(_active_models(cfg))
                  & res_sub["Parameter"].apply(_is_real_param)]
    lines = ["### Findings (primary resolution)\n",
             "| Level | Model | Parameter | β | SE | p | d (label) |",
             "|---|---|---|---|---|---|---|"]
    for _, r in sub.iterrows():
        d = r.get("Cohen_d")
        d_str = (f"{_fmt_float(d, 2)} ({_cohens_d_label(d)})"
                 if d is not None and np.isfinite(d) else "—")
        lines.append(
            f"| {_level_int(r['Comparison_Level'])} | {r['Model_Type']} "
            f"| {_clean_param(r['Parameter'])} "
            f"| {_fmt_float(r['Coefficient'])} | {_fmt_float(r['SE'])} "
            f"| {_fmt_p(r[cfg.p_col])}{_stars(r[cfg.p_col])} "
            f"| {d_str} |")
    return "\n".join(lines) + "\n"


def _section_cross_resolution(hyp: str, dv: str, res_sub: pd.DataFrame,
                              cfg: _ReportConfig) -> str:
    if "N. Segments" not in res_sub.columns:
        return ""
    sig_primary = res_sub[
        (res_sub["N. Segments"] == cfg.primary_n_segments)
        & (res_sub["Model_Type"] == "LME")
        & (res_sub[cfg.p_col] < cfg.alpha_adjusted)
        & res_sub["Parameter"].apply(_is_real_param)]
    if sig_primary.empty:
        return ("### Cross-resolution stability\n*(no significant "
                "primary-resolution effects to track)*\n")
    lines = ["### Cross-resolution stability\n",
             "| Parameter | " + " | ".join(
                 f"{s}-seg" for s in cfg.resolution_segments) + " |",
             "|---|" + "---|" * len(cfg.resolution_segments)]
    for _, r in sig_primary.iterrows():
        cells = []
        for n_seg in cfg.resolution_segments:
            match = res_sub[(res_sub["N. Segments"] == n_seg)
                            & (res_sub["Model_Type"] == "LME")
                            & (res_sub["Parameter"] == r["Parameter"])
                            & (res_sub["Comparison_Level"]
                               == r["Comparison_Level"])]
            if match.empty:
                cells.append("—")
            else:
                p = match.iloc[0]["p_value_adjusted"]
                cells.append(f"{'✅' if p < cfg.alpha_adjusted else '✖'}"
                             f" {_fmt_p(p)}")
        lines.append(f"| {_clean_param(r['Parameter'])} | "
                     + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


def _section_trust(hyp: str, dv: str, res_sub: pd.DataFrame,
                   power: pd.DataFrame, influence: pd.DataFrame,
                   cfg: _ReportConfig) -> str:
    lines = ["### Trust: power & subject influence\n"]
    if power is not None and not power.empty:
        p_sub = power[power["Dependent_Variable"] == dv]
        if not p_sub.empty:
            lines += ["| Parameter | Power @ observed | MDE |",
                      "|---|---|---|"]
            mde_col = next((c for c in p_sub.columns
                            if c.startswith("MDE_at_")), None)
            for _, r in p_sub.iterrows():
                lines.append(
                    f"| {_clean_param(r['Parameter'])} "
                    f"| {_fmt_float(r['Power_at_Observed_Effect'], 2)} "
                    f"| {_fmt_float(r[mde_col]) if mde_col else '—'} |")
            lines.append("")
    if influence is not None and not influence.empty:
        i_sub = influence[influence["Dependent_Variable"] == dv]
        flagged = i_sub[i_sub.get("DFBETA_Flagged", False) == True]  # noqa: E712
        cooks = i_sub[i_sub.get("CooksD_Flagged", False) == True]    # noqa: E712
        lines.append(f"- DFBETA-flagged subject×parameter cells: "
                     f"{len(flagged)} / {len(i_sub)}")
        if not cooks.empty:
            subj = sorted(cooks['Subject_ID'].unique().tolist())
            lines.append(f"- Cook's-D-flagged subjects: {subj}")
        else:
            lines.append("- No Cook's-D-flagged subjects.")
    return "\n".join(lines) + "\n"


def _dv_to_cbpa_keys(dv: str):
    """'CMC_Flexor_max_beta' → ('CMC', 'Flexor', 'beta')."""
    parts = str(dv).split("_")
    if len(parts) >= 4 and parts[0] == "CMC":
        return parts[0], parts[1], parts[3]
    return None, None, None


def _section_cbpa(hyp: str, dv: str, cbpa: pd.DataFrame) -> str:
    if cbpa is None or cbpa.empty:
        return ""
    modality, muscle, band = _dv_to_cbpa_keys(dv)
    sub = cbpa
    if modality is not None and "modality" in cbpa.columns:
        sub = cbpa[(cbpa["modality"] == modality)
                   & (cbpa["freq_band"] == band)]
    if sub.empty:
        return ""
    lines = ["### CBPA clusters\n",
             "| Run | Contrast | Cluster | p | sig | peak t | "
             "channels |", "|---|---|---|---|---|---|---|"]
    for _, r in sub.iterrows():
        lines.append(
            f"| {r.get('hypothesis', '—')} "
            f"| {r.get('condition_A', '')} − {r.get('condition_B', '')} "
            f"| #{r.get('cluster_index', '—')} "
            f"| {_fmt_p(r.get('p_value'))} "
            f"| {'✅' if r.get('significant') else '✖'} "
            f"| {_fmt_float(r.get('peak_t'), 2)} "
            f"| {r.get('n_channels', '—')} |")
    return "\n".join(lines) + "\n"


def _section_heterogeneity(hyp: str, dv: str, subj_sub: pd.DataFrame,
                           influence: pd.DataFrame,
                           cfg: _ReportConfig) -> str:
    if subj_sub is None or subj_sub.empty:
        return ""
    lines = ["### Subject heterogeneity\n"]
    if "Responder_Flag" in subj_sub.columns:
        by_cond = (subj_sub.groupby("Condition")["Responder_Flag"]
                   .mean().round(2))
        lines.append("Responder rates by condition: "
                     + ", ".join(f"{c}: {v:.0%}"
                                 for c, v in by_cond.items()))
    return "\n".join(lines) + "\n"


def _section_diagnostics(hyp: str, dv: str, diag: pd.DataFrame,
                         cfg: _ReportConfig) -> str:
    if diag is None or diag.empty:
        return ""
    lines = ["### Model diagnostics\n",
             "| Model | Level | N | Shapiro p | deff | ICC | AIC |",
             "|---|---|---|---|---|---|---|"]
    for _, r in diag.iterrows():
        lines.append(
            f"| {r['Model_Type']} "
            f"| {_level_int(r.get('Comparison_Level', ''))} "
            f"| {r.get('N_Observations', '—')} "
            f"| {_fmt_p(r.get('Shapiro_p'))} "
            f"| {_fmt_float(r.get('Design_Effect'), 2)} "
            f"| {_fmt_float(r.get('ICC'), 2)} "
            f"| {_fmt_float(r.get('AIC'), 1)} |")
    return "\n".join(lines) + "\n"


def _section_subject_clusters(cluster_df: pd.DataFrame) -> str:
    lines = ["## Subject Clusters\n",
             "| Cluster | N | Subjects |", "|---|---|---|"]
    for cluster, grp in cluster_df.groupby("Cluster"):
        subj_col = ("Subject_ID" if "Subject_ID" in grp.columns
                    else grp.columns[0])
        subjects = ", ".join(str(s) for s in grp[subj_col].tolist())
        lines.append(f"| {cluster} | {len(grp)} | {subjects} |")
    return "\n".join(lines) + "\n"


def _section_mi_summary(mi_summary: pd.DataFrame,
                        include_targets=None) -> str:
    sub = mi_summary
    if include_targets and "Target" in sub.columns:
        sub = sub[sub["Target"].isin(include_targets)]
    if sub.empty:
        return ""
    lines = ["## Moderator Candidates (Mutual Information)\n",
             "| Condition | Target | Candidates |", "|---|---|---|"]
    for _, r in sub.iterrows():
        lines.append(f"| {r.get('Condition', '—')} "
                     f"| {r.get('Target', '—')} "
                     f"| {r.get('Moderating_Candidates', '')} |")
    return "\n".join(lines) + "\n"


def _section_surrogate_null_engine(metadata_list) -> str:
    """Methods note on the cohort surrogate-null engine(s) used.

    Consumes ``result['metadata']`` dicts from
    :func:`mba_tpu_torch.ops.cohort_null.cohort_msc_null` runs.  When the
    rotation engine ran (study-scale window counts where O(n_surrogates)
    full-FFT cohort passes are unaffordable), its measured sensitivity
    cost — the documented detection limit from BENCH_NULL_POWER.json —
    is carried into the report so readers of the statistics know the
    80%-power detectable-coupling floor sits ≤11% above the exact
    engine's.
    """
    if not metadata_list:
        return ""
    if isinstance(metadata_list, dict):
        metadata_list = [metadata_list]
    lines = ["## Surrogate-Null Engine (Methods)\n",
             "| Run | Engine | Selection |", "|---|---|---|"]
    notes = []
    for i, md in enumerate(metadata_list, start=1):
        choice = md.get("engine_choice", {}) or {}
        engine = choice.get("method_run", md.get("method", "—"))
        requested = choice.get("method_requested", "—")
        est = choice.get("estimated_fft_flops")
        budget = choice.get("fft_flop_budget")
        sel = (f"requested `{requested}`"
               + (f", est. exact-FFT cost {est:.2e} flops"
                  f" vs budget {budget:.2e}"
                  if est is not None and budget is not None else ""))
        lines.append(f"| {md.get('label', f'run {i}')} | `{engine}` "
                     f"| {sel} |")
        note = md.get("sensitivity_note")
        if note and note not in notes:
            notes.append(note)
    if notes:
        lines.append("\n**Detection limit** (measured, "
                     "BENCH_NULL_POWER.json):\n")
        lines += [f"> {n}" for n in notes]
    return "\n".join(lines) + "\n"


def _print_pipeline_recommendations(res, power, influence, cbpa, alpha,
                                    primary_n_segments,
                                    resolution_segments, cfg) -> None:
    """Console gap report (reference :871-1029)."""
    recs = []
    if power is None or power.empty:
        recs.append("Power analysis missing — run run_power_analysis.")
    if influence is None or influence.empty:
        recs.append("Influence analysis missing — run "
                    "run_influence_analysis.")
    if cbpa is None or cbpa.empty:
        recs.append("CBPA results missing — run the post-hoc workflow.")
    sig = res[(res["N. Segments"] == primary_n_segments)
              & (res["Model_Type"] == "LME")
              & (res["p_value_adjusted"] < alpha)
              & res["Parameter"].apply(_is_real_param)]
    if power is not None and not power.empty and not sig.empty:
        missing = set(zip(sig["Dependent_Variable"], sig["Parameter"])) \
            - set(zip(power["Dependent_Variable"], power["Parameter"]))
        if missing:
            recs.append(f"{len(missing)} significant effect(s) lack "
                        f"power estimates.")
    if recs:
        print("[Report recommendations]")
        for r in recs:
            print(f"  - {r}")


def generate_statistical_report(
        omnibus_results_frame: pd.DataFrame,
        omnibus_diagnostics_frame: pd.DataFrame,
        power_analysis_results_frame: pd.DataFrame,
        influence_measures_frame: pd.DataFrame,
        subject_heterogeneity_frame: pd.DataFrame,
        cbpa_results_frame: pd.DataFrame,
        mi_summary_frame: pd.DataFrame,
        subject_clusters_frame: pd.DataFrame,
        output_dir: Path,
        mi_include_targets=None,
        primary_n_segments: int = 1,
        resolution_segments=(1, 5, 20),
        alpha_adjusted: float = 0.05,
        include_ols: bool = False,
        target_power: float = 0.80,
        level_definitions: list[dict] | None = None,
        hypothesis_groups: list[dict] | None = None,
        file_identifier_suffix: str | None = None,
        fdr_levels_to_correct: list[int] | None = None,
        fdr_group_by_dv: bool = True,
        n_subjects: int | None = None,
        sample_size_predictors: list[str] | None = None,
        surrogate_null_metadata=None) -> Path:
    """Generate the Markdown report (reference :2115-2353)."""
    if fdr_levels_to_correct:
        needs = "p_value_fdr" not in omnibus_results_frame.columns
        if not needs:
            eligible = omnibus_results_frame[
                omnibus_results_frame["Parameter"].apply(_is_real_param)
                & omnibus_results_frame["Comparison_Level"].apply(
                    lambda lvl: any(str(lvl).startswith(f"Level {i} ")
                                    for i in fdr_levels_to_correct))]
            needs = eligible["p_value_fdr"].isna().any()
        if needs:
            omnibus_results_frame = apply_fdr_correction(
                omnibus_results_frame,
                levels_to_correct=fdr_levels_to_correct,
                alpha=alpha_adjusted, group_by_dv=fdr_group_by_dv)
        p_col = "p_value_for_plot"
    else:
        p_col = "p_value_adjusted"

    cfg = _ReportConfig(primary_n_segments=primary_n_segments,
                        resolution_segments=list(resolution_segments),
                        alpha_adjusted=alpha_adjusted,
                        include_ols=include_ols,
                        target_power=target_power, p_col=p_col)

    _print_pipeline_recommendations(
        omnibus_results_frame, power_analysis_results_frame,
        influence_measures_frame, cbpa_results_frame,
        cfg.alpha_adjusted, cfg.primary_n_segments,
        cfg.resolution_segments, cfg)

    frames = {"omnibus_results": omnibus_results_frame,
              "omnibus_diagnostics": omnibus_diagnostics_frame,
              "power_analysis": power_analysis_results_frame,
              "influence_measures": influence_measures_frame,
              "subject_heterogeneity": subject_heterogeneity_frame,
              "cbpa_results": cbpa_results_frame}
    warnings_list = validate_frames(frames)

    lines = ["# Statistical Analysis Report",
             f"*Generated: {datetime.now().strftime('%Y-%m-%d %H:%M')}*  ",
             f"*Primary resolution: {cfg.primary_n_segments}-seg | "
             f"Models: {', '.join(_active_models(cfg))} | "
             f"α = {cfg.alpha_adjusted} | target power = "
             f"{cfg.target_power:.0%}*\n", "---\n"]
    if warnings_list:
        lines.append("## ⚠️  Frame Validation Warnings\n")
        lines += [f"- {w}" for w in warnings_list]
        lines.append("\n---\n")
    else:
        lines.append("> ✅ All six frames validated — no missing "
                     "columns.\n\n---\n")

    if level_definitions is not None:
        lines.append(_section_level_definitions(level_definitions))
    lines.append(_section_overview_table(
        omnibus_results_frame, power_analysis_results_frame, cfg))
    if hypothesis_groups is not None:
        lines.append(_section_predictor_quality(
            hypothesis_groups, omnibus_results_frame,
            power_analysis_results_frame, influence_measures_frame,
            cfg))
        if n_subjects is not None:
            lines.append(_section_sample_size_estimation(
                hypothesis_groups, omnibus_results_frame,
                power_analysis_results_frame,
                omnibus_diagnostics_frame, cfg, n_subjects,
                sample_size_predictors))

    if surrogate_null_metadata:
        lines.append(_section_surrogate_null_engine(
            surrogate_null_metadata))
    if (subject_clusters_frame is not None
            and not subject_clusters_frame.empty):
        lines.append(_section_subject_clusters(subject_clusters_frame))
    if mi_summary_frame is not None and not mi_summary_frame.empty:
        lines.append(_section_mi_summary(mi_summary_frame,
                                         mi_include_targets))

    pairs = (omnibus_results_frame[["Hypothesis", "Dependent_Variable"]]
             .drop_duplicates()
             .sort_values(["Hypothesis", "Dependent_Variable"]))
    for _, row in pairs.iterrows():
        hyp, dv = row["Hypothesis"], row["Dependent_Variable"]
        lines += ["---\n", f"## {hyp}",
                  f"**Dependent variable:** `{dv}`\n"]
        res_sub = omnibus_results_frame[
            (omnibus_results_frame["Hypothesis"] == hyp)
            & (omnibus_results_frame["Dependent_Variable"] == dv)]
        diag_sub = omnibus_diagnostics_frame[
            (omnibus_diagnostics_frame["Hypothesis"] == hyp)
            & (omnibus_diagnostics_frame["Dependent_Variable"] == dv)] \
            if not omnibus_diagnostics_frame.empty else pd.DataFrame()
        subj_sub = (subject_heterogeneity_frame[
            (subject_heterogeneity_frame["Hypothesis"] == hyp)
            & (subject_heterogeneity_frame["Dependent_Variable"] == dv)]
            if (subject_heterogeneity_frame is not None
                and not subject_heterogeneity_frame.empty)
            else pd.DataFrame())
        lines.append(_section_findings(hyp, dv, res_sub, cfg))
        lines.append(_section_cross_resolution(hyp, dv, res_sub, cfg))
        lines.append(_section_trust(hyp, dv, res_sub,
                                    power_analysis_results_frame,
                                    influence_measures_frame, cfg))
        lines.append(_section_cbpa(hyp, dv, cbpa_results_frame))
        lines.append(_section_heterogeneity(
            hyp, dv, subj_sub, influence_measures_frame, cfg))
        lines.append(_section_diagnostics(hyp, dv, diag_sub, cfg))

    filemgmt.assert_dir(output_dir)
    suffix = (f"_{file_identifier_suffix}"
              if file_identifier_suffix is not None else "")
    out_path = Path(output_dir) / filemgmt.file_title(
        f"Statistical Report{suffix}", ".md")
    out_path.write_text("\n".join(lines), encoding="utf-8")
    print(f"Report written -> {out_path}")
    return out_path
