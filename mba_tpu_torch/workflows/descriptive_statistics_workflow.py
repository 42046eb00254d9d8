"""Cohort descriptives: demographics, traits, DV distributions.

Parity target: reference ``src/descriptive_statistics_workflow.py``
(735 LoC): age/gender/handedness summaries, trait/liking/CMC/accuracy
box-mosaic ``plot_combined_descriptive_mosaic`` (:398-554), grouped
summaries + Pearson correlations (:109-190).

A host copy of ``mba_tpu/workflows/descriptive_statistics_workflow.py``
(matplotlib is imported only when the mosaic draws).
"""
from __future__ import annotations

from pathlib import Path

import pandas as pd
from scipy import stats

from mba_tpu_torch.pipeline import data_integration as di
from mba_tpu_torch.pipeline.visualizations import \
    plot_combined_descriptive_mosaic
from mba_tpu_torch.utils import file_management as filemgmt


def cohort_demographics(experiment_data_dir: Path,
                        subject_ids) -> pd.DataFrame:
    rows = []
    for subject in subject_ids:
        try:
            data = di.fetch_personal_data(
                Path(experiment_data_dir) / f"subject_{subject:02}")
        except (ValueError, FileNotFoundError):
            continue
        data["Subject ID"] = subject
        rows.append(data)
    return pd.DataFrame(rows)


def grouped_dv_summary(stats_frame: pd.DataFrame, dep_vars: list[str],
                       group_col: str = "Category or Silence"
                       ) -> pd.DataFrame:
    """Per-condition mean/std/n for each DV (reference :109-190)."""
    rows = []
    for dv in dep_vars:
        if dv not in stats_frame.columns:
            continue
        vals = pd.to_numeric(stats_frame[dv], errors="coerce")
        for group, sel in stats_frame.groupby(group_col).groups.items():
            sub = vals.loc[sel].dropna()
            rows.append({"DV": dv, group_col: group, "N": len(sub),
                         "Mean": sub.mean(), "Std": sub.std(),
                         "Median": sub.median()})
    return pd.DataFrame(rows)


def dv_correlations(stats_frame: pd.DataFrame,
                    dep_vars: list[str]) -> pd.DataFrame:
    """Pairwise Pearson correlations between DVs."""
    rows = []
    for i, a in enumerate(dep_vars):
        for b in dep_vars[i + 1:]:
            if a not in stats_frame.columns \
                    or b not in stats_frame.columns:
                continue
            sub = stats_frame[[a, b]].apply(
                pd.to_numeric, errors="coerce").dropna()
            if len(sub) < 3:
                continue
            r, p = stats.pearsonr(sub[a], sub[b])
            rows.append({"A": a, "B": b, "r": r, "p": p, "N": len(sub)})
    return pd.DataFrame(rows)


def run_descriptives(experiment_data_dir: Path, feature_data_dir: Path,
                     output_dir: Path, subject_ids=range(12),
                     dep_vars=None) -> dict:
    output_dir = Path(output_dir)
    filemgmt.assert_dir(output_dir)
    dep_vars = dep_vars or ["CMC_Flexor_max_beta",
                            "CMC_Extensor_max_beta", "RMS_Accuracy",
                            "Median_Heart_Rate", "GSR"]

    demo = cohort_demographics(experiment_data_dir, subject_ids)
    if not demo.empty:
        demo.to_csv(output_dir / filemgmt.file_title(
            "Cohort Demographics", ".csv"), index=False)
        print(f"Cohort: n={len(demo)}")
        if "Gender" in demo:
            print(demo["Gender"].value_counts().to_dict())

    stats_frame = pd.read_csv(filemgmt.most_recent_file(
        feature_data_dir, ".csv", ["Combined Statistics 1seg"]))
    summary = grouped_dv_summary(stats_frame, dep_vars)
    summary.to_csv(output_dir / filemgmt.file_title(
        "Descriptive DV Summary", ".csv"), index=False)
    corr = dv_correlations(stats_frame, dep_vars)
    corr.to_csv(output_dir / filemgmt.file_title(
        "Descriptive DV Correlations", ".csv"), index=False)

    mosaic_frames = {dv: stats_frame[dv] for dv in dep_vars
                     if dv in stats_frame.columns}
    if not demo.empty and "Musical skill" in demo:
        mosaic_frames["Musical skill"] = demo["Musical skill"]
    plot_combined_descriptive_mosaic(mosaic_frames,
                                     save_dir=output_dir)
    return {"demographics": demo, "summary": summary,
            "correlations": corr}


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    paths = StudyPaths().ensure()
    run_descriptives(paths.experiment_data, paths.feature_data,
                     paths.output / "descriptive_statistics")
