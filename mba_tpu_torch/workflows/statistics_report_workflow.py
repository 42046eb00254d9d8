"""Final stage: Markdown reports for RQ-A and RQ-B.

Parity target: reference ``src/statistics_report_workflow.py`` (143 LoC):
loads the six newest result CSVs per research question and calls
``generate_statistical_report`` (:53-143).

A host copy of ``mba_tpu/workflows/statistics_report_workflow.py``.
"""
from __future__ import annotations

from pathlib import Path

import pandas as pd

from mba_tpu_torch.pipeline.statistical_reporting import \
    generate_statistical_report
from mba_tpu_torch.utils import file_management as filemgmt


def _load_or_empty(directory: Path, keywords: list[str]) -> pd.DataFrame:
    try:
        return pd.read_csv(filemgmt.most_recent_file(directory, ".csv",
                                                     keywords))
    except (ValueError, FileNotFoundError):
        print(f"  [report] no '{' '.join(keywords)}' in {directory} — "
              f"using empty frame")
        return pd.DataFrame()


def build_report(omnibus_dir: Path, post_hoc_dir: Path,
                 output_dir: Path, suffix: str,
                 level_definitions=None,
                 **report_kwargs) -> Path:
    frames = dict(
        omnibus_results_frame=_load_or_empty(
            omnibus_dir, ["All Time Resolutions Results"]),
        omnibus_diagnostics_frame=_load_or_empty(
            omnibus_dir, ["All Time Resolutions Diagnostics"]),
        power_analysis_results_frame=_load_or_empty(
            omnibus_dir, ["Power Analysis MDE Summary"]),
        influence_measures_frame=_load_or_empty(
            omnibus_dir, ["Influence Analysis Combined"]),
        subject_heterogeneity_frame=_load_or_empty(
            omnibus_dir, ["Subject Effect Summary Combined"]),
        cbpa_results_frame=_load_or_empty(
            post_hoc_dir, ["CBPA Combined Cluster Summary"]),
        mi_summary_frame=_load_or_empty(
            post_hoc_dir, ["Heterogeneity MI Summary"]),
        subject_clusters_frame=_load_or_empty(
            post_hoc_dir, ["Heterogeneity Subject Clusters"]),
    )
    if frames["omnibus_results_frame"].empty:
        raise FileNotFoundError(
            f"No omnibus results in {omnibus_dir} — run the omnibus "
            f"workflow first.")
    return generate_statistical_report(
        **frames, output_dir=output_dir,
        file_identifier_suffix=suffix,
        level_definitions=level_definitions, **report_kwargs)


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths
    from mba_tpu_torch.workflows.statistics_RQ_A_omnibus_testing_workflow \
        import fetch_level_definitions as rqa_levels

    paths = StudyPaths().ensure()
    build_report(paths.statistics_rq_a, paths.statistics_rq_a_post_hoc,
                 paths.reports, "RQ_A",
                 level_definitions=rqa_levels(False),
                 fdr_levels_to_correct=[2, 3])
    build_report(paths.statistics_rq_b, paths.statistics_rq_a_post_hoc,
                 paths.reports, "RQ_B")
