"""RQ-A omnibus testing: 14 hypothesis DVs × 4 comparison levels × 4
time resolutions, with FDR, forest mosaics, LOSO influence and power.

The port of ``mba_tpu/workflows/statistics_RQ_A_omnibus_testing_
workflow.py``: the fits run on the host, the power grid of the
``__main__`` block on the card.  Parity target: reference
``src/statistics_RQ_A_omnibus_testing_workflow.py`` (776 LoC):
``fetch_level_definitions`` (:11-89), the resolution × DV loops through
``run_model_levels`` (:371-541), FDR on levels 2–3 (:561-566), forest
mosaics (:607-645), all-time-resolution CSVs (:663-674), cross-resolution
plots (:689-712), optional LOSO influence (:723-748) and power analysis
(:253-365, :760-775).
"""
from __future__ import annotations

from pathlib import Path

import pandas as pd

from mba_tpu_torch.pipeline import statistical_modelling as statistics
from mba_tpu_torch.pipeline import visualizations
from mba_tpu_torch.utils import file_management as filemgmt

# 14 hypothesis (name, DV) tuples (reference :138-175)
RQA_HYPOTHESES: list[tuple[str, str]] = [
    ('H1: Flexor Beta Peak CMC', "CMC_Flexor_max_beta"),
    ('H1: Flexor Beta Mean CMC', "CMC_Flexor_mean_beta"),
    ('H1: Flexor Gamma Peak CMC', "CMC_Flexor_max_gamma"),
    ('H1: Flexor Gamma Mean CMC', "CMC_Flexor_mean_gamma"),
    ('H1: Extensor Beta Peak CMC', "CMC_Extensor_max_beta"),
    ('H1: Extensor Beta Mean CMC', "CMC_Extensor_mean_beta"),
    ('H1: Extensor Gamma Peak CMC', "CMC_Extensor_max_gamma"),
    ('H1: Extensor Gamma Mean CMC', "CMC_Extensor_mean_gamma"),
    ('H2: Fronto-Central Theta PSD', "PSD_eeg_FC_CP_T_theta"),
    ('H3: Frontal-Central Beta PSD', "PSD_eeg_F_C_beta"),
    ('H4: Parietal Alpha PSD', "PSD_eeg_P_PO_alpha"),
    ('H5: Global Gamma PSD', "PSD_eeg_Global_gamma"),
    ('V1: Flexor EMG PSD', "PSD_emg_1_flexor_Global_all"),
    ('V2: Extensor EMG PSD', "PSD_emg_2_extensor_Global_all"),
]


def fetch_level_definitions(multi_segments_per_trial: bool,
                            always_include_scaled_force: bool = False
                            ) -> list[dict]:
    """The four RQ-A comparison levels (reference :11-89).

    - Level 0: all data, Music vs. Silence (confirmatory)
    - Level 1: all data, Category-or-Silence (confirmatory)
    - Level 2: music trials only, subjective predictors (exploratory)
    - Level 3: music trials only, objective music features (exploratory)
    """
    force_vars = (['Median Scaled Force [0-1]',
                   'Median Unscaled Force [% MVC]']
                  if multi_segments_per_trial
                  or always_include_scaled_force
                  else ['Median Unscaled Force [% MVC]'])
    id_vars = (['Trial ID', 'Segment ID'] if multi_segments_per_trial
               else ['Trial ID'])
    return [
        {  # Level 0 — music vs. silence
            'df_filter': None,
            'condition_vars': {'Music Listening': 'categorical'},
            'reference_categories': {'Music Listening': False},
            'explanatory_vars': force_vars + id_vars,
            'moderation_pairs': [
                ('Music Listening', 'Musical skill [0-7]_centered'),
                ('Music Listening', 'Dancing habit [0-7]_centered')],
        },
        {  # Level 1 — category or silence
            'df_filter': None,
            'condition_vars': {'Category or Silence': 'categorical'},
            'reference_categories': {'Category or Silence': 'Silence'},
            'explanatory_vars': force_vars + id_vars,
            'moderation_pairs': [
                ('Category or Silence', 'Musical skill [0-7]_centered'),
                ('Category or Silence',
                 'Dancing habit [0-7]_centered')],
        },
        {  # Level 2 — subjective features (music trials only)
            'df_filter': lambda df: df.loc[df['Music Listening']],
            'condition_vars': {'Perceived Category': 'categorical',
                               'Familiarity [0-7]': 'ordinal'},
            'reference_categories': {'Perceived Category': 'Classic'},
            'explanatory_vars': (force_vars
                                 + ['Liking_centered_squared']
                                 + id_vars),
            'moderation_pairs': [
                ('Perceived Category', 'Musical skill [0-7]_centered'),
                ('Perceived Category',
                 'Dancing habit [0-7]_centered')],
        },
        {  # Level 3 — objective music features (music trials only)
            'df_filter': lambda df: df.loc[df['Music Listening']],
            'condition_vars': {'Familiarity [0-7]': 'ordinal'},
            'explanatory_vars': (force_vars
                                 + ['Liking_centered_squared',
                                    'Spectral Centroid Mean',
                                    'Spectral Flux Std.',
                                    'IOI Variance Coeff'] + id_vars),
            'moderation_pairs': [
                ('IOI Variance Coeff', 'Musical skill [0-7]_centered')],
        },
    ]


def run_omnibus(feature_data_dir: Path, statistics_output_dir: Path,
                n_within_trial_segments_list=(1, 2, 5, 10),
                hypotheses=None, levels_to_include=None,
                fdr_levels=(2, 3), make_forest_mosaics: bool = True,
                level_definitions_factory=fetch_level_definitions,
                verbose: bool = False) -> pd.DataFrame:
    """All resolutions × DVs × levels → All Time Resolutions Results."""
    hypotheses = hypotheses or RQA_HYPOTHESES
    statistics_output_dir = Path(statistics_output_dir)
    filemgmt.assert_dir(statistics_output_dir)

    all_frames = []
    all_diag = []
    for n_segments in n_within_trial_segments_list:
        frame_path = filemgmt.most_recent_file(
            feature_data_dir, ".csv",
            [f"Combined Statistics {n_segments}seg"])
        base_df = pd.read_csv(frame_path)
        level_defs = level_definitions_factory(n_segments > 1)
        results: list = []
        diagnostics: list = []
        for hypothesis_name, dv in hypotheses:
            if dv not in base_df.columns:
                print(f"  [skip] DV '{dv}' missing from frame")
                continue
            statistics.run_model_levels(
                base_df, level_defs, response_var=dv,
                hypothesis_name=hypothesis_name,
                n_windows_per_trial=n_segments,
                all_results_list=results,
                diagnostics_list=diagnostics,
                levels_to_include=levels_to_include, verbose=verbose)
        frame = pd.DataFrame(results)
        frame["N. Segments"] = n_segments
        diag = pd.DataFrame(diagnostics)
        diag["N. Segments"] = n_segments
        all_frames.append(frame)
        all_diag.append(diag)

    combined = pd.concat(all_frames, ignore_index=True)
    combined = statistics.apply_fdr_correction(
        combined, levels_to_correct=list(fdr_levels))
    diagnostics_df = pd.concat(all_diag, ignore_index=True)

    combined.to_csv(statistics_output_dir / filemgmt.file_title(
        "All Time Resolutions Results", ".csv"), index=False)
    diagnostics_df.to_csv(statistics_output_dir / filemgmt.file_title(
        "All Time Resolutions Diagnostics", ".csv"), index=False)

    if make_forest_mosaics and not combined.empty:
        visualizations.draw_forest_mosaic(
            combined[combined["N. Segments"]
                     == min(n_within_trial_segments_list)],
            title="RQ-A Forest Mosaic (primary resolution)",
            save_dir=statistics_output_dir)
        # cross-resolution view: one forest column per hypothesis, y-axis
        # = time resolutions (reference omnibus workflow :607-645 →
        # visualizations.py:2011/2230)
        if len(n_within_trial_segments_list) > 1:
            non_int = combined[~combined["Parameter"].astype(str)
                               .str.lower()
                               .str.startswith(("intercept", "const"))]
            if not non_int.empty:
                top = non_int["Parameter"].value_counts().index[0]
                lvl = non_int.loc[non_int["Parameter"] == top,
                                  "Comparison_Level"].iloc[0]
                hyps = sorted(non_int.loc[
                    non_int["Parameter"] == top, "Hypothesis"]
                    .dropna().unique())[:6]
                visualizations.plot_time_resolution_forest_mosaic(
                    combined, hyps, top, lvl,
                    output_dir=statistics_output_dir)
    return combined


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    # module-level flags (reference style)
    n_within_trial_segments_list = [1, 2, 5, 10]
    run_influence = False
    run_power = False

    paths = StudyPaths().ensure()
    combined = run_omnibus(paths.feature_data, paths.statistics_rq_a,
                           n_within_trial_segments_list)

    if run_influence:
        configs = [(dv, 1, 1) for _, dv in RQA_HYPOTHESES[:8]]
        statistics.run_influence_analysis(
            configs, combined, paths.feature_data,
            paths.statistics_rq_a, fetch_level_definitions)
    if run_power:
        power_configs = [statistics.PowerConfig(
            dependent_var=dv, comp_lvl=1, n_segments=1,
            target_parameters=[]) for _, dv in RQA_HYPOTHESES[:8]]
        statistics.run_power_analysis(
            power_configs, combined, paths.feature_data,
            paths.statistics_rq_a, fetch_level_definitions)
