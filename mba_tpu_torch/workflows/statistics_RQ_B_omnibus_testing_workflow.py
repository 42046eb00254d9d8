"""RQ-B omnibus: neural features → motor accuracy (log-RMSE).

The port of ``mba_tpu/workflows/statistics_RQ_B_omnibus_testing_
workflow.py`` (host fits).  Parity target: reference
``src/statistics_RQ_B_omnibus_testing_workflow.py`` (511 LoC): level
definitions CMC-only vs CMC+PSD (:38-97), the log transform (:264-274),
and the shared run_model_levels / FDR / forest / influence / power
machinery (:218-512).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from mba_tpu_torch.pipeline import statistical_modelling as statistics
from mba_tpu_torch.utils import file_management as filemgmt

RQB_RESPONSE_VAR = "Log_RMS_Accuracy"


def add_log_accuracy(df: pd.DataFrame) -> pd.DataFrame:
    """log-transform the RMSE DV (reference :264-274)."""
    df = df.copy()
    acc = pd.to_numeric(df["RMS_Accuracy"], errors="coerce")
    df[RQB_RESPONSE_VAR] = np.log(acc.where(acc > 0))
    return df


def fetch_level_definitions(multi_segments_per_trial: bool) -> list[dict]:
    """RQ-B levels: CMC-only vs CMC+PSD predictors (reference :38-97)."""
    id_vars = (['Trial ID', 'Segment ID'] if multi_segments_per_trial
               else ['Trial ID'])
    cmc_vars = ["CMC_Flexor_max_beta", "CMC_Extensor_max_beta",
                "CMC_Flexor_max_gamma", "CMC_Extensor_max_gamma"]
    psd_vars = ["PSD_eeg_F_C_beta", "PSD_eeg_P_PO_alpha"]
    return [
        {  # Level 0 — CMC predictors only
            'df_filter': None, 'condition_vars': {},
            'explanatory_vars': cmc_vars
            + ['Median Unscaled Force [% MVC]', 'Task Frequency']
            + id_vars,
            'moderation_pairs': None,
        },
        {  # Level 1 — CMC + PSD predictors
            'df_filter': None, 'condition_vars': {},
            'explanatory_vars': cmc_vars + psd_vars
            + ['Median Unscaled Force [% MVC]', 'Task Frequency']
            + id_vars,
            'moderation_pairs': None,
        },
    ]


_CMC_COLS = ["CMC_Flexor_max_beta", "CMC_Flexor_max_gamma",
             "CMC_Flexor_mean_beta", "CMC_Flexor_mean_gamma",
             "CMC_Extensor_max_beta", "CMC_Extensor_max_gamma",
             "CMC_Extensor_mean_beta", "CMC_Extensor_mean_gamma"]
_PSD_COLS = ["PSD_eeg_FC_CP_T_theta", "PSD_eeg_F_C_beta",
             "PSD_eeg_P_PO_alpha", "PSD_eeg_Global_gamma",
             "PSD_emg_1_flexor_Global_all",
             "PSD_emg_2_extensor_Global_all"]


def fetch_accuracy_level_definitions(multi_segments_per_trial: bool,
                                     include_emg_psd: bool = True,
                                     include_max_cmc: bool = True
                                     ) -> list[dict]:
    """RQ-B level definitions with collinearity controls (reference
    statistics_RQ_B_omnibus_testing_workflow.py:38-97): Level 0 = CMC
    only, Level 1 = CMC + (E)EG PSD; EMG-PSD and max-CMC columns can be
    dropped when collinear with force / mean CMC."""
    temporal = (["Trial ID", "Segment ID"] if multi_segments_per_trial
                else ["Trial ID"])
    force = (["Median Scaled Force [0-1]",
              "Median Unscaled Force [% MVC]"]
             if multi_segments_per_trial
             else ["Median Unscaled Force [% MVC]"])
    base = ["Task Frequency"] + temporal + force
    psd_cols = (_PSD_COLS if include_emg_psd
                else [c for c in _PSD_COLS if "emg" not in c])
    cmc_cols = (_CMC_COLS if include_max_cmc
                else [c for c in _CMC_COLS if "max" not in c])
    return [
        {'df_filter': None, 'condition_vars': {},
         'reference_categories': {},
         'explanatory_vars': base + cmc_cols, 'moderation_pairs': []},
        {'df_filter': None, 'condition_vars': {},
         'reference_categories': {},
         'explanatory_vars': base + cmc_cols + psd_cols,
         'moderation_pairs': []},
    ]


def run_rqb_omnibus(feature_data_dir: Path,
                    statistics_output_dir: Path,
                    n_within_trial_segments_list=(1, 2, 5, 10),
                    level_definitions_factory=None,
                    verbose: bool = False) -> pd.DataFrame:
    level_definitions_factory = (level_definitions_factory
                                 or fetch_level_definitions)
    statistics_output_dir = Path(statistics_output_dir)
    filemgmt.assert_dir(statistics_output_dir)
    all_frames, all_diag = [], []
    for n_segments in n_within_trial_segments_list:
        base_df = add_log_accuracy(pd.read_csv(
            filemgmt.most_recent_file(
                feature_data_dir, ".csv",
                [f"Combined Statistics {n_segments}seg"])))
        results: list = []
        diagnostics: list = []
        statistics.run_model_levels(
            base_df, level_definitions_factory(n_segments > 1),
            response_var=RQB_RESPONSE_VAR,
            hypothesis_name="RQ-B: neural features -> accuracy",
            n_windows_per_trial=n_segments, all_results_list=results,
            diagnostics_list=diagnostics, verbose=verbose)
        frame = pd.DataFrame(results)
        frame["N. Segments"] = n_segments
        diag = pd.DataFrame(diagnostics)
        diag["N. Segments"] = n_segments
        all_frames.append(frame)
        all_diag.append(diag)

    combined = pd.concat(all_frames, ignore_index=True)
    combined = statistics.apply_fdr_correction(combined,
                                               levels_to_correct=[1])
    combined.to_csv(statistics_output_dir / filemgmt.file_title(
        "All Time Resolutions Results", ".csv"), index=False)
    pd.concat(all_diag, ignore_index=True).to_csv(
        statistics_output_dir / filemgmt.file_title(
            "All Time Resolutions Diagnostics", ".csv"), index=False)
    return combined


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    paths = StudyPaths().ensure()
    run_rqb_omnibus(paths.feature_data, paths.statistics_rq_b)
