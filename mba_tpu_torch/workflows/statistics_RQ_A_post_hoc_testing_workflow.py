"""RQ-A post-hoc: CBPA contrast batch + phase-average figures +
heterogeneity modelling.

Parity target: reference
``src/statistics_RQ_A_post_hoc_testing_workflow.py`` (519 LoC): the CBPA
config batch (phase-normalised, 1000 permutations, tail=1; :136-465),
CMC-accuracy / EMG-PSD phase-average figures (:472-485), and the
heterogeneity-modelling call (:492-519).

Port of ``mba_tpu/workflows/statistics_RQ_A_post_hoc_testing_workflow.py``:
the CBPA batch runs its nulls on the card (``CBPAConfig.device``), the
figures import matplotlib only when they draw, and the heterogeneity
modelling (host code: sklearn, scipy, matplotlib) runs on the CPU.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from mba_tpu_torch.pipeline.cbpa import (CBPAConfig, run_batch,
                                         assemble_phase_average_maps,
                                         assemble_accuracy_phase_profiles)
from mba_tpu_torch.pipeline.heterogeneity_modelling import \
    run_heterogeneity_modelling


def make_phase_average_figures(data_root: Path, output_dir: Path,
                               experiment_results_dir: Path,
                               subject_ids: list[int],
                               band: str = "beta",
                               muscle: str = "Flexor",
                               use_phase_normalization: bool = True,
                               n_phase_bins: int = 36) -> dict:
    """CMC-accuracy and EMG-PSD phase-average figures (reference
    statistics_RQ_A_post_hoc_testing_workflow.py:472-485 →
    visualizations.py:3143-3733): cohort phase maps assembled from the
    stored spectrograms, accuracy profiles from the trial accuracy CSVs,
    and the measured dynamometer force under the target sine."""
    from mba_tpu_torch.pipeline import visualizations as viz

    def cfg_for(modality, file_id):
        return CBPAConfig(
            modality=modality, modality_file_id=file_id, freq_band=band,
            condition_column="Category or Silence",
            condition_A="_", condition_B="_",
            use_phase_normalization=use_phase_normalization,
            n_phase_bins=n_phase_bins, show_target_sine=True,
            data_root=data_root, output_dir=output_dir,
            hypothesis_label=f"phase_avg_{modality}_{file_id}",
            save_plots=False, show_plots=False)

    cfg_cmc = cfg_for("CMC", muscle)
    grid, cmc_map, ch_names = assemble_phase_average_maps(
        cfg_cmc, subject_ids=subject_ids)
    accuracy = assemble_accuracy_phase_profiles(
        cfg_cmc, experiment_results_dir, subject_ids)
    phase_grid = (grid if use_phase_normalization
                  else np.linspace(0, 360, n_phase_bins, endpoint=False))
    force_mean = force_sd = None
    if use_phase_normalization:
        force_mean, force_sd = viz.load_avg_dynamometer_force_per_phase(
            subject_ids, experiment_results_dir, phase_grid, cfg_cmc,
            return_std=True)
    out = {"accuracy_conditions": sorted(accuracy)}
    viz.plot_cmc_accuracy_phase_average(
        phase_grid, cmc_map,
        accuracy or {"all": [np.zeros(len(phase_grid))]},
        cfg=cfg_cmc if use_phase_normalization else None,
        cmc_channel_labels=ch_names, force_mean=force_mean,
        force_sd=force_sd, save_dir=output_dir,
        title=f"CMC Accuracy Phase Average {muscle} {band}")
    out["cmc_map_shape"] = tuple(cmc_map.shape)

    try:
        _, flexor_map, _ = assemble_phase_average_maps(
            cfg_for("PSD", "emg_1_flexor"), subject_ids=subject_ids)
        _, extensor_map, _ = assemble_phase_average_maps(
            cfg_for("PSD", "emg_2_extensor"), subject_ids=subject_ids)
        viz.plot_emg_psd_phase_average_plot(
            phase_grid, flexor_map, extensor_map,
            cfg=cfg_cmc if use_phase_normalization else None,
            force_mean=force_mean, force_sd=force_sd,
            save_dir=output_dir,
            title=f"EMG PSD Phase Average {band}")
        out["emg_map_shape"] = tuple(flexor_map.shape)
    except RuntimeError as exc:
        print(f"[phase figures] EMG PSD maps unavailable: {exc}")
    return out


def build_cbpa_configs(data_root: Path, output_dir: Path,
                       n_permutations: int = 1000,
                       use_phase_normalization: bool = True,
                       tail: int = 1, device=None) -> list[CBPAConfig]:
    """The study's CBPA contrast batch (reference :136-465); each null
    runs on ``device`` (the card unless ``"cpu"``)."""
    contrasts = [("Happy", "Silence"), ("Groovy", "Silence"),
                 ("Sad", "Silence"), ("Classic", "Silence")]
    configs = []
    for band in ("beta", "gamma"):
        for muscle in ("Flexor", "Extensor"):
            for cond_a, cond_b in contrasts:
                configs.append(CBPAConfig(
                    modality="CMC", modality_file_id=muscle,
                    freq_band=band,
                    condition_column="Category or Silence",
                    condition_A=cond_a, condition_B=cond_b,
                    n_permutations=n_permutations, tail=tail,
                    use_phase_normalization=use_phase_normalization,
                    data_root=data_root, output_dir=output_dir,
                    hypothesis_label=f"CMC_{muscle}_{band}_"
                                     f"{cond_a}_vs_{cond_b}",
                    save_plots=True, show_plots=False, device=device))
    return configs


def run_post_hoc(data_root: Path, output_dir: Path,
                 omnibus_results_dir: Path,
                 experiment_results_dir: Path,
                 n_permutations: int = 1000,
                 run_cbpa_batch: bool = True,
                 run_heterogeneity: bool = True,
                 make_phase_figures: bool = True,
                 subject_ids: list[int] | None = None,
                 heterogeneity_dep_vars=None, device=None) -> None:
    if run_cbpa_batch:
        configs = build_cbpa_configs(data_root, output_dir,
                                     n_permutations, device=device)
        run_batch(configs)

    if make_phase_figures:
        try:
            make_phase_average_figures(
                data_root, output_dir, experiment_results_dir,
                subject_ids or list(range(12)))
        except RuntimeError as exc:
            print(f"[post-hoc] phase-average figures skipped: {exc}")

    if run_heterogeneity:
        run_heterogeneity_modelling(
            dep_vars=heterogeneity_dep_vars or [
                "CMC_Flexor_max_beta", "CMC_Flexor_mean_beta",
                "CMC_Extensor_max_beta"],
            conditions_to_evaluate={
                "lvl_0": ("Music Listening", [True]),
                "lvl_1": ("Category or Silence",
                          ["Happy", "Groovy", "Sad", "Classic"])},
            clustering_measures=["contrast", "cooks_d"],
            plot_mi_categories=[], top_n_moderators=3,
            min_cluster_size=2, output_dir=output_dir,
            omnibus_results_dir=omnibus_results_dir,
            experiment_results_dir=experiment_results_dir)


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    paths = StudyPaths().ensure()
    run_post_hoc(paths.root, paths.statistics_rq_a_post_hoc,
                 paths.statistics_rq_a, paths.experiment_data)
