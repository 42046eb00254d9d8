"""Acquisition entry point (reference ``src/experiment_workflow.py``; a
copy of ``mba_tpu/workflows/experiment_workflow.py``).

Loads ``config/experiment_config.txt``, probes for hardware (falls back to
the dummy sampler), and runs the event-driven phase machine in
:mod:`mba_tpu_torch.acquisition.experiment`.
"""
from __future__ import annotations

from pathlib import Path

from mba_tpu_torch.acquisition.experiment import (ExperimentConfig,
                                            start_experiment_processes)


def run_experiment(subject_id: int, output_dir: Path,
                   config_txt: Path | None = None, **overrides) -> dict:
    if config_txt is not None and Path(config_txt).exists():
        cfg = ExperimentConfig.from_txt(config_txt)
    else:
        cfg = ExperimentConfig()
    cfg.subject_id = subject_id
    cfg.output_dir = Path(output_dir)
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return start_experiment_processes(cfg)


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    subject_id = 0
    paths = StudyPaths().ensure()
    run_experiment(subject_id, paths.experiment_data,
                   config_txt=paths.root / "config"
                   / "experiment_config.txt")
