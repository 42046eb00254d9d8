"""Shared study directory layout (reference src/*_workflow.py headers).

A copy of ``mba_tpu/workflows/paths.py``, for the port's workflows'
``__main__`` blocks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from mba_tpu_torch.utils.file_management import assert_dir


@dataclass
class StudyPaths:
    """data/ and output/ tree rooted at the project directory."""
    root: Path = field(default_factory=lambda: Path().resolve())

    def __post_init__(self):
        self.root = Path(self.root)

    @property
    def data(self) -> Path:
        return self.root / "data"

    @property
    def experiment_data(self) -> Path:
        return self.data / "experiment_results"

    @property
    def feature_data(self) -> Path:
        return self.data / "precomputed_features"

    @property
    def song_characteristics(self) -> Path:
        return self.data / "song_characteristics"

    @property
    def output(self) -> Path:
        return self.root / "output"

    @property
    def statistics_rq_a(self) -> Path:
        return self.output / "statistics_RQ_A" / "omnibus_testing"

    @property
    def statistics_rq_a_post_hoc(self) -> Path:
        return self.output / "statistics_RQ_A" / "post_hoc_testing"

    @property
    def statistics_rq_b(self) -> Path:
        return self.output / "statistics_RQ_B" / "omnibus_testing"

    @property
    def reports(self) -> Path:
        return self.output / "reports"

    def subject_experiment_dir(self, subject: int) -> Path:
        return self.experiment_data / f"subject_{subject:02}"

    def subject_feature_dir(self, subject: int) -> Path:
        return self.feature_data / f"subject_{subject:02}"

    def ensure(self) -> "StudyPaths":
        for p in (self.experiment_data, self.feature_data,
                  self.song_characteristics, self.statistics_rq_a,
                  self.statistics_rq_a_post_hoc, self.statistics_rq_b,
                  self.reports):
            assert_dir(p)
        return self
