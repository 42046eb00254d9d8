"""Stage workflows of the port (``mba_tpu/workflows``), one slice at a
time: the OTB4 import, the data integration with the study's curation
record, the preprocessing workflow, the per-subject feature extraction
(``run_subject``), the statistics data preparation (the Combined
Statistics frames), and the statistics workflows (RQ-A and RQ-B omnibus,
RQ-A mediation and post-hoc) with the study paths their scripts use.
Re-exports ``StudyPaths``, as ``mba_tpu/workflows/__init__.py`` does."""
from mba_tpu_torch.workflows.paths import StudyPaths  # noqa: F401
