"""Per-subject log enrichment + hand-curated amendments.

Parity target: reference ``src/data_integration_workflow.py`` (378 LoC):
enrichment via ``prepare_log_frame``, per-subject curation hooks (song
removals, trial exclusions, 'Actual Start Trigger' insertions;
:54-328), song/questionnaire validation + repair (:335-351), force
validation (:356-373), and the "Enriched Experiment Log" save (:379).

A host copy of ``mba_tpu/workflows/data_integration_workflow.py`` (the
port never imports ``mba_tpu``).
"""
from __future__ import annotations

from pathlib import Path

import pandas as pd

from mba_tpu_torch.pipeline import data_integration as di
from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.workflows.study_curation import (STUDY_CURATION,
                                              SubjectCuration,
                                              apply_subject_curation)

# Extension hooks on top of the study's committed curation record
# (study_curation.STUDY_CURATION carries the reference's subject-0-11
# amendments, reference :54-328): callables raw_log -> raw_log or
# enriched -> enriched applied after the registry record.
RAW_LOG_AMENDMENTS: dict[int, list] = {}
ENRICHED_AMENDMENTS: dict[int, list] = {}


def integrate_subject(subject: int, experiment_data_dir: Path,
                      validate: bool = True,
                      repair_questionnaires: bool = True,
                      avg_end_delay_seconds: float = 6.0,
                      curation: SubjectCuration | str | None = None
                      ) -> pd.DataFrame:
    """Raw log → curated, validated, enriched log (saved).

    ``curation``: a :class:`SubjectCuration` record, the string
    ``"study"`` to apply the committed study registry for this subject
    (what the ``__main__`` run does — reference :54-328), or None for
    plain enrichment (arbitrary / non-study data).
    """
    subject_dir = Path(experiment_data_dir) / f"subject_{subject:02}"
    raw = di.fetch_experiment_log(subject_dir)
    for amend in RAW_LOG_AMENDMENTS.get(subject, []):
        raw = amend(raw)
    if curation == "study":
        curation = STUDY_CURATION.get(subject, SubjectCuration())
    raw, enriched = apply_subject_curation(
        raw, curation or SubjectCuration(),
        avg_end_delay_seconds=avg_end_delay_seconds)
    for amend in ENRICHED_AMENDMENTS.get(subject, []):
        enriched = amend(enriched)

    if validate:
        if enriched["Song ID"].notna().any():
            di.validate_song_indices(
                enriched[enriched["Song ID"].notna()], subject_dir,
                verbose=False)
            report = di.validate_trial_questionnaires(
                enriched, subject_dir, verbose=False)
            if repair_questionnaires and report["mismatches"]:
                enriched = di.repair_trial_questionnaire_mismatches(
                    enriched, report)
        try:
            serial = di.fetch_serial_measurements(subject_dir)
            di.validate_force_measurements(
                enriched.set_index("Time"), serial)
        except ValueError:
            print(f"[subject {subject}] no serial measurements for "
                  f"force validation")

    log_dir = subject_dir / "experiment_logs"
    filemgmt.assert_dir(log_dir)
    enriched.to_csv(log_dir / filemgmt.file_title(
        "Enriched Experiment Log", ".csv"), index=False)
    return enriched


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    subjects = list(range(12))
    paths = StudyPaths().ensure()
    for subject in subjects:
        integrate_subject(subject, paths.experiment_data,
                          curation="study")
