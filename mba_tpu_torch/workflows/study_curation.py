"""The study's hand-curated per-subject data amendments, as data.

Parity target: reference ``src/data_integration_workflow.py:54-328``, which
hard-codes 270 lines of subject-0-11 curation inline (song removals where
Spotify skipped tracks, flawed-row removals where a song start wasn't
registered, trial annotations/exclusions for dynamometer freezes and
talking, idle-state phase marks, and subject 2's delayed 'Actual Start
Trigger' insertion).  Here the same record is a declarative registry
(:data:`STUDY_CURATION`) applied by :func:`apply_subject_curation` in the
reference's exact order:

1. drop flawed single rows from the raw log;
2. blank wrongly-executed songs (needs a first enrichment pass to locate
   them — reference :60-66 passes the enriched frame into
   ``remove_song_entries``);
3. re-enrich via ``prepare_log_frame``;
4. annotate/exclude trials;
5. mark the idle-state recording tail;
6. optionally insert 'Actual Start Trigger' at the first log row ≥
   qtc-start + offset (subject 2, reference :110-118).

The tuples below are the study's factual curation record (titles, artists,
ids, timestamps, comments, exclusion flags) — required for the actual
experiment to be reproducible through this framework.

A host copy of ``mba_tpu/workflows/study_curation.py`` (the port never
imports ``mba_tpu``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import pandas as pd

from mba_tpu_torch.pipeline import data_integration as di


@dataclass(frozen=True)
class SubjectCuration:
    """Declarative per-subject amendment record.

    annotations entries: (comment, exclude, selector, id) with selector in
    {'trial_id', 'song_id', 'silence_id'}.
    """
    row_removals: tuple = ()
    song_removals: tuple = ()
    annotations: tuple = ()
    idle_state_from: str | None = None
    actual_start_trigger_offset_min: float | None = None


_FLAWED = "Flawed Dynamometer Measurement and Corresponding Talking"

STUDY_CURATION: dict[int, SubjectCuration] = {
    0: SubjectCuration(),
    1: SubjectCuration(
        song_removals=(
            ("Ain't No Sunshine", "Bill Withers", 17),
            ("Merry-Go-Round of Life - from 'Howl's Moving Castle'",
             "Joe Hisaishi", 21),
            ("As", "George Michael", 24),
            ("Dancing In the Dark", "Bruce Springsteen", 28)),
        annotations=(
            ("Talking and frustration because of briefly stuck "
             "measurement", True, "trial_id", 11),
            ("Talking and frustration because of briefly stuck "
             "measurement", True, "trial_id", 15))),
    2: SubjectCuration(
        song_removals=(
            ("I Say a Little Prayer", "Aretha Franklin", 0),
            ("Celebration", "Kool & The Gang", 1),
            ("Uptown Funk (feat. Bruno Mars)", "Mark Ronson", 2)),
        annotations=tuple(
            (_FLAWED, True, "trial_id", t) for t in (0, 1, 2, 4, 5)),
        idle_state_from="2026-01-17 21:05:20",
        actual_start_trigger_offset_min=15.0),
    3: SubjectCuration(
        song_removals=(
            ("Merry-Go-Round of Life - from 'Howl's Moving Castle'",
             "Joe Hisaishi", 2),
            ("Never Too Much", "Luther Vandross", 14)),
        row_removals=("2026-01-22 18:59:30.676946",),
        idle_state_from="2026-01-22 19:08:00"),
    4: SubjectCuration(
        song_removals=(
            ("Can't Get Enough! - Vocal Club Mix", "Soulsearcher", 8),),
        annotations=(
            ("Talking", False, "song_id", 8),
            ("Talking and then was repeated anyways", True,
             "silence_id", 1)),
        idle_state_from="2026-01-23 17:56:00"),
    5: SubjectCuration(
        row_removals=("2026-01-27 16:22:35.172122",),
        song_removals=(
            ("Comptine d'un autre été, l'après-midi", "Yann Tiersen", 4),
            ("Guilty - 2001 Remastered Version", "George Shearing", 6),
            ("For You - Original Radio Edit", "The Disco Boys", 12),
            ("Crying at the Discoteque - Radio Edit", "Alcazar", 15),
            ("Mas Que Nada", "Sérgio Mendes", 19),
            ("Can't Get You out of My Head", "Kylie Minogue", 22)),
        annotations=(
            (_FLAWED, True, "trial_id", 1),
            (_FLAWED, True, "trial_id", 2),
            ("Wrong Song Playing", False, "trial_id", 5),
            (_FLAWED, True, "trial_id", 11)),
        idle_state_from="2026-01-27 16:54:00"),
    6: SubjectCuration(
        song_removals=(
            ("Merry-Go-Round of Life - from 'Howl's Moving Castle'",
             "Joe Hisaishi", 0),
            ("Mas Que Nada", "Sérgio Mendes", 11),
            ("Can't Get Enough! - Vocal Club Mix", "Soulsearcher", 14),
            ("Something Got Me Started - 2008 Remaster", "Simply Red",
             17),
            ("I Was Made For Lovin' You", "KISS", 20),
            ("Waiting For Godard - Full Mix", "Marco Andrea Pes", 25)),
        annotations=(
            (_FLAWED, True, "trial_id", 18),
            (_FLAWED, True, "trial_id", 28)),
        idle_state_from="2026-01-28 19:35:10"),
    7: SubjectCuration(
        row_removals=("2026-02-08 15:10:33.846501",
                      "2026-02-08 15:19:42.174379"),
        annotations=(
            (_FLAWED, True, "trial_id", 10),
            (_FLAWED, True, "trial_id", 15),
            (_FLAWED, True, "trial_id", 17)),
        idle_state_from="2026-02-08 15:50:00"),
    8: SubjectCuration(
        song_removals=(("Suzanne", "Leonard Cohen", 0),),
        row_removals=("2026-02-12 16:33:52.297349",),
        annotations=(
            ("Sampling Process Crashed", True, "trial_id", 10),
            (_FLAWED, True, "trial_id", 13)),
        idle_state_from="2026-02-12 16:55:00"),
    9: SubjectCuration(
        row_removals=("2026-02-18 19:27:32.356709",),
        song_removals=(
            ("Comptine d'un autre été, l'après-midi", "Yann Tiersen", 3),
            ("Blurred Lines", "Robin Thicke", 11)),
        annotations=(
            (_FLAWED, True, "trial_id", 9),
            (_FLAWED, True, "trial_id", 11),
            ("Flawed Dynamometer Measurement at End but shortened trial "
             "accordingly", False, "trial_id", 12),
            (_FLAWED, True, "trial_id", 15)),
        idle_state_from="2026-02-18 19:34:00"),
    10: SubjectCuration(
        song_removals=(
            ("Comptine d'un autre été, l'après-midi", "Yann Tiersen", 5),),
        annotations=(
            (_FLAWED, True, "trial_id", 10),
            (_FLAWED, True, "trial_id", 14),
            ("Flawed Dynamometer Measurement towards End (should be "
             "fine)", True, "trial_id", 15)),
        idle_state_from="2026-02-19 19:20:00"),
    11: SubjectCuration(
        row_removals=("2026-03-02 20:35:03.293652",
                      "2026-03-02 20:48:04.561328",
                      "2026-03-02 21:01:32.201205"),
        annotations=(
            ("Lights in the Room Turned Off but Task was Fine", False,
             "trial_id", 8),),
        idle_state_from="2026-03-03 21:10:00"),
}


def apply_subject_curation(raw_log: pd.DataFrame,
                           curation: SubjectCuration,
                           avg_end_delay_seconds: float = 6.0
                           ) -> tuple[pd.DataFrame, pd.DataFrame]:
    """Apply one subject's amendment record (reference order, see module
    docstring).  Returns (curated_raw_log, enriched_log)."""
    raw = raw_log
    for ts in curation.row_removals:
        raw = di.remove_single_row_by_timestamp(raw, ts)
    if curation.song_removals:
        first_pass = di.prepare_log_frame(
            raw, set_time_index=False,
            avg_end_delay_seconds=avg_end_delay_seconds)
        raw = di.remove_song_entries(first_pass, raw,
                                     list(curation.song_removals))
    enriched = di.prepare_log_frame(
        raw, set_time_index=False,
        avg_end_delay_seconds=avg_end_delay_seconds)

    for comment, exclude, selector, ident in curation.annotations:
        enriched = di.annotate_trial(enriched, comment, exclude,
                                     **{selector: ident})

    if curation.idle_state_from is not None:
        t0 = pd.Timestamp(curation.idle_state_from)
        times = pd.to_datetime(enriched["Time"])
        if times.dt.tz is not None and t0.tz is None:
            t0 = t0.tz_localize(times.dt.tz)
        enriched.loc[times >= t0, "Phase"] = "Idle State"

    if curation.actual_start_trigger_offset_min is not None:
        # reference :110-118: EEG/EMG recording effectively started late;
        # insert the trigger at the first log row ≥ qtc-start + offset so
        # downstream alignment anchors there
        qtc_start, _ = di.get_qtc_measurement_start_end(enriched,
                                                        verbose=False)
        target = pd.Timestamp(qtc_start) + pd.Timedelta(
            minutes=curation.actual_start_trigger_offset_min)
        times = pd.to_datetime(enriched["Time"])
        if times.dt.tz is not None and target.tz is None:
            target = target.tz_localize(times.dt.tz)
        elif times.dt.tz is None and target.tz is not None:
            target = target.tz_localize(None)
        after = enriched.index[times >= target]
        if len(after) == 0:
            raise ValueError(
                "actual-start-trigger offset lands beyond the log")
        enriched.loc[after[0], "Event"] = "Actual Start Trigger"

    return raw, enriched
