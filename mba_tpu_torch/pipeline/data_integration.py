"""Multimodal time alignment and experiment-log enrichment (a copy of
``mba_tpu/pipeline/data_integration.py``: the port never imports
``mba_tpu``).

Parity target: reference ``src/pipeline/data_integration.py`` (2154 LoC).
The experiment log (Time/Music/Event/Questionnaire rows written by the
acquisition GUI) is parsed into trial-level metadata; trigger events anchor
the EEG/EMG recording clock; trial spans drive every downstream window mask.

Key symbols (reference line refs):
- ``TRIAL_ACCURACY_START_OFFSET_SEC`` / accuracy axis    ↔ :14-44
- :func:`fetch_experiment_log`                            ↔ :48-133
- :func:`prepare_log_frame`                               ↔ :136-517
- trial-id algebra                                        ↔ :520-544
- :func:`get_song_start_end` / :func:`get_task_start_end` ↔ :548-714
- :func:`get_all_task_start_ends`                         ↔ :717-763
- :func:`get_qtc_measurement_start_end`                   ↔ :766-954
- validators / repair / manual-curation ops               ↔ :957-1526
- loaders (serial, questionnaires, personal data, music)  ↔ :1532-2154

Everything here is host-side pandas (irregular timestamped frames).
"""
from __future__ import annotations

import ast
import json
import re
import weakref
from pathlib import Path
from typing import Literal

import numpy as np
import pandas as pd

from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.pipeline.data_analysis import make_timezone_aware

# accuracy_sampler starts logging squared error after an initial wait phase
TRIAL_ACCURACY_START_OFFSET_SEC: float = 5.5  # 5 seconds + slight latency


def build_accuracy_relative_time_axis(
        n_samples: int, trial_dur_sec: float,
        start_offset_sec: float = TRIAL_ACCURACY_START_OFFSET_SEC,
        *, endpoint: bool = False) -> np.ndarray:
    """Relative timestamps of trial-accuracy samples (reference :17-44).

    Restricted to ``[start_offset_sec, trial_dur_sec)``; endpoint=False
    because the sampler's last sample falls one period before trial end.
    """
    if n_samples <= 0:
        return np.array([], dtype=float)
    trial_dur = float(trial_dur_sec)
    start_offset = float(start_offset_sec)
    if not np.isfinite(trial_dur) or not np.isfinite(start_offset):
        raise ValueError(
            "trial_dur_sec and start_offset_sec must be finite numbers.")
    if trial_dur <= start_offset:
        return np.array([], dtype=float)
    return start_offset + np.linspace(0.0, trial_dur - start_offset,
                                      int(n_samples), endpoint=endpoint)


# ========================================================================
# log-frame loading & enrichment
# ========================================================================
def _process_frame(df: pd.DataFrame) -> pd.DataFrame:
    """Parse 'Time', sort ascending, drop timestamp duplicates."""
    if 'Time' not in df.columns:
        raise ValueError("DataFrame missing 'Time' column.")
    df['Time'] = pd.to_datetime(df['Time'])
    return (df.sort_values('Time', ascending=True)
            .drop_duplicates(subset=['Time'], keep='first')
            .reset_index(drop=True))


def fetch_experiment_log(subject_data_dir: Path) -> pd.DataFrame:
    """Concatenate WorkMem / Final (or Interim fallback) log saves.

    Parity: reference :48-119 — crash-resilient triple-tier log loading.
    """
    log_dir = Path(subject_data_dir) / 'experiment_logs'
    if not log_dir.exists():
        raise FileNotFoundError(f"Log directory not found: {log_dir}")

    wm_frames = []
    try:
        wm_paths = filemgmt.most_recent_file(
            log_dir, ".csv", ["Working Memory Full Save"],
            return_type='dict')['files']
        wm_frames = [pd.read_csv(p) for p in wm_paths]
        print(f"Found {len(wm_frames)} Working Memory Full Save logs in "
              f"{log_dir}.")
    except ValueError:
        print(f"No Working Memory Full Save logs found in {log_dir}.")

    try:
        final_path = filemgmt.most_recent_file(log_dir, ".csv",
                                               ["Final Full Save"])
    except ValueError:
        print(f"No 'Final Full Save' in {log_dir}. Using 'Interim Save' as "
              f"fallback.")
        try:
            final_path = filemgmt.most_recent_file(log_dir, ".csv",
                                                   ["Interim Save"])
        except ValueError:
            raise ValueError(f"No log files found in {log_dir}")
    final_frame = pd.read_csv(final_path)

    frames = wm_frames + [final_frame] if wm_frames else [final_frame]
    if len(frames) > 1:
        if not all(f.shape[1] == frames[0].shape[1] for f in frames[1:]):
            raise ValueError("Incompatible columns across frames.")
        combined = pd.concat(frames, ignore_index=True)
    else:
        combined = frames[0]
    return _process_frame(combined)


def prepare_log_frame(log_frame: pd.DataFrame,
                      set_time_index: bool = True,
                      avg_end_delay_seconds: float = 6.0) -> pd.DataFrame:
    """Parse and enrich a raw experiment log with trial-level metadata.

    Parity: reference :136-517.  Derives (in order): Music Category /
    Within-Category Song Index / Song Info / Title / Artist / Runtime from
    the ``Music`` status strings; Task Frequency + Task RMSE from the
    ``Questionnaire`` strings (with 6-s end adjustment); Phase labels;
    Song/Silence/Trial IDs via shift-compare cumsum; questionnaire values
    (familiarity + post-trial dict) with trial-scoped ffill/bfill;
    Perceived Category; and Trial Comment / Exclusion placeholders.
    """
    log_frame = log_frame.copy()

    # ---------- status-string parsing ----------
    def song_category_string(s: str) -> str:
        parts = s.split(" | ")
        if len(parts) == 2:
            return "No category"
        if len(parts) == 3:
            return parts[0]
        return "No song playing"

    cat_str = log_frame['Music'].apply(song_category_string)
    log_frame['Music Category'] = cat_str.apply(
        lambda s: "No category" if len(s.split(" (")) == 1
        else s.split(" (")[0])
    log_frame['Within Category Song Index'] = cat_str.apply(
        lambda s: None if len(s.split(" (")) == 1
        else int(s.split(" (")[1].split("/")[0]))

    def song_info(s: str) -> str:
        parts = s.split(" | ")
        if len(parts) == 2:
            return parts[0]
        if len(parts) == 3:
            return parts[1]
        return "No song playing"

    log_frame['Song Info'] = log_frame['Music'].apply(song_info)
    split = log_frame['Song Info'].str.rsplit(' by ', n=1, expand=True)
    log_frame['Song Title'] = split[0].str.strip()
    log_frame['Song Artist'] = (split[1].str.strip()
                                if split.shape[1] > 1 else None)

    def song_runtime(s: str):
        parts = s.split(" | ")
        if len(parts) == 2:
            return float(parts[1].split(" / ")[0].split("s")[0])
        if len(parts) == 3:
            return float(parts[2].split(" / ")[0].split("s")[0])
        return None

    log_frame['Song Runtime'] = log_frame['Music'].apply(song_runtime)

    # ---------- task frequency / RMSE ----------
    # avg_end_delay_seconds (default 6.0) prevents analysis of the RMSE
    # computation/documentation delay at task end (reference :211-277)
    df = log_frame
    df['Task Frequency'] = df['Questionnaire'].str.extract(
        r'target frequency ([\d.]+)Hz', expand=False)
    df['Task RMSE'] = df['Questionnaire'].str.extract(
        r'Achieved RMSE: ([\d.]+)', expand=False)
    is_test = df['Questionnaire'].str.contains(
        r'Starting\s+test\s+motor task', na=False, regex=True)
    df.loc[is_test, 'Task Frequency'] = np.nan
    df['is_start'] = df['Questionnaire'].str.contains(
        r'Starting(?!\s+test)\s+motor task', na=False, regex=True)
    df['task_id'] = df['is_start'].cumsum()
    df['Task Frequency'] = df.groupby('task_id')['Task Frequency'].ffill()
    df['Task RMSE'] = df.groupby('task_id')['Task RMSE'].bfill()

    is_end = df['Questionnaire'].str.contains('Achieved RMSE', na=False)
    df['Time'] = pd.to_datetime(df['Time'])
    adjusted_is_end = pd.Series(False, index=df.index)
    for end_time in df.loc[is_end, 'Time'].values:
        target_time = end_time - pd.Timedelta(seconds=avg_end_delay_seconds)
        task_of_end = df.loc[is_end & (df['Time'] == end_time),
                             'task_id'].iloc[0]
        sel = (df['task_id'] == task_of_end) & (df['Time'] <= target_time)
        if sel.any():
            adjusted_is_end.loc[df[sel].index[-1]] = True
    rows_after_end = (adjusted_is_end.shift(fill_value=False)
                      .groupby(df['task_id']).cumsum() > 0)
    df.loc[rows_after_end, 'Task Frequency'] = np.nan
    df.loc[rows_after_end, 'Task RMSE'] = np.nan
    df = df.drop(columns=['is_start', 'task_id'])

    # ---------- phase labels ----------
    df['Phase'] = pd.Series([None] * len(df), dtype=object)
    has_cat = df['Music Category'].notna() & (df['Music Category']
                                              != 'No category')
    has_freq = df['Task Frequency'].notna()
    df.loc[has_cat & has_freq, 'Phase'] = \
        df.loc[has_cat & has_freq, 'Music Category'] + ' Task'
    df.loc[(df['Music Category'] == 'No category') & has_freq,
           'Phase'] = 'Silence Task'
    df.loc[has_cat & ~has_freq, 'Phase'] = \
        df.loc[has_cat & ~has_freq, 'Music Category'] + ' Listening'

    # ---------- song / silence / trial IDs ----------
    df['Song ID'] = ((df['Song Info'] != df['Song Info'].shift())
                     & (df['Song Info'] != "No song playing")
                     & (df['Music Category'] != "No category")
                     ).cumsum() - 1
    df.loc[df['Music Category'] == "No category", 'Song ID'] = np.nan
    df.loc[df['Song Info'] == "No song playing", 'Song ID'] = np.nan

    freq_b = df.groupby('Song ID')['Task Frequency'].bfill()
    freq_f = df.groupby('Song ID')['Task Frequency'].ffill()
    df['Song Skipped'] = (~df['Song ID'].isna() & freq_b.isna()
                          & freq_f.isna()).astype('boolean')
    df.loc[df['Song ID'].isna(), 'Song Skipped'] = pd.NA

    df['Silence ID'] = ((df['Phase'] == 'Silence Task')
                        & (df['Phase'] != df['Phase'].shift())
                        ).cumsum() - 1
    df.loc[df['Phase'] != 'Silence Task', 'Silence ID'] = np.nan

    df['Trial ID'] = np.nan
    df.loc[~df['Song ID'].isna(), 'Trial ID'] = \
        df.loc[~df['Song ID'].isna(), 'Song ID']
    df.loc[~df['Silence ID'].isna(), 'Trial ID'] = \
        df.loc[~df['Silence ID'].isna(), 'Silence ID']
    df['Trial ID'] = ((df['Trial ID'] != df['Trial ID'].shift())
                      & ~df['Trial ID'].isna()).cumsum() - 1
    df.loc[df['Song ID'].isna() & df['Silence ID'].isna(),
           'Trial ID'] = np.nan

    # ---------- questionnaire extraction ----------
    # (fillna first: pandas 3 string dtype keeps NaN through astype(str))
    df['Questionnaire'] = df['Questionnaire'].fillna("").astype(str)
    df['Familiarity'] = df['Questionnaire'].apply(
        lambda t: float(m.group(1))
        if (m := re.search(r'Familiarity check result:\s*(\d)', t))
        else np.nan)
    df['Familiarity'] = df.groupby('Trial ID')['Familiarity'].ffill()
    df['Familiarity'] = df.groupby('Trial ID')['Familiarity'].bfill()

    def post_trial(t: str) -> dict:
        try:
            m = re.search(r"\{.*\}", t)
            if m:
                data = ast.literal_eval(m.group(0))
                for key in ('Liking', 'Fitting Category', 'Other category',
                            'Emotional State'):
                    data.setdefault(key, np.nan)
                return data
        except Exception:
            pass
        return {'Liking': np.nan, 'Fitting Category': np.nan,
                'Emotional State': np.nan, 'Other category': np.nan}

    pt = df['Questionnaire'].apply(post_trial)
    for key in ('Liking', 'Fitting Category', 'Emotional State',
                'Other category'):
        df[key] = pt.apply(lambda d, k=key: d[k])

    # post-trial answers may arrive after the trial ended: ffill Trial ID
    # temporarily, propagate, then reset (reference :464-483)
    df['Trial ID'] = df['Trial ID'].ffill()
    for key in ('Liking', 'Fitting Category', 'Emotional State',
                'Other category'):
        df[key] = df.groupby('Trial ID')[key].ffill()
        df[key] = df.groupby('Trial ID')[key].bfill()
    df.loc[df['Song ID'].isna() & df['Silence ID'].isna(),
           'Trial ID'] = np.nan
    for key in ('Liking', 'Fitting Category', 'Emotional State',
                'Other category'):
        df.loc[df['Trial ID'].isna(), key] = np.nan

    # ---------- perceived category ----------
    df['Perceived Category'] = df['Music Category'].str.extract(
        r'[Ff]amiliar\s+(\w+)', expand=False)
    override = (~df['Other category'].isna()
                & (df['Other category'] != 'None of them'))
    df.loc[override, 'Perceived Category'] = df.loc[override,
                                                    'Other category']

    # ---------- placeholders ----------
    df['Trial Comment'] = [""] * len(df)
    df['Trial Exclusion Bool'] = pd.array([False] * len(df),
                                          dtype='boolean')
    df.loc[df['Trial ID'].isna(), 'Trial Exclusion Bool'] = pd.NA

    if set_time_index:
        df['Time'] = pd.to_datetime(df['Time'])
        df = df.set_index('Time')
    return df


# ========================================================================
# trial-id algebra & time spans
# ========================================================================
_SPAN_TABLE_CACHE: dict[int, dict] = {}


def _span_table(df: pd.DataFrame) -> dict:
    """Per-log-frame lookup tables for trial/song/silence spans.

    The statistics-frame assembly resolves spans, ids and song metadata
    once per (trial × DV × resolution); each resolution used to pay 2-3
    full boolean row-masks of the log frame PER CALL
    (``get_task_start_end`` — profiled as the top stage-4 cost,
    tools/profile_s4.py).  One groupby pass replaces them all; the
    result is memoized in a module-level cache keyed by ``id(df)`` (a
    weakref finalizer evicts on frame death, so a recycled id can never
    serve another frame's table).  NOT stored on ``df.attrs``: pandas
    deep-copies non-empty ``attrs`` into every derived object — with
    the table attached, plain column accesses of a study-scale log
    frame cost ~60 s of ``copy.deepcopy`` per stage-4 build
    (tools/profile_s4.py).  Every curation op (``annotate_trial``,
    ``remove_song_entries`` …) returns a COPY — a new object id — so a
    curated frame always recomputes; a hit validates only the O(1)
    shape (the O(n) column fingerprints cost ~8 s/build at study
    scale).  In-place mutation of a frame already passed to a span
    consumer is outside the contract (frames are read-only once
    consumed — the input_cache contract).
    """
    cached = _SPAN_TABLE_CACHE.get(id(df))
    if (isinstance(cached, dict)
            and cached.get("shape") == (len(df), df.columns.size)):
        return cached

    def _col(name):
        if name in df.columns:
            return pd.Series(df[name].to_numpy(), copy=False)
        return pd.Series(np.full(len(df), np.nan))

    song, silence = _col('Song ID'), _col('Silence ID')
    trial, task = _col('Trial ID'), _col('Task Frequency')
    if 'Trial Exclusion Bool' in df.columns:
        excl = pd.Series(df['Trial Exclusion Bool'].fillna(False)
                         .to_numpy(dtype=bool))
    else:
        excl = pd.Series(np.zeros(len(df), dtype=bool))
    times = pd.Series(_times_of(df)).reset_index(drop=True)

    tbl: dict = {"shape": (len(df), df.columns.size)}

    def _spans(mask, ids):
        if not mask.any():
            return {}
        agg = (pd.DataFrame({"id": ids[mask].astype(np.int64).values,
                             "t": times[mask].reset_index(drop=True),
                             "e": excl[mask].values})
               .groupby("id").agg(tmin=("t", "min"), tmax=("t", "max"),
                                  e=("e", "any")))
        return {int(i): (tmin, tmax, bool(e))
                for i, tmin, tmax, e in zip(agg.index, agg["tmin"],
                                            agg["tmax"], agg["e"])}

    # song spans use only active-task rows (reference :604-714 filters
    # Task Frequency before the min/max); silence spans use all rows
    tbl["song_task"] = _spans(song.notna() & task.notna(), song)
    tbl["silence"] = _spans(silence.notna(), silence)

    mt = trial.notna()
    tbl["trial_map"] = {}
    if mt.any():
        first = (pd.DataFrame({"tr": trial[mt].astype(np.int64).values,
                               "song": song[mt].values,
                               "sil": silence[mt].values})
                 .groupby("tr").first())
        tbl["trial_map"] = {
            int(i): (int(s) if pd.notna(s) else None,
                     int(q) if pd.notna(q) else None)
            for i, s, q in zip(first.index, first["song"], first["sil"])}

    tbl["song_info"] = {}
    if 'Song Title' in df.columns and 'Song Artist' in df.columns:
        msong = song.notna()
        if msong.any():
            info = (pd.DataFrame({"id": song[msong].astype(np.int64)
                                  .values,
                                  "title": _col('Song Title')[msong]
                                  .values,
                                  "artist": _col('Song Artist')[msong]
                                  .values})
                    .groupby("id").first())
            tbl["song_info"] = {int(i): (t, a)
                                for i, t, a in zip(info.index,
                                                   info["title"],
                                                   info["artist"])}
    key = id(df)
    if key not in _SPAN_TABLE_CACHE:
        # evict on frame death so a recycled id can't alias; token
        # alone could collide on an identically-shaped successor
        weakref.finalize(df, _SPAN_TABLE_CACHE.pop, key, None)
    _SPAN_TABLE_CACHE[key] = tbl
    return tbl


def turn_trial_id_into_song_or_silence_id(log_df: pd.DataFrame,
                                          trial_id: int):
    """(song_id, silence_id) for a trial — one of them is None."""
    if not pd.isna(trial_id):
        pair = _span_table(log_df)["trial_map"].get(int(trial_id))
        if pair is not None:
            return pair
    subset = log_df.loc[log_df['Trial ID'] == trial_id]
    song_id = subset.iloc[0]['Song ID']
    silence_id = subset.iloc[0]['Silence ID']
    return (int(song_id) if not pd.isna(song_id) else None,
            int(silence_id) if not pd.isna(silence_id) else None)


def turn_song_or_silence_id_into_trial_id(log_df: pd.DataFrame,
                                          song_id: int | None = None,
                                          silence_id: int | None = None
                                          ) -> int:
    if song_id is not None:
        subset = log_df.loc[log_df['Song ID'] == song_id]
    elif silence_id is not None:
        subset = log_df.loc[log_df['Silence ID'] == silence_id]
    else:
        raise ValueError("Either song_id or silence_id must be provided")
    if len(subset) == 0:
        raise ValueError(
            f"No trial found with song_id={song_id} or "
            f"silence_id={silence_id}")
    return int(subset.iloc[0]['Trial ID'])


def _times_of(subset_df: pd.DataFrame) -> pd.DatetimeIndex:
    if isinstance(subset_df.index, pd.DatetimeIndex):
        return subset_df.index
    if 'Time' in subset_df.columns:
        return pd.DatetimeIndex(pd.to_datetime(subset_df['Time']))
    raise ValueError('df must contain "Time" column or DatetimeIndex!')


def get_song_start_end(df: pd.DataFrame, song_id: int | None = None,
                       song_title: str | None = None,
                       verbose: bool = False):
    """First/last timestamp of one song sequence (reference :548-601)."""
    if song_id is None and song_title is None:
        raise ValueError("Either song_id or song_title must be specified")
    if song_id is not None:
        subset = df.loc[df['Song ID'] == song_id]
    else:
        subset = df.loc[df['Song Title'] == song_title]
        unique_ids = subset['Song ID'].dropna().unique().astype(int)
        if len(unique_ids) > 1:
            raise ValueError(
                f"Song title appeared multiple times with Song IDs: "
                f"{unique_ids.tolist()}\nChoose one and call this method "
                f"with song_id!")
    if subset['Song Skipped'].any() and verbose:
        print(f"[INFO] Song {song_id} got skipped, no corresponding task "
              f"was executed.")
    if len(subset) == 0:
        raise ValueError("Specific song not found!")
    times = _times_of(subset)
    return times.min(), times.max()


def get_task_start_end(df: pd.DataFrame, song_id: int | None = None,
                       song_title: str | None = None,
                       trial_id: int | None = None,
                       silence_id: int | None = None,
                       assumed_latency_sec: float = 3.25,
                       cut_off_sec_to_prevent_transients: float = 2.0,
                       verbose: bool = False):
    """Start/end of one motor-task window (reference :604-714).

    Start is the first row with an active Task Frequency plus the assumed
    GUI→window latency (3.25 s); end has the end-transient cutoff (2 s)
    subtracted.  Raises ValueError for missing / excluded tasks.
    """
    if (song_id is None and song_title is None and silence_id is None
            and trial_id is None):
        raise ValueError(
            "Either song_id, song_title, trial_id or silence_id must be "
            "specified")
    if trial_id is not None:
        song_id, silence_id = turn_trial_id_into_song_or_silence_id(
            df, trial_id)

    if song_title is None and not verbose:
        # memoized span-table fast path (identical raise semantics to
        # the mask path below; verbose/song_title stay on the slow path
        # for the per-row INFO prints and title-ambiguity checks)
        tbl = _span_table(df)
        span = (tbl["song_task"].get(int(song_id))
                if song_id is not None
                else tbl["silence"].get(int(silence_id)))
        if span is None:
            raise ValueError("Specific task not found!")
        start, end, excluded = span
        if excluded:
            raise ValueError("Trial marked for exclusion!")
        if assumed_latency_sec > 0:
            start += pd.Timedelta(seconds=assumed_latency_sec)
            end += pd.Timedelta(seconds=assumed_latency_sec)
        if cut_off_sec_to_prevent_transients > 0:
            end -= pd.Timedelta(seconds=cut_off_sec_to_prevent_transients)
        return start, end

    if song_id is not None or song_title is not None:
        if song_id is not None:
            subset = df.loc[df['Song ID'] == song_id]
        else:
            subset = df.loc[df['Song Title'] == song_title]
            unique_ids = subset['Song ID'].dropna().unique().astype(int)
            if len(unique_ids) > 1:
                raise ValueError(
                    f"Song title appeared multiple times with Song IDs: "
                    f"{unique_ids.tolist()}\nChoose one and call this "
                    f"method with song_id!")
        if subset['Song Skipped'].any() and verbose:
            print(f"[INFO] Song {song_id} got skipped.")
        if subset['Trial Exclusion Bool'].any() and verbose:
            print(f"[INFO] Song {song_id} marked for exclusion!")
        subset = subset.loc[~subset['Task Frequency'].isna()]
    else:
        subset = df.loc[df['Silence ID'] == silence_id]
        if subset['Trial Exclusion Bool'].any() and verbose:
            print(f"[INFO] Silence trial {silence_id} marked for "
                  f"exclusion!")

    if len(subset) == 0:
        raise ValueError("Specific task not found!")
    if subset['Trial Exclusion Bool'].any():
        raise ValueError("Trial marked for exclusion!")

    times = _times_of(subset)
    start, end = times.min(), times.max()
    if assumed_latency_sec > 0:
        start += pd.Timedelta(seconds=assumed_latency_sec)
        end += pd.Timedelta(seconds=assumed_latency_sec)
    if cut_off_sec_to_prevent_transients > 0:
        end -= pd.Timedelta(seconds=cut_off_sec_to_prevent_transients)
    return start, end


def get_all_task_start_ends(enriched_log_df: pd.DataFrame,
                            output_type: Literal['dict', 'list'] = 'dict',
                            assumed_latency_sec: float = 3.25,
                            cut_off_sec_to_prevent_transients: float = 2.0):
    """Task windows for all valid trials (reference :717-763)."""
    out_dict: dict = {}
    out_list: list = []
    for trial in enriched_log_df['Trial ID'].unique():
        if pd.isna(trial):
            continue
        try:
            start, end = get_task_start_end(
                enriched_log_df, trial_id=trial,
                assumed_latency_sec=assumed_latency_sec,
                cut_off_sec_to_prevent_transients=
                cut_off_sec_to_prevent_transients)
            start = make_timezone_aware(start)
            end = make_timezone_aware(end)
        except ValueError:
            continue
        if output_type == 'dict':
            out_dict[int(trial)] = (start, end)
        else:
            out_list.append((start, end))
    return out_dict if output_type == 'dict' else out_list


def get_qtc_measurement_start_end(df: pd.DataFrame, verbose: bool = True,
                                  assumed_latency_sec: float = .75):
    """Recording span from Start/Stop Trigger events (reference :766-954).

    'Actual Start Trigger' (inserted during manual curation) overrides the
    start; missing triggers fall back to frame boundaries; outputs are UTC.
    """
    df = df.copy()
    if 'Event' not in df.columns:
        raise KeyError(
            "DataFrame must contain an 'Event' column with trigger "
            "information.")
    if not isinstance(df.index, pd.DatetimeIndex):
        if 'Time' not in df.columns:
            raise ValueError(
                'DataFrame must contain "Time" column or have a '
                'DatetimeIndex!')
        df['Time'] = pd.to_datetime(df['Time'])
        df = df.set_index('Time')

    def single_trigger(name: str):
        matches = df.loc[df['Event'] == name]
        if len(matches) > 1:
            raise ValueError(
                f"Found {len(matches)} '{name}' events. Expected exactly "
                f"one.")
        if len(matches) == 0:
            return None
        return matches.index.item()

    qtc_start = single_trigger("Start Trigger")
    if qtc_start is None:
        if verbose:
            print("No 'Start Trigger' event found, assuming measurement "
                  "started at beginning")
        qtc_start = df.index.min()
    elif assumed_latency_sec > 0:
        qtc_start += pd.Timedelta(seconds=assumed_latency_sec)

    qtc_end = single_trigger("Stop Trigger")
    if qtc_end is None:
        if verbose:
            print("No 'Stop Trigger' event found, assuming measurement ran "
                  "until end.")
        qtc_end = df.index.max()
    elif assumed_latency_sec > 0:
        qtc_end += pd.Timedelta(seconds=assumed_latency_sec)

    actual_start = single_trigger("Actual Start Trigger")
    if actual_start is not None:
        if verbose:
            print(f"Found 'Actual Start Trigger' event, indicating cut-off "
                  f"of initial measurements. Will return actual start "
                  f"timestamp: {actual_start}")
        qtc_start = actual_start

    qtc_start = (qtc_start.tz_localize('UTC') if qtc_start.tz is None
                 else qtc_start.tz_convert('UTC'))
    qtc_end = (qtc_end.tz_localize('UTC') if qtc_end.tz is None
               else qtc_end.tz_convert('UTC'))
    if verbose:
        print(f"EEG and EMG measurements last from {qtc_start} to "
              f"{qtc_end}!\n")
    return qtc_start, qtc_end


# ========================================================================
# validators & manual curation
# ========================================================================
def validate_force_measurements(log_df: pd.DataFrame,
                                serial_df: pd.DataFrame,
                                freeze_threshold_seconds: float = .2
                                ) -> None:
    """Flag per-trial force traces with frozen (constant) segments
    (reference :957-1013).

    Both time axes are made timezone-aware first (naive as UTC, as
    :func:`fetch_serial_measurements` reads the trace): the raw log's
    times are naive, and pandas ≥ 2 refuses to slice a UTC trace with
    them, which the JAX package does not guard (ROADMAP C11)."""
    if not isinstance(log_df.index, pd.DatetimeIndex):
        log_df = log_df.set_index('Time')
    if not isinstance(serial_df.index, pd.DatetimeIndex):
        serial_df = serial_df.set_index('Time')
    log_df = log_df.set_axis(make_timezone_aware(log_df.index))
    serial_df = serial_df.set_axis(make_timezone_aware(serial_df.index))

    for trial_id in log_df['Trial ID'].unique():
        if pd.isna(trial_id):
            continue
        song_id, silence_id = turn_trial_id_into_song_or_silence_id(
            log_df, trial_id)
        try:
            start, end = get_task_start_end(log_df, song_id=song_id,
                                            silence_id=silence_id)
        except ValueError:
            continue
        fsr = serial_df.loc[start:end, 'fsr']
        if len(fsr) == 0:
            continue
        rate = len(fsr) / (end - start).total_seconds()
        group = fsr.ne(fsr.shift()).cumsum()
        consecutive = fsr.groupby(group).cumcount() + 1
        is_frozen = consecutive >= freeze_threshold_seconds * rate
        label = (f'song_{int(song_id):03}' if song_id is not None
                 else f'silence_{int(silence_id):03}')
        if is_frozen.any():
            print(f"[WARNING] Frozen force measurements (for more than "
                  f"{freeze_threshold_seconds}sec) found for {label}.")
        else:
            print(f"Maximum duration of consecutive measurements for trial "
                  f"ID {int(trial_id)} ({label}): "
                  f"{consecutive.max() / rate:.2f}sec")


def validate_song_indices(df: pd.DataFrame, experiment_data_dir,
                          error_handling: Literal['raise', 'continue']
                          = 'continue',
                          verbose: bool = True) -> dict:
    """Check log Song Title/Artist against stored song-info JSONs
    (reference :1016-1172)."""
    report = {'valid': True, 'matches': [], 'mismatches': [],
              'duplicate_entries': [], 'missing_metadata': [], 'summary': {}}
    experiment_data_dir = Path(experiment_data_dir)
    grouped = df.groupby('Song ID')
    for song_id, group in grouped:
        song_id = int(song_id)
        titles = group['Song Title'].unique()
        artists = group['Song Artist'].unique()
        if len(titles) > 1 or len(artists) > 1:
            report['valid'] = False
            report['duplicate_entries'].append({
                'Song ID': song_id, 'Unique Titles': list(titles),
                'Unique Artists': list(artists),
                'Number of Log Entries': len(group),
                'Issue': 'Multiple conflicting Title/Artist values for '
                         'same Song ID'})
            continue
        meta = fetch_song_information(experiment_data_dir, song_id=song_id,
                                      error_handling=error_handling)
        if meta is None:
            report['valid'] = False
            report['missing_metadata'].append({
                'Song ID': song_id, 'Song Title': titles[0],
                'Song Artist': artists[0],
                'Number of Log Entries': len(group),
                'Status': 'Could not fetch metadata'})
            continue
        title_match = meta.get('Title', '') == titles[0]
        artist_match = meta.get('Artist', '') == artists[0]
        if title_match and artist_match:
            report['matches'].append({
                'Song ID': song_id, 'Song Title': titles[0],
                'Song Artist': artists[0],
                'Number of Log Entries': len(group), 'Status': 'Valid',
                'Metadata': {k: meta.get(k) for k in
                             ('Album', 'Genre', 'Duration [ms]', 'BPM')}})
        else:
            report['valid'] = False
            report['mismatches'].append({
                'Song ID': song_id, 'Number of Log Entries': len(group),
                'Log Frame Title': titles[0],
                'Metadata Title': meta.get('Title', ''),
                'Title Match': title_match,
                'Log Frame Artist': artists[0],
                'Metadata Artist': meta.get('Artist', ''),
                'Artist Match': artist_match})
    report['summary'] = {
        'total_log_entries': len(df), 'unique_song_ids': len(grouped),
        'valid_matches': len(report['matches']),
        'mismatches': len(report['mismatches']),
        'duplicate_entries': len(report['duplicate_entries']),
        'missing_metadata': len(report['missing_metadata']),
        'validation_passed': report['valid']}
    if verbose:
        for key, msg in [('duplicate_entries', 'duplicate entries'),
                         ('missing_metadata', 'missing metadata'),
                         ('mismatches', 'mismatching information')]:
            if report[key]:
                print(f"[WARNING] Found {len(report[key])} {msg}:")
                print(report[key], "\n")
        if report['valid']:
            print("Validation passed!\n")
    return report


def _compare_questionnaire(group: pd.DataFrame, data: dict) -> list[dict]:
    mismatches = []
    for field, q_value in data.items():
        if field not in group.columns:
            continue
        log_values = group[field].unique()
        if len(log_values) != 1 or log_values[0] != q_value:
            mismatches.append({
                'Field': field, 'Questionnaire Value': q_value,
                'Log Frame Values': list(log_values),
                'Match': (log_values[0] == q_value
                          if len(log_values) == 1 else False)})
    return mismatches


def validate_trial_questionnaires(df: pd.DataFrame, experiment_data_dir,
                                  error_handling: Literal['raise',
                                                          'continue']
                                  = 'continue',
                                  verbose: bool = True) -> dict:
    """Check questionnaire-derived log columns against stored JSONs
    (reference :1175-1396)."""
    report = {'valid': True, 'song_matches': [], 'silence_matches': [],
              'mismatches': [], 'missing_questionnaires': [], 'summary': {}}
    experiment_data_dir = Path(experiment_data_dir)

    for kind, id_col in (('Song', 'Song ID'), ('Silence', 'Silence ID')):
        if id_col not in df.columns:
            continue
        sub_df = df[df[id_col].notna()]
        if sub_df.empty:
            continue
        for trial_key, group in sub_df.groupby(id_col):
            trial_key = int(trial_key)
            data = fetch_trial_questionnaire(
                experiment_data_dir,
                song_id=trial_key if kind == 'Song' else None,
                silence_id=trial_key if kind == 'Silence' else None,
                error_handling=error_handling)
            if not data:
                report['valid'] = False
                report['missing_questionnaires'].append({
                    'Trial ID': trial_key, 'Trial Type': kind,
                    'Number of Log Entries': len(group),
                    'Status': 'Could not fetch questionnaire data'})
                continue
            mismatches = _compare_questionnaire(group, data)
            if mismatches:
                report['valid'] = False
                report['mismatches'].append({
                    f'{kind} ID': trial_key, 'Trial Type': kind,
                    'Number of Log Entries': len(group),
                    'Mismatches': mismatches, 'Questionnaire Data': data})
            else:
                report[f'{kind.lower()}_matches'].append({
                    f'{kind} ID': trial_key,
                    'Number of Log Entries': len(group),
                    'Status': 'Valid', 'Questionnaire Data': data})

    report['summary'] = {
        'total_log_entries': len(df),
        'valid_song_matches': len(report['song_matches']),
        'valid_silence_matches': len(report['silence_matches']),
        'mismatches': len(report['mismatches']),
        'missing_questionnaires': len(report['missing_questionnaires']),
        'validation_passed': report['valid']}
    if verbose:
        if report['missing_questionnaires']:
            print(f"[WARNING] Couldn't find any questionnaires for "
                  f"{len(report['missing_questionnaires'])} trial(s).")
        if report['mismatches']:
            print(f"[WARNING] Found {len(report['mismatches'])} trial(s) "
                  f"with questionnaire mismatches.")
        print("✓ Validation passed!\n" if report['valid']
              else "✗ Validation failed!\n")
    return report


def repair_trial_questionnaire_mismatches(df: pd.DataFrame,
                                          questionnaire_validation_report:
                                          dict) -> pd.DataFrame:
    """Patch mismatching fields from the validation report (ref :1399)."""
    df = df.copy()
    for mm in questionnaire_validation_report['mismatches']:
        song_id = mm.get('Song ID') if mm['Trial Type'] == 'Song' else None
        silence_id = (mm.get('Silence ID')
                      if mm['Trial Type'] == 'Silence' else None)
        label = (f'song_{song_id:03}' if song_id is not None
                 else f'silence_{silence_id}')
        print(f"Correcting {label} mismatch:")
        for entry in mm['Mismatches']:
            field, true_value = entry['Field'], entry['Questionnaire Value']
            print(f"\t-> Will replace logframe '{field}' with {true_value} "
                  f"from stored questionnaire jsons.")
            if song_id is not None:
                df.loc[df['Song ID'] == song_id, field] = true_value
            else:
                df.loc[df['Silence ID'] == silence_id, field] = true_value
    return df


def remove_silence_trial(enriched_log: pd.DataFrame, log: pd.DataFrame,
                         silence_ids: list[int]) -> pd.DataFrame:
    """Clear Questionnaire entries of silence trials so re-enrichment
    drops them (reference :1437-1453)."""
    log = log.copy()
    if isinstance(enriched_log.index, pd.DatetimeIndex):
        enriched_log = enriched_log.reset_index()
    for silence_id in silence_ids:
        sel = enriched_log['Silence ID'] == silence_id
        if len(log.loc[sel, :]) == 0:
            print(f"No entries found for silence ID {silence_id}")
            continue
        log.loc[sel, 'Questionnaire'] = np.nan
        print(f"Removed task information for silence trial with ID "
              f"{silence_id}")
    return log


def remove_song_entries(enriched_log: pd.DataFrame, log: pd.DataFrame,
                        song_title_artist_id_tuples: list[tuple],
                        include_questionnaire_entries: bool = True
                        ) -> pd.DataFrame:
    """Blank wrongly-executed songs from the raw log (reference :1457)."""
    log = log.copy()
    if isinstance(enriched_log.index, pd.DatetimeIndex):
        enriched_log = enriched_log.reset_index()
    for title, artist, sid in song_title_artist_id_tuples:
        sel = ((enriched_log['Song Title'] == title)
               & (enriched_log['Song Artist'] == artist)
               & (enriched_log['Song ID'] == sid))
        if len(log.loc[sel, :]) == 0:
            print(f"No entries found for '{title}' by '{artist}'.")
            continue
        log.loc[sel, "Music"] = "No track playing currently."
        print(f"Removed music information for {title} and {artist}.")
        if include_questionnaire_entries:
            log.loc[sel, "Questionnaire"] = np.nan
            print(f"Removed also all questionnaire information for "
                  f"{title}.")
    return log


def remove_single_row_by_timestamp(log_frame: pd.DataFrame,
                                   timestamp) -> pd.DataFrame:
    """Drop one flawed row by timestamp (reference :1480-1487)."""
    log_frame = log_frame.copy()
    sel = log_frame['Time'] == timestamp
    if sel.any():
        print(f"Removing row with timestamp '{timestamp}' from log "
              f"frame.\n")
    return log_frame.drop(log_frame[sel].index)


def annotate_trial(log_df, comment: str, exclude: bool,
                   song_id: int | None = None,
                   silence_id: int | None = None,
                   trial_id: int | None = None):
    """Attach comment + exclusion flag to one trial (reference :1491)."""
    log_df = log_df.copy()
    if trial_id is None:
        trial_id = turn_song_or_silence_id_into_trial_id(log_df, song_id,
                                                         silence_id)
    log_df.loc[log_df['Trial ID'] == trial_id, 'Trial Comment'] = comment
    log_df.loc[log_df['Trial ID'] == trial_id,
               'Trial Exclusion Bool'] = exclude
    print(f"{'Marked trial ' + str(trial_id) + ' for exclusion due to'
          if exclude else 'Commented trial ' + str(trial_id) + ' with'} "
          f"'{comment}'.")
    return log_df


def fetch_excluded_trials(enriched_log_df: pd.DataFrame) -> list[int]:
    """Trial IDs marked for exclusion (reference :1888-1907)."""
    out: list[int] = []
    if enriched_log_df['Trial Exclusion Bool'].any():
        for trial_id in range(int(enriched_log_df['Trial ID'].max()) + 1):
            if enriched_log_df.loc[enriched_log_df['Trial ID'] == trial_id,
                                   'Trial Exclusion Bool'].any():
                out.append(int(trial_id))
    return out


def fetch_skipped_trials(enriched_log_df: pd.DataFrame) -> list[int]:
    """Trial IDs flagged as skipped (reference :1910-1929)."""
    out: list[int] = []
    if enriched_log_df['Song Skipped'].any():
        for trial_id in range(int(enriched_log_df['Trial ID'].max()) + 1):
            if enriched_log_df.loc[enriched_log_df['Trial ID'] == trial_id,
                                   'Song Skipped'].any():
                out.append(trial_id)
    return out


# ========================================================================
# artifact-store loaders
# ========================================================================
def fetch_serial_measurements(subject_data_dir: Path,
                              load_only_first_n_seconds: int | None = None,
                              set_time_index: bool = True) -> pd.DataFrame:
    """Concatenate Interim WorkMem + Final (or Redundant) serial saves
    (reference :1532-1666)."""
    measurements_dir = Path(subject_data_dir) / 'serial_measurements'

    def load(path: Path) -> pd.DataFrame:
        df = pd.read_csv(path)
        unnamed = [c for c in df.columns if str(c).startswith('Unnamed')]
        if 'Time' in df.columns:
            # named Time column present: unnamed cols are index artifacts
            df = df.drop(columns=unnamed)
            df['Time'] = pd.to_datetime(df['Time'])
            df = df[['Time'] + [c for c in df.columns if c != 'Time']]
        elif unnamed:
            time_col = unnamed[-1]
            df[time_col] = pd.to_datetime(df[time_col])
            df = df.drop(columns=[c for c in unnamed if c != time_col])
            df = df.rename(columns={time_col: 'Time'})
        return df

    def clip(df: pd.DataFrame, n_seconds: int) -> pd.DataFrame:
        first = df.columns[0]
        return df[df[first] <= df[first].min()
                  + pd.Timedelta(seconds=n_seconds)]

    try:
        interim_paths = filemgmt.most_recent_file(
            measurements_dir, ".csv", ["Interim Save WorkMem Full"],
            return_type='dict')['files']
        interim_frames = [load(p) for p in interim_paths]
        print(f"Found {len(interim_frames)} working-memory-full "
              f"measurements in {measurements_dir}. Will concatenate with "
              f"final save.")
    except ValueError:
        interim_frames = []

    final_frame = None
    if load_only_first_n_seconds is not None and interim_frames:
        interim_frames = [clip(df, load_only_first_n_seconds)
                          for df in interim_frames]
        first_col = interim_frames[0].columns[0]
        total = (interim_frames[-1][first_col].max()
                 - interim_frames[0][first_col].min()).total_seconds()
        if total >= load_only_first_n_seconds:
            print(f"Interim saves cover {total:.1f}s (requested: "
                  f"{load_only_first_n_seconds}s). Skipping final save.")
            final_frame = pd.DataFrame()

    if final_frame is None:
        try:
            final_frame = load(filemgmt.most_recent_file(
                measurements_dir, ".csv", ["Final Save"]))
        except ValueError:
            print(f"No 'Final Save' measurement file found in "
                  f"{measurements_dir}\nWill utilize last 'Redundant "
                  f"Save', leading to potential data loss...")
            final_frame = load(filemgmt.most_recent_file(
                measurements_dir, ".csv", ["Redundant Save"]))
        if load_only_first_n_seconds is not None:
            final_frame = clip(final_frame, load_only_first_n_seconds)

    frames = interim_frames + ([final_frame] if len(final_frame) else [])
    if not frames:
        raise ValueError("No data loaded after applying filters!")
    result = pd.concat(frames, ignore_index=True)
    first = result.columns[0]
    result = (result.sort_values(by=first, ascending=True)
              .drop_duplicates(subset=[first], keep='first')
              .reset_index(drop=True))
    if set_time_index:
        result = result.set_index("Time")
        result.index = make_timezone_aware(result.index)
    return result


def fetch_trial_dir(experiment_data_dir, song_id: int | None = None,
                    silence_id: int | None = None,
                    trial_id: int | None = None,
                    log_df: pd.DataFrame | None = None) -> Path:
    """Resolve the per-trial artifact directory (reference :1669-1688)."""
    if song_id is None and silence_id is None and trial_id is None:
        raise ValueError(
            "Either song_id, silence_id or trial_id must be specified to "
            "derive respective trial!")
    if trial_id is not None:
        if log_df is None:
            raise ValueError(
                "log_df must be specified if trial_id is not None")
        song_id, silence_id = turn_trial_id_into_song_or_silence_id(
            log_df, trial_id)
    name = (f"song_{song_id:03}" if song_id is not None
            else f"silence_{silence_id:03}")
    trial_dir = Path(experiment_data_dir) / name
    if trial_dir.is_dir():
        return trial_dir
    raise FileNotFoundError(f"Trial directory {trial_dir} not found.")


def fetch_trial_questionnaire(experiment_data_dir,
                              song_id: int | None = None,
                              silence_id: int | None = None,
                              error_handling: Literal['raise', 'continue']
                              = 'continue',
                              verbose: bool = False) -> dict:
    """Familiarity + post-trial rating JSONs (reference :1691-1728)."""
    try:
        trial_dir = fetch_trial_dir(experiment_data_dir, song_id,
                                    silence_id)
    except FileNotFoundError:
        if error_handling == 'raise':
            raise
        return {}
    out: dict = {}
    if song_id is not None:
        try:
            path = filemgmt.most_recent_file(trial_dir, ".json",
                                             ["Familiarity Check"])
            with open(path, "r") as f:
                out.update(json.load(f))
        except ValueError:
            msg = (f"Couldn't find familiarity questionnaire for "
                   f"song_{song_id:03}.")
            if error_handling == 'raise':
                raise ValueError(msg)
            if verbose:
                print(msg)
            return out
    try:
        path = filemgmt.most_recent_file(trial_dir, ".json",
                                         ["Post-Trial Rating"])
        with open(path, "r") as f:
            out.update(json.load(f))
    except ValueError:
        msg = ("Couldn't find post-trial questionnaire for "
               + (f'song_{song_id:03}' if song_id is not None
                  else f'silence_{silence_id:03}') + ".")
        if error_handling == 'raise':
            raise ValueError(msg)
        if verbose:
            print(msg)
    return out


def fetch_trial_accuracy(experiment_data_dir, song_id: int | None = None,
                         silence_id: int | None = None,
                         log_df: pd.DataFrame | None = None,
                         trial_id: int | None = None,
                         error_handling: Literal['raise', 'continue']
                         = 'continue',
                         verbose: bool = False):
    """Per-sample trial accuracy vector (reference :1731-1776)."""
    try:
        trial_dir = fetch_trial_dir(experiment_data_dir, song_id,
                                    silence_id, trial_id, log_df)
        path = filemgmt.most_recent_file(trial_dir, ".csv",
                                         ["Trial Accuracy Results"])
        return pd.read_csv(path).iloc[:, -1].to_numpy()
    except (ValueError, FileNotFoundError):
        msg = ("Couldn't find accuracy results for "
               + (f'song_{song_id:03}' if song_id is not None
                  else f'silence_{silence_id:03}') + ".")
        if error_handling == 'raise':
            raise ValueError(msg)
        if verbose:
            print(msg)
        return None


def fetch_all_accuracies_and_questionnaires(experiment_data_dir,
                                            max_song_ind: int,
                                            max_silence_ind: int,
                                            verbose: bool = False):
    """All accuracy arrays + questionnaire dicts (reference :1779-1804)."""
    acc = {f"song_{i:03}": fetch_trial_accuracy(
        experiment_data_dir, song_id=i, error_handling='continue')
        for i in range(max_song_ind)}
    acc.update({f"silence_{i:03}": fetch_trial_accuracy(
        experiment_data_dir, silence_id=i, error_handling='continue',
        verbose=verbose) for i in range(max_silence_ind)})
    quest = {f"song_{i:03}": fetch_trial_questionnaire(
        experiment_data_dir, song_id=i, error_handling='continue')
        for i in range(max_song_ind)}
    quest.update({f"silence_{i:03}": fetch_trial_questionnaire(
        experiment_data_dir, silence_id=i, verbose=verbose,
        error_handling='continue') for i in range(max_silence_ind)})
    return acc, quest


def fetch_song_information(experiment_data_dir, song_id: int | None = None,
                           error_handling: Literal['raise', 'continue']
                           = 'continue'):
    """Stored song metadata JSON (reference :1807-1843)."""
    try:
        trial_dir = fetch_trial_dir(experiment_data_dir, song_id,
                                    silence_id=None)
        path = filemgmt.most_recent_file(trial_dir, ".json",
                                         ["song", "information"])
        with open(path, "r") as f:
            return json.load(f)
    except (ValueError, FileNotFoundError):
        msg = f"Couldn't find song information for song_{song_id:03}!"
        if error_handling == 'raise':
            raise ValueError(msg)
        print(msg)
        return None


def fetch_onboarding_questionnaire(experiment_data_dir) -> dict:
    path = filemgmt.most_recent_file(experiment_data_dir, ".json",
                                     ["Subject", "Data"])
    with open(path, "r") as f:
        return json.load(f)


def fetch_offboarding_questionnaire(experiment_data_dir) -> dict:
    path = filemgmt.most_recent_file(experiment_data_dir, ".json",
                                     ["Post-Study Feedback Data"])
    with open(path, "r") as f:
        return json.load(f)


def fetch_personal_data(experiment_data_dir,
                        include_name_and_birthdate: bool = False) -> dict:
    """Onboarding + offboarding traits with ordinal listening-habit
    encoding (reference :1975-2003)."""
    data = fetch_onboarding_questionnaire(experiment_data_dir)
    if not include_name_and_birthdate:
        data.pop("Name", None)
        data.pop("Birthdate", None)
    data.update(fetch_offboarding_questionnaire(experiment_data_dir))
    data.setdefault("Musical skill", 0)
    mapping = {'Most of the day': 3, 'A small part of the day': 2,
               'Every 2 or 3 days': 1, 'Seldom': 0}
    data['Listening habit [0-3]'] = mapping[data['Listening habit']]
    return data


def fetch_enriched_serial_frame(experiment_data_dir,
                                set_time_index: bool = True
                                ) -> pd.DataFrame:
    """Latest 'Enriched Serial Frame' CSV (reference :1932-1972)."""
    serial_dir = Path(experiment_data_dir) / "serial_measurements"
    try:
        path = filemgmt.most_recent_file(serial_dir, ".csv",
                                         ["Enriched Serial Frame"])
        frame = pd.read_csv(path)
        if set_time_index:
            frame['Time'] = pd.to_datetime(frame['Time'], format='ISO8601')
            frame = frame.set_index("Time")
    except ValueError:
        raise ValueError(
            f"Couldn't find enriched (integrated) serial frame with "
            f"signature 'Enriched Serial Frame' in {serial_dir}...\n"
            f"Please run the feature-extraction workflow first.")
    return frame


def fetch_enriched_log_frame(experiment_data_dir,
                             set_time_index: bool = True,
                             verbose: bool = True) -> pd.DataFrame:
    """Latest 'Enriched Experiment Log' CSV with summary report
    (reference :2006-2089)."""
    log_dir = Path(experiment_data_dir) / "experiment_logs"
    try:
        path = filemgmt.most_recent_file(log_dir, ".csv",
                                         ["Enriched Experiment Log"])
        frame = pd.read_csv(path)
        if set_time_index:
            frame['Time'] = pd.to_datetime(frame['Time'])
            frame = frame.set_index("Time")
            frame.index = make_timezone_aware(frame.index)
    except ValueError:
        raise ValueError(
            f"Couldn't find enriched (integrated) experiment log frame "
            f"with signature 'Enriched Experiment Log' in {log_dir}...\n"
            f"Please run the data-integration workflow first.")

    if verbose:
        print(f"Imported enriched log frame from {experiment_data_dir}:\n")
        qtc_start, qtc_end = get_qtc_measurement_start_end(frame, False)
        print(f"- Duration of EEG/EMG measurements: "
              f"{(qtc_end - qtc_start).total_seconds():.2f} seconds")
        print(f"- Number of trials {int(frame['Trial ID'].max() + 1)} "
              f"({int(frame['Song ID'].max() + 1)} music, "
              f"{int(frame['Silence ID'].max() + 1)} silence)")
        excluded = fetch_excluded_trials(frame)
        if excluded:
            print(f"- Thereof {len(excluded)} trial(s) marked for "
                  f"exclusion: {excluded}")
        skipped = fetch_skipped_trials(frame)
        if skipped:
            print(f"- Thereof {len(skipped)} trial(s) skipped: {skipped}")
    return frame


def fetch_music_features(log_df: pd.DataFrame,
                         music_lookup_table_path=None,
                         song_id: int | None = None,
                         trial_id: int | None = None,
                         features_to_return: tuple = (
                             'BPM_manual', 'Spectral Flux Mean',
                             'Spectral Centroid Mean', 'IOI Variance Coeff',
                             'Syncopation Ratio')) -> list[float]:
    """Song-level music features from the lookup table (ref :2092-2154).

    ``music_lookup_table_path`` may also be a pre-read lookup
    ``DataFrame`` — callers resolving features for many trials (the
    statistics-frame builder) read the CSV once instead of per call.
    """
    if isinstance(music_lookup_table_path, pd.DataFrame):
        lookup = music_lookup_table_path
    else:
        if music_lookup_table_path is None:
            lookup_dir = (Path().resolve().parent / "data"
                          / "song_characteristics")
            music_lookup_table_path = filemgmt.most_recent_file(
                lookup_dir, ".csv", ["Lookup Table"])
        lookup = pd.read_csv(music_lookup_table_path)

    if song_id is None and trial_id is None:
        raise ValueError("Must provide either song or trial ID")
    if song_id is None:
        song_id, _silence = turn_trial_id_into_song_or_silence_id(
            log_df, trial_id)
    if song_id is None:
        return [np.nan] * len(features_to_return)

    info = _span_table(log_df)["song_info"].get(int(song_id))
    if info is None:
        raise ValueError(
            f"Couldn't find song_id {song_id} in log_frame table...")
    title, artist = info
    row = lookup.loc[(lookup['Artist'] == artist)
                     & (lookup['Title'] == title), :]
    if len(row) == 0:
        raise ValueError(f"Song {title} not found in lookup table")
    if len(row) > 1:
        raise ValueError(
            f"Song {title} found multiple times in lookup table. Needs to "
            f"be unique.")
    return [row[feat].item() for feat in features_to_return]
