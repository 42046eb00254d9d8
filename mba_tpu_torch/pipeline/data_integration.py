"""Experiment-log time spans (port of part of
``mba_tpu/pipeline/data_integration.py``).

Holds only what the feature-extraction slice needs to turn an enriched
experiment log into task windows: the memoized span table
(``_span_table``, :316), the trial-id algebra (:412-441), ``_times_of``
(:443), ``get_task_start_end`` (:476), ``get_all_task_start_ends``
(:555) and ``get_qtc_measurement_start_end`` (:582), copied because the
port never imports ``mba_tpu``.  The log parsing, validators, curation
ops and loaders come with the preprocessing and workflow slices
(ROADMAP A7, A10).  Everything here is host-side pandas.
"""
from __future__ import annotations

import weakref
from typing import Literal

import numpy as np
import pandas as pd

from mba_tpu_torch.pipeline.data_analysis import make_timezone_aware

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
