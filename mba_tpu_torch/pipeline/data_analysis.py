"""Host helpers of ``mba_tpu/pipeline/data_analysis.py`` (pandas).

Holds only what the feature-extraction slice needs:
:func:`make_timezone_aware` (``data_analysis.py:429``), copied because
the port never imports ``mba_tpu``.  The rest of the module comes with
the statistics slice (ROADMAP A8).
"""
from __future__ import annotations

import pandas as pd


def make_timezone_aware(dt_index, timezone: str = 'utc'):
    """Localize naive datetimes; aware inputs pass through unchanged."""
    timezone = timezone.lower()
    if isinstance(dt_index, pd.DatetimeIndex):
        return dt_index if dt_index.tz is not None \
            else dt_index.tz_localize(timezone)
    if isinstance(dt_index, pd.Series):
        if not isinstance(dt_index.index, pd.DatetimeIndex):
            raise TypeError(
                f"Series must have a DatetimeIndex, got "
                f"{type(dt_index.index)}")
        if dt_index.index.tz is not None:
            return dt_index
        result = dt_index.copy()
        result.index = result.index.tz_localize(timezone)
        return result
    if isinstance(dt_index, pd.Timestamp):
        return dt_index if dt_index.tz is not None \
            else dt_index.tz_localize(timezone)
    raise TypeError(
        f"dt_index must be pd.DatetimeIndex, pd.Series, or pd.Timestamp, "
        f"got {type(dt_index)}")
