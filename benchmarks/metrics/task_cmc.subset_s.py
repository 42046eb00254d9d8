"""task_cmc.subset_s: the task-wise CMC's host copy of its EEG channel
subset, the program's ``task_cmc.subset`` span, mean per call; None
where a call has no such record (a program without the span)."""
from benchmarks.metrics._program import mean_seconds, records

NAME = "task_cmc.subset"


def read(run):
    recs = records(run)
    if recs is None or any(all(r[0] != NAME for r in c) for c in recs):
        return None
    return mean_seconds(run, NAME)
