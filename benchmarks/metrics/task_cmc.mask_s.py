"""task_cmc.mask_s: the task-wise CMC's window mask, built on the host
from the experiment log's frame, the program's ``task_cmc.mask`` span,
mean per call; None where a call has no such record (a program without
the span)."""
from benchmarks.metrics._program import mean_seconds, records

NAME = "task_cmc.mask"


def read(run):
    recs = records(run)
    if recs is None or any(all(r[0] != NAME for r in c) for c in recs):
        return None
    return mean_seconds(run, NAME)
