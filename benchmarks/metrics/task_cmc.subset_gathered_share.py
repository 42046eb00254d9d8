"""task_cmc.subset_gathered_share: the share of the task-wise CMC's EEG
subset that the staging ring gathered from the caller's array on its way
to the card, 100 × the program's counters ``upload.gathered_bytes`` /
``upload.subset_bytes``, in %; None where a call lacks them (a program
that copies the subset on the host first, or counts no gather: the
CPU)."""
from benchmarks.metrics._program import share


def read(run):
    return share(run, "upload.gathered_bytes", "upload.subset_bytes")
