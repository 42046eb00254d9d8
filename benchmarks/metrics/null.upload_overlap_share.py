"""null.upload_overlap_share: how much of the null's uploads the card
spends computing, 100 × the kernel and memset time of the traced calls
that falls inside the program's ``null.upload`` spans (placed on each
call's clock by its return) over those spans' length, in %."""
from benchmarks.metrics._program import kernel_share


def read(run):
    return kernel_share(run, "null.upload")
