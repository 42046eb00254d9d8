"""setup_s: seconds from the start of the process to the first
timed call (imports, the card, the kernel library, the inputs from the
seed, one warm call; in a fresh checkout the kernel build too)."""


def read(run):
    return run["setup_s"]
