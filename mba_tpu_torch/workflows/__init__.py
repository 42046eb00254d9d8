"""Stage workflows of the port (``mba_tpu/workflows``), one slice at a
time: the per-subject feature extraction's PSD and CMC entry points."""
