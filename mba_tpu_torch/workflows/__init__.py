"""Stage workflows of the port (``mba_tpu/workflows``), one slice at a
time: the per-subject feature extraction's PSD and CMC entry points, the
preprocessing workflow, and the statistics workflows (RQ-A and RQ-B
omnibus, RQ-A mediation) with the study paths their scripts use."""
