"""Constants of ``mba_tpu/pipeline/cbpa.py`` (:43-51).

Holds only what the feature-extraction slice needs: the EEG sampling
rate and the 11-channel motor subset of the task-wise CMC.  The
cluster-based permutation analysis itself comes with ROADMAP A9.
"""
from __future__ import annotations

EEG_SFREQ: float = 2048.0

# 11 left-hemisphere motor channels (mirrored for left-handers)
CMC_EEG_CHANNEL_SUBSET: list[str] = [
    "C5", "C3", "C1",
    "FC5", "FC3", "FC1", "F3",
    "CP5", "CP3", "CP1", "P3",
]
CMC_CHANNEL_FILE_SUFFIX: str = f"Channels_{'_'.join(CMC_EEG_CHANNEL_SUBSET)}"
