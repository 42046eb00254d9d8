"""OTB4 import: 3×64-channel exports per subject.

Parity target: reference ``src/otb4_import_workflow.py`` (41 LoC):
eeg / emg_1_flexor / emg_2_extensor channel ranges via
``import_otb4_to_csv`` (:19-42; subject-0 grid swap at :12-17).  Also
saves npy copies so the preprocessing workflow can memory-map them.

A host copy of ``mba_tpu/workflows/otb4_import_workflow.py`` (the port
never imports ``mba_tpu``).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from mba_tpu_torch.io.otb4 import import_otb4_to_csv
from mba_tpu_torch.utils import file_management as filemgmt


def import_subject(otb4_path: Path, feature_dir: Path, subject: int,
                   swap_emg_grids: bool = False) -> None:
    """Export the three 64-channel blocks from one OTB4 recording.

    ``swap_emg_grids`` mirrors the reference's subject-0 amendment
    (flexor/extensor grids were plugged in swapped).
    """
    feature_dir = Path(feature_dir)
    filemgmt.assert_dir(feature_dir)
    ranges = {"eeg": (0, 64),
              "emg_1_flexor": (64, 128) if not swap_emg_grids
              else (128, 192),
              "emg_2_extensor": (128, 192) if not swap_emg_grids
              else (64, 128)}
    for modality, channel_range in ranges.items():
        result = import_otb4_to_csv(
            str(otb4_path), str(feature_dir),
            output_title=f"subject_{subject:02}_{modality}",
            channel_range=channel_range, verbose=False)
        df = pd.read_csv(result["output_files"][0])
        data = df.drop(columns=["Time_s"]).to_numpy(np.float32)
        np.save(feature_dir / filemgmt.file_title(
            f"Raw {modality} {data.shape[1]}ch", ".npy"), data)


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    subjects_and_files = {}  # subject -> otb4 path
    paths = StudyPaths().ensure()
    for subject, otb4 in subjects_and_files.items():
        import_subject(otb4, paths.subject_feature_dir(subject), subject,
                       swap_emg_grids=(subject == 0))
