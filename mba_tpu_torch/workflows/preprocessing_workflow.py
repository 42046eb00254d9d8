"""Per-subject preprocessing: EEG and both EMG grids (port of
``mba_tpu/workflows/preprocessing_workflow.py``).

Load the raw npy, build or restore a ``BiosignalPreprocessor``, run the
cascade, optionally validate, save the 'Preprocessed …' npy and its
config.  ``device`` and ``device_resident`` go to the preprocessor
(default: the card).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from mba_tpu_torch.pipeline.preprocessing import BiosignalPreprocessor
from mba_tpu_torch.utils import file_management as filemgmt


def preprocess_subject_modality(subject: int, modality_key: str,
                                feature_dir: Path,
                                sampling_freq: int = 2048,
                                config_path: Path | None = None,
                                run_validation: bool = False,
                                manual_ics_to_exclude=None,
                                device=None, device_resident: bool = False,
                                **preprocessor_kwargs):
    """Load raw npy → run the cascade → save results + config."""
    feature_dir = Path(feature_dir)
    raw_path = filemgmt.most_recent_file(feature_dir, ".npy",
                                         ["Raw", modality_key])
    data = np.load(raw_path)
    modality = 'eeg' if 'eeg' in modality_key else 'emg'

    if config_path is not None:
        prepper = BiosignalPreprocessor.init_from_config(
            config_path, data, device_resident=device_resident,
            device=device)
    else:
        kwargs = dict(n_ica_components=(25 if modality == 'eeg'
                                        else None))
        kwargs.update(preprocessor_kwargs)      # caller wins
        prepper = BiosignalPreprocessor(
            np_input_data=data, sampling_freq=sampling_freq,
            modality=modality, device_resident=device_resident,
            device=device, **kwargs)
    if manual_ics_to_exclude is not None:
        prepper.manual_ics_to_exclude = manual_ics_to_exclude

    _ = prepper.np_output_data
    if run_validation:
        prepper.validate_filtering()
        if modality == 'eeg':
            prepper.validate_referencing()
        prepper.validate_amplitude_thresholding(n_runs=3)
        if prepper.wavelet_type is not None:
            prepper.validate_wavelet_denoising()
    prepper.export_results(feature_dir, identifier=modality_key)
    return prepper
