"""Channel-layout constants for the Quattrocento EEG cap and HD-EMG grids.

A copy of ``mba_tpu/channel_layout.py`` (numpy only), since the port
never imports ``mba_tpu``.

Parity target: reference ``src/pipeline/channel_layout.py:3-35`` — the 64
EEG electrode names in Quattrocento printout order, the cortical-area
grouping, the name→index lookup and the 64 EMG channel names.  Additionally
provides the electrode coordinates needed by the Laplacian spatial filter and
CBPA adjacency (the reference obtains these from MNE's standard_1020 montage;
we carry a self-contained standard 10-20/10-10 coordinate table so no MNE
dependency is needed).
"""
from __future__ import annotations

import numpy as np

EEG_CHANNELS = [
    'Fp1', 'Fpz', 'Fp2',
    'AF7', 'AF3', 'AFz', 'AF4', 'AF8',
    'F9', 'F7', 'F3', 'F1', 'Fz', 'F2', 'F4', 'F8', 'F10',
    'FT9', 'FT7',
    'FC5', 'FC3', 'FC1', 'FCz', 'FC2', 'FC4', 'FC6',
    'FT8', 'FT10',
    'T9', 'T7',
    'C5', 'C3', 'C1', 'Cz', 'C2', 'C4', 'C6',
    'T8', 'T10',
    'TP9', 'TP7',
    'CP5', 'CP3', 'CP1', 'CPz', 'CP2', 'CP4', 'CP6',
    'TP8', 'TP10',
    'P9', 'P7', 'P3', 'P1', 'Pz', 'P2', 'P4', 'P8', 'P10',
    'PO7', 'POz', 'PO8',
    'O1', 'O2',
]  # Quattrocento printout order (reference channel_layout.py:3-19)

EEG_CHANNELS_BY_AREA = {
    area_label: [
        ch for ch in EEG_CHANNELS
        if (ch[:len(area_abbr)] == area_abbr)
        and ((ch[len(area_abbr):].isnumeric()) or ch[len(area_abbr):] == 'z')
    ]
    for area_label, area_abbr in [
        ('Frontal Pole', 'Fp'), ('Anterior Frontal', 'AF'),
        ('Fronto-Central', 'FC'), ('Frontal', 'F'),
        ('Fronto-Temporal', 'FT'), ('Temporal', 'T'), ('Central', 'C'),
        ('Temporo-Parietal', 'TP'), ('Centro-Parietal', 'CP'),
        ('Parietal', 'P'), ('Parieto-Occipital', 'PO'), ('Occipital', 'O'),
    ]
}
EEG_CHANNEL_IND_DICT = {ch: ind for ind, ch in enumerate(EEG_CHANNELS)}

EMG_CHANNELS = [f"EMG{i:02d}" for i in range(64)]


# --------------------------------------------------------------------------
# Electrode geometry
# --------------------------------------------------------------------------
# Standard 10-10 scalp positions on a unit sphere (head radius normalised to
# 1; realistic scale applied via HEAD_RADIUS_M).  Angles follow the standard
# 10-20 extension: theta = inclination from Cz axis, phi = azimuth measured
# from the right ear (+x right, +y nose, +z up).  This replaces the MNE
# 'standard_1020' montage used at reference preprocessing.py:543.
HEAD_RADIUS_M = 0.095

# (inclination deg from +z, azimuth deg CCW from +x/right-ear axis)
_ANGLES = {
    'Cz': (0, 0),
    'Fpz': (90, 90), 'Fp1': (90, 108), 'Fp2': (90, 72),
    'AFz': (67.5, 90), 'AF3': (71, 109), 'AF4': (71, 71),
    'AF7': (90, 126), 'AF8': (90, 54),
    'Fz': (45, 90), 'F1': (49, 106), 'F2': (49, 74),
    'F3': (57, 121), 'F4': (57, 59), 'F7': (90, 144), 'F8': (90, 36),
    'F9': (113, 144), 'F10': (113, 36),
    'FCz': (22.5, 90), 'FC1': (31, 113), 'FC2': (31, 67),
    'FC3': (45, 134), 'FC4': (45, 46), 'FC5': (67, 149), 'FC6': (67, 31),
    'FT7': (90, 162), 'FT8': (90, 18), 'FT9': (113, 162), 'FT10': (113, 18),
    'C1': (22.5, 180 - 0), 'C2': (22.5, 0),
    'C3': (45, 180), 'C4': (45, 0), 'C5': (67.5, 180), 'C6': (67.5, 0),
    'T7': (90, 180), 'T8': (90, 0), 'T9': (113, 180), 'T10': (113, 0),
    'CPz': (22.5, 270), 'CP1': (31, 247), 'CP2': (31, 293),
    'CP3': (45, 226), 'CP4': (45, 314), 'CP5': (67, 211), 'CP6': (67, 329),
    'TP7': (90, 198), 'TP8': (90, 342), 'TP9': (113, 198), 'TP10': (113, 342),
    'Pz': (45, 270), 'P1': (49, 254), 'P2': (49, 286),
    'P3': (57, 239), 'P4': (57, 301), 'P7': (90, 216), 'P8': (90, 324),
    'P9': (113, 216), 'P10': (113, 324),
    'POz': (67.5, 270), 'PO7': (90, 234), 'PO8': (90, 306),
    'O1': (90, 252), 'O2': (90, 288), 'Oz': (90, 270),
}
# note: C1 azimuth fix (left side): inclination toward left ear is azimuth 180
_ANGLES['C1'] = (22.5, 180)


def eeg_positions_3d(channels: list[str] | None = None,
                     radius_m: float = HEAD_RADIUS_M) -> np.ndarray:
    """Return (n_channels, 3) xyz electrode coordinates in meters.

    Spherical-head approximation of the standard_1020 montage the reference
    attaches via MNE (preprocessing.py:543).  Used for Laplacian neighbor
    lookup and CBPA spatial adjacency.
    """
    channels = channels if channels is not None else EEG_CHANNELS
    out = np.zeros((len(channels), 3), dtype=np.float64)
    for i, ch in enumerate(channels):
        theta, phi = _ANGLES[ch]
        th, ph = np.deg2rad(theta), np.deg2rad(phi)
        out[i] = radius_m * np.array(
            [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)])
    return out


def emg_grid_positions_3d(pitch_m: float = 0.01, n_rows: int = 8,
                          n_cols: int = 8) -> np.ndarray:
    """(64, 3) positions of the GR10MM0808 8x8 HD-EMG grid (10 mm pitch).

    Mirrors the synthetic grid construction at reference
    preprocessing.py:545-560 (8 cm x 8 cm planar grid, z=0).
    """
    rows, cols = np.meshgrid(np.arange(n_rows), np.arange(n_cols),
                             indexing='ij')
    xy = np.stack([cols.ravel() * pitch_m, rows.ravel() * pitch_m], axis=1)
    xy -= xy.mean(axis=0, keepdims=True)
    return np.concatenate([xy, np.zeros((n_rows * n_cols, 1))], axis=1)


def mirror_eeg_channel_list(channels: list[str],
                            input_is_left: bool = True) -> list[str]:
    """Mirror EEG channel names across the midline (left↔right hemisphere).

    Parity: reference signal_features.py:59-76 (used for left-handed
    subjects).  Midline channels ('z' suffix) are unchanged; numeric suffixes
    are incremented (left→right) or decremented (right→left).
    """
    mirrored_channels = []
    for channel in channels:
        if channel[-1] == 'z':
            mirrored_channels.append(channel)
        else:
            if channel[-2:].isnumeric():
                channel_ind = int(channel[-2:])
                channel_area = channel[:-2]
            elif channel[-1].isnumeric():
                channel_ind = int(channel[-1])
                channel_area = channel[:-1]
            else:
                raise ValueError("Unrecognizable EEG channel name: " + channel)
            channel_ind += 1 if input_is_left else -1
            mirrored_channels.append(f"{channel_area}{channel_ind}")
    return mirrored_channels
