"""A small study tree for the study-pipeline tests of ``mba_tpu_torch``.

``mba_tpu_torch.tools.synth_study`` lays the tree out as the JAX
package's ``tools/synth_study.py`` does, with its constants cut to a
test's size: a few short trials at a low sampling rate.  Each subject's
"Preprocessed" EEG and EMG arrays carry a beta drive that couples EEG
and EMG during the trials (music at full gain, silence at
``SILENCE_GAIN``), so the CMC, the omnibus and the CBPA have an effect
to find.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np

from mba_tpu_torch.tools import synth_study as S
from mba_tpu_torch.utils import file_management as filemgmt

SMALL = dict(FS=128.0, TRIAL_SEC=20.0, GAP_SEC=6.0)
N_TRIALS = 10
N_EMG = 4
BETA = (16.0, 28.0)


@contextlib.contextmanager
def small_plan_constants(*modules):
    """Cut each synth module's constants to SMALL while the block runs."""
    saved = [{k: getattr(m, k) for k in SMALL} for m in modules]
    try:
        for m in modules:
            for k, v in SMALL.items():
                setattr(m, k, v)
        yield
    finally:
        for m, old in zip(modules, saved):
            for k, v in old.items():
                setattr(m, k, v)


def small_plan() -> S.TrialPlan:
    with small_plan_constants(S):
        return S.TrialPlan(N_TRIALS)


def subject_signals(plan: S.TrialPlan, subject: int, fs: float):
    """(eeg (n, 64), flexor (n, N_EMG), extensor (n, N_EMG)) float32 with
    a gated 16-28 Hz drive shared by EEG and EMG."""
    rng = np.random.default_rng(100 + subject)
    n = plan.n_samples
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1 / fs)
    spec[(f < BETA[0]) | (f > BETA[1])] = 0
    drive = np.fft.irfft(spec, n=n)
    drive /= drive.std() + 1e-12
    drive = (drive * plan.drive_gate(rng)).astype(np.float32)
    gains = (rng.uniform(0.3, 1.0, 64)
             * rng.choice([-1.0, 1.0], 64)).astype(np.float32)
    eeg = rng.standard_normal((n, 64), dtype=np.float32)
    eeg += 0.8 * drive[:, None] * gains[None, :]

    def emg(gain):
        x = rng.standard_normal((n, N_EMG), dtype=np.float32)
        x += gain * drive[:, None]
        return x
    return eeg, emg(0.9), emg(0.5)


def write_small_study(root: Path, n_subjects: int) -> dict:
    """The tree under ``root/data``: experiment results (logs, raw
    serial, questionnaires, accuracies), the music lookup table, and each
    subject's "Preprocessed" arrays in its feature directory."""
    root = Path(root)
    exp_root = root / "data" / "experiment_results"
    feat_root = root / "data" / "precomputed_features"
    with small_plan_constants(S):
        plan = S.TrialPlan(N_TRIALS)
        for subject in range(n_subjects):
            S.write_subject_tree(exp_root, subject, plan)
            feat = feat_root / f"subject_{subject:02}"
            feat.mkdir(parents=True, exist_ok=True)
            for name, x in zip(("eeg", "emg_1_flexor", "emg_2_extensor"),
                               subject_signals(plan, subject, S.FS)):
                np.save(feat / filemgmt.file_title(
                    f"Preprocessed {name}", ".npy"), x)
        lookup = S.write_music_lookup(root / "data" / "song_characteristics",
                                      plan)
    return {"root": root, "exp_root": exp_root, "feat_root": feat_root,
            "lookup": lookup, "plan": plan, "fs": SMALL["FS"]}


def assert_same(got, want, path="result"):
    """Equal results of the two packages' host code: frames, series,
    indexes and arrays equal (NaN equal to NaN, dtypes alike), dicts,
    lists and tuples element by element, scalars equal or both NaN."""
    import pandas as pd
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, obj=path)
    elif isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want, obj=path)
    elif isinstance(want, pd.Index):
        pd.testing.assert_index_equal(got, want, obj=path)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if want.dtype.kind in "fc":
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            assert_same(got.tolist(), want.tolist(), path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), path
    else:
        assert type(got) is type(want) and got == want, \
            f"{path}: {got!r} != {want!r}"
