"""What the ``task_cmc`` entry brings for the tests and
``tools/calibrate.py``: ``SIZES``, the small traffic of its cells on the
CPU (the whole 64-channel montage, which the subset indexes); ``FAULTS``,
broken timed paths that the check has to fail: {name: (module,
attribute, wrap)}, where ``wrap`` takes the program's function and
returns the broken one; ``READS``, further reads of the program that
calibration records on its control seeds: {kind: keyword arguments of
the call}."""
import numpy as np

SIZES = {"recording": {"arrays": {"eeg": 64, "emg_flexor": 3,
                                  "emg_extensor": 3}}}

# the program's float16 download, the other 16-bit type, for the record
READS = {"program_f16": {"transfer_dtype": np.float16}}


def _altered_msc(orig):
    def fn(*a, **k):
        out = orig(*a, **k)
        out["coherence"][0, 3, 0] += 1e-3
        return out
    return fn


def _half_tapers(orig):
    def fn(eeg_fft, emg_fft, *a, **k):
        h = eeg_fft.shape[1] // 2 + 1
        return orig(eeg_fft[:, :h].contiguous(), emg_fft[:, :h].contiguous(),
                    *a, **k)
    return fn


def _drop_a_window(orig):
    def fn(*a, **k):
        mask = orig(*a, **k)
        mask[np.flatnonzero(mask)[len(np.flatnonzero(mask)) // 2]] = False
        return mask
    return fn


FAULTS = {
    # an answer altered where it is produced
    "cmc_answer": ("mba_tpu_torch.ops.cuda_msc", "msc_jackknife_plain",
                   _altered_msc),
    # half of the batch (the tapers) left out, the mean over the rest
    "cmc_half": ("mba_tpu_torch.ops.cuda_msc", "msc_jackknife_plain",
                 _half_tapers),
    # one active window of the task mask dropped
    "mask_drop": ("mba_tpu_torch.pipeline.signal_features",
                  "task_window_mask_from_spans", _drop_a_window),
}
