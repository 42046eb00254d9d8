"""What the ``rotation_null_16bit`` entry brings for the tests and
``tools/calibrate.py``: ``SIZES``, the small traffic of its cells on the
CPU; ``FAULTS``, broken timed paths that the check has to fail: {name:
(module, attribute, wrap)}, where ``wrap`` takes the program's function
and returns the broken one; ``READS``, further reads of the program
that calibration records on its control seeds: {kind: keyword arguments
of the call}."""
import torch

SIZES = {"recording": {"arrays": {"eeg": 4, "emg": 3}}}

# the other 16-bit instance, float16, for the record
READS = {"program_f16": {"compute_dtype": torch.float16}}


def _altered_null(orig):
    def fn(*a, **k):
        ms, counts = orig(*a, **k)
        ms[0] += 1e-2
        return ms, counts
    return fn


def _half_subjects(orig):
    def fn(bases, coefs):
        h = len(bases) // 2
        base, _, observed = orig(bases[:h], coefs[:h])
        return base, orig(bases, coefs)[1], observed
    return fn


FAULTS = {
    # an answer altered where it is produced
    "null_answer": ("mba_tpu_torch.ops.cuda_null", "null_tile_plain",
                    _altered_null),
    # half of the batch (the subjects) left out of the cohort mean
    "null_half": ("mba_tpu_torch.ops.cohort_null", "cohort_epilogue",
                  _half_subjects),
}
