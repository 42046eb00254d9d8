"""What the ``multitaper_msc`` entry brings for the tests: ``SIZES``, the
small traffic of its cells on the CPU, and ``FAULTS``, broken timed
paths that the check has to fail: {name: (module, attribute, wrap)},
where ``wrap`` takes the program's function and returns the broken one."""

SIZES = {"recording": {"arrays": {"eeg": 4, "emg": 3}}}


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


FAULTS = {
    # an answer altered where it is produced
    "cmc_answer": ("mba_tpu_torch.ops.cuda_msc", "msc_jackknife_plain",
                   _altered_msc),
    # half of the batch (the tapers) left out, the mean over the rest
    "cmc_half": ("mba_tpu_torch.ops.cuda_msc", "msc_jackknife_plain",
                 _half_tapers),
}
