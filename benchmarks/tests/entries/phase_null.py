"""What the ``phase_null`` entry brings for the tests: ``SIZES``, the
small traffic of its cells on the CPU (70 surrogates in chunks of 32:
three chunks, the last one's surplus in the histogram); ``FAULTS``, broken timed paths that the check has to
fail: {name: (module, attribute, wrap)}, where ``wrap`` takes the
program's function and returns the broken one."""

SIZES = {"args": {"surrogate_chunk": 32}}


def _altered_msc(orig):
    def fn(*a, **k):
        out = orig(*a, **k)
        if out.ndim == 4:          # a batch of surrogates, not observed
            out[0] += 1e-3
        return out
    return fn


def _half_batch(orig):
    def fn(spectra, hist, *a, **k):
        return orig(spectra[:len(spectra) // 2], hist, *a, **k)
    return fn


FAULTS = {
    # an answer altered where it is produced: one surrogate's MSC
    "phase_answer": ("mba_tpu_torch.ops.surrogate", "_msc_from_spectra",
                     _altered_msc),
    # half of each batch's surrogates left out of the histogram
    "phase_half": ("mba_tpu_torch.ops.surrogate", "_hist_accumulate",
                   _half_batch),
}
