"""Array code of the port: plain PyTorch functions and the wrappers of
the hand-written CUDA kernels (``cuda_msc.py``, ``cuda_null.py``,
``cuda_coeffs.py``, ``cuda_prng.py``).  Re-exports the names of
``mba_tpu/ops/__init__.py``; importing builds no kernel."""
from mba_tpu_torch.ops.dpss import dpss_windows  # noqa: F401
from mba_tpu_torch.ops.framing import (  # noqa: F401
    frame_signal, window_grid, resample_linear,
)
from mba_tpu_torch.ops.spectral import (  # noqa: F401
    multitaper_psd, welch_psd, spectral_snr, amplitude_spectrum,
)
from mba_tpu_torch.ops.coherence import (  # noqa: F401
    multitaper_msc, fisher_atanh, inverse_fisher_atanh,
    cmc_independence_threshold,
)
