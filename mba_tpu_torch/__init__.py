"""mba_tpu_torch — the PyTorch and CUDA port of ``mba_tpu``.

The JAX package ``mba_tpu`` stays the reference; this package runs the
same computations on an NVIDIA Hopper card (H100), one slice at a time.
The slices so far:

- ``ops.coherence.multitaper_msc``: multitaper CMC with leave-one-taper-out
  jackknife CIs and the EMG max-pool, whose epilogue is the hand-written
  CUDA kernel ``csrc/msc_jackknife.cu`` (``ops/cuda_msc.py``);
- ``ops.cohort_null.cohort_msc_rotation_null``: the cohort FWE rotation
  null, whose surrogate tile is the CUDA kernel ``csrc/null_tile.cu``
  (``ops/cuda_null.py``), with the gram coefficient pass or the chunked
  window pass (``ops/rotation_coeffs.py``) whose pair products are the
  CUDA kernel ``csrc/coeff_pairs.cu`` (``ops/cuda_coeffs.py``), in the
  shared or the per-window rotation mode;
- ``ops.cohort_null.cohort_msc_fft_null`` and ``cohort_msc_null``: the
  full-FFT phase-randomisation null and the dispatch between the two;
- the per-subject feature-extraction stage,
  ``workflows.subject_feature_extraction_workflow`` over
  ``pipeline.signal_features``: the multitaper PSD and the other spectral
  estimators of ``ops.spectral``, band aggregates reduced on the device,
  and the task-wise CMC through ``multitaper_msc`` (kernel B1), with the
  host helpers they need (``channel_layout``, ``utils.file_management``,
  parts of ``pipeline.data_integration``, ``data_analysis`` and
  ``cbpa``);
- ``ops.surrogate``: the phase-randomised coherence null
  ``msc_phase_randomized_null`` and the host fault injection;
- the preprocessing stage, ``pipeline.preprocessing`` and its workflow
  over ``ops.filters``, ``ops.wavelet`` and ``ops.ica``;
- the statistics stage: ``models`` (host OLS/REML fits, formula, FDR; the
  batched REML refits ``models.lme.batched_lme_pvalues`` and the
  mediation bootstrap on the card), ``pipeline.statistical_modelling``
  (the power grid on the card), ``ops.permutation`` (the sign-flip
  cluster-permutation null on the card) and the RQ-A/RQ-B omnibus and
  mediation workflows;
- the study pipeline's glue, host copies that join the stages: OTB4
  import (``io``), the log and serial integration
  (``pipeline.data_integration``, ``pipeline.data_analysis``, the study
  curation and data-integration workflows), ``run_subject`` with the
  enriched serial frame, the "Combined Statistics Nseg" frames
  (``workflows.statistics_data_preparation_workflow``), the CBPA contrast
  assembly and batch (``pipeline.cbpa``, its null on the card) with the
  RQ-A post-hoc workflow, and ``tools.synth_study``'s study tree;
- the report, heterogeneity, descriptive, time-alignment and music
  workflows of the study's last stage and its side analyses;
- the multi-device layer, ``parallel`` (a ``torch.distributed``
  ``DeviceMesh``, the cohort and time-sharded CMC) and the nulls'
  ``mesh=``: every rank computes its block and gets the whole result;
- the acquisition hardware layer (``acquisition``, ``native``'s serial
  shim, ``pipeline.sensor_calibration``), host code that never touches
  the card;
- the JAX package's remaining options: the quantized transfers
  (``utils.transfer``, ``native``'s host quantizers) of
  ``multitaper_msc`` and the rotation null, the null's 16-bit
  ``compute_dtype``, any taper count on the card, ICA's reference
  layout; ``utils.profiling``; the sub-packages' re-exports.

The package imports torch, numpy and scipy (pandas only where a frame or
an experiment log is read, matplotlib only where a figure is drawn,
sklearn only inside the MI fit), never ``jax`` or ``mba_tpu``.  Public functions
keep the JAX package's signatures, layouts (samples on axis 0) and result
dictionaries, and return numpy arrays, or a tensor on the device where
the JAX function returns a device array.  Each entry point runs on the
card (``cuda``) unless it is given ``device="cpu"`` or CPU tensors; where
it would run on the card and there is none, it raises.  Each kernel
wrapper runs its plain PyTorch version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"

from mba_tpu_torch._device import apply_precision_policy

apply_precision_policy()

from mba_tpu_torch import channel_layout  # noqa: F401,E402
