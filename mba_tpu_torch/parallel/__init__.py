"""Device-mesh parallelism on ``torch.distributed`` (port of
``mba_tpu/parallel``).

Each rank is one process of an initialised process group (``torchrun``
with NCCL, one rank per card; gloo on the CPU, ``device_type="cpu"``), and
every rank calls the functions here with the same host arrays:

- cohort axis (subjects)  → data parallel
- window axis (time)      → sequence parallel (windows are independent)
- surrogate axis          → the nulls' ``mesh=`` (``ops.surrogate``,
  ``ops.cohort_null``)

The mesh checks and the collectives (an all-reduce for the nulls'
counts, all-gathers of each rank's block, a halo exchange) are in
``mba_tpu_torch/_dist.py``, below both ``ops`` and ``parallel``.
"""
from mba_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, cohort_sharding,
)
from mba_tpu_torch.parallel.cohort import (  # noqa: F401
    cohort_multitaper_msc, time_sharded_msc,
)
