"""Statistical models of the port (``mba_tpu/models``): design matrices,
OLS and FDR (host copies), the random-intercept REML solvers (host fit and
batched device fits) and the mediation bootstrap.  Re-exports the names
of ``mba_tpu/models/__init__.py``."""
from mba_tpu_torch.models.formula import (  # noqa: F401
    build_design_matrix, build_formula,
)
from mba_tpu_torch.models.ols import fit_ols  # noqa: F401
from mba_tpu_torch.models.lme import (  # noqa: F401
    fit_random_intercept_reml, batched_lme_pvalues,
)
from mba_tpu_torch.models.fdr import benjamini_hochberg  # noqa: F401
