"""Statistical models of the port (``mba_tpu/models``): design matrices,
OLS and FDR (host copies), the random-intercept REML solvers (host fit and
batched device fits) and the mediation bootstrap."""
