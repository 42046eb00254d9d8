"""Host-side utilities of the port, copied from ``mba_tpu/utils``."""
