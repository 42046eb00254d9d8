"""Data import/export: OTB4 archives (a host copy of ``mba_tpu/io``)."""
from mba_tpu_torch.io.otb4 import import_otb4_to_csv, read_otb4  # noqa: F401
