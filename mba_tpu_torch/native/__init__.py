"""Native (C++) host components of the port, loaded via ctypes: the
serial line-protocol parser and ring buffer behind the acquisition layer
(``serialshim.cpp``, a copy of ``mba_tpu/native/serialshim.cpp``), built
with ``g++`` on first use (``native/build.py``)."""
from mba_tpu_torch.native.build import (NativeLineParser,  # noqa: F401
                                        load_serialshim)
