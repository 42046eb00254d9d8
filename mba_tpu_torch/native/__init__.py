"""Native (C++) host components of the port, loaded via ctypes: the
serial line-protocol parser and ring buffer behind the acquisition layer
(``serialshim.cpp``, a copy of ``mba_tpu/native/serialshim.cpp``), built
with ``g++`` on first use (``native/build.py``), and the per-channel
int16/int8 upload quantizers (``native/quantize.py``, numpy, no build)."""
from mba_tpu_torch.native.build import (NativeLineParser,  # noqa: F401
                                        load_serialshim)
from mba_tpu_torch.native.quantize import (  # noqa: F401
    quantize_int16_per_channel, quantize_int8_per_channel)
