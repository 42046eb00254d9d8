"""Build and ctypes bindings of the native serial shim (port of
``mba_tpu/native/build.py:15-26``, ``:111-175``).

``serialshim.cpp`` (a copy of the JAX package's) compiles with the
system ``g++`` on first use into ``mba_tpu_torch/_build/`` (listed in
``.gitignore``), never beside its source; the library name carries a
hash of the source and flags, so a changed source rebuilds and an
unchanged one loads at once.  The JAX package's native int8/int16
upload quantizer (``quantshim.cpp``) is not ported: its numpy form,
bit-identical, is ``native/quantize.py``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

from mba_tpu_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "serialshim.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


class Sample(ctypes.Structure):
    _fields_ = [("fsr", ctypes.c_double), ("ecg", ctypes.c_double),
                ("gsr", ctypes.c_double), ("t_mono", ctypes.c_double),
                ("seq", ctypes.c_uint64)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libserialshim_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the shim unless a library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent build never
    # loads a half-written library
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load_serialshim() -> ctypes.CDLL:
    """Compile (once) and load the native serial shim."""
    lib = ctypes.CDLL(str(build()))
    lib.parser_create.restype = ctypes.c_void_p
    lib.parser_create.argtypes = [ctypes.c_uint32]
    lib.parser_destroy.restype = None
    lib.parser_destroy.argtypes = [ctypes.c_void_p]
    lib.parser_feed.restype = ctypes.c_uint64
    lib.parser_feed.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_uint32, ctypes.c_double]
    lib.parser_poll.restype = ctypes.c_uint32
    lib.parser_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(Sample),
                                ctypes.c_uint32]
    lib.parser_dropped.restype = ctypes.c_uint64
    lib.parser_dropped.argtypes = [ctypes.c_void_p]
    lib.parser_pending.restype = ctypes.c_uint64
    lib.parser_pending.argtypes = [ctypes.c_void_p]
    lib.serial_open.restype = ctypes.c_int
    lib.serial_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.serial_read_into_parser.restype = ctypes.c_int
    lib.serial_read_into_parser.argtypes = [ctypes.c_int,
                                            ctypes.c_void_p,
                                            ctypes.c_double]
    lib.serial_write_byte.restype = ctypes.c_int
    lib.serial_write_byte.argtypes = [ctypes.c_int, ctypes.c_uint8]
    lib.serial_close.restype = None
    lib.serial_close.argtypes = [ctypes.c_int]
    return lib


class NativeLineParser:
    """Pythonic wrapper over the C++ ring-buffer parser."""

    def __init__(self, capacity: int = 8192):
        self._lib = load_serialshim()
        self._handle = self._lib.parser_create(capacity)
        if not self._handle:
            raise MemoryError("parser_create failed")

    def feed(self, data: bytes, t_mono: float = 0.0) -> int:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return int(self._lib.parser_feed(self._handle, buf, len(data),
                                         t_mono))

    def poll(self, max_out: int = 1024) -> list[dict]:
        out = (Sample * max_out)()
        n = self._lib.parser_poll(self._handle, out, max_out)
        return [{"fsr": out[i].fsr, "ecg": out[i].ecg,
                 "gsr": out[i].gsr, "t_mono": out[i].t_mono,
                 "seq": out[i].seq} for i in range(n)]

    @property
    def dropped(self) -> int:
        return int(self._lib.parser_dropped(self._handle))

    @property
    def pending(self) -> int:
        return int(self._lib.parser_pending(self._handle))

    def close(self) -> None:
        """Free the native parser (idempotent)."""
        if getattr(self, "_handle", None):
            self._lib.parser_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
