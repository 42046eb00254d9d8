"""Build the hand-written CUDA kernels and bind them with ctypes.

Each ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` call links the objects into one
shared library with a plain C interface, under ``mba_tpu_torch/_build/``
(listed in ``.gitignore``).  The library name carries a hash of the
sources and flags, so a changed source rebuilds on first use and an
unchanged one loads at once.  Nothing is built when the package is
imported: the first kernel launch calls :func:`load_library`.

Flags: ``sm_90a`` (Hopper: ``wgmma`` in the 16-bit null tile) and no
``--use_fast_math``: the MSC kernel's Fisher transform needs IEEE
``logf``/``tanhf``/division so that its edge cases
(``c == 1`` → ``+inf`` → NaN CIs) match the JAX package, and the
coefficient kernel's IEEE ``sqrtf``/division and kept denormals (no
flush to zero) clamp a tiny ``pe·pm`` as the CPU does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every pointer and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints and cut them)
_SIGNATURES = {
    # eeg, emg, coh, lo, hi, W, K, F, E, M, t_crit, emg_max, stream
    "mba_msc_jackknife": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                          _P),
    "mba_msc_jackknife_rt": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                             _I, _P),
    # G, coefT, base, obs, partial_max, counts, max_out,
    # nF, S, ldg, JP, N, inv_J, stream
    "mba_null_tile": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                      _P),
    # G, coefT, base, obs, partial_max, counts, max_out,
    # nF, S, ldg, JP, N, ldc, inv_J, f16, stream
    "mba_null_tile_tc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _F, _I, _P),
    # eeg, emg, weights, diag, pr, pi, scratch, wc, K, F, E, M,
    # accumulate, stream
    "mba_coeff_pairs": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P),
    "mba_coeff_pairs_rt": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P),
    # k0, k1, out, n, mode, minval, span, stream
    "mba_threefry": (_U, _U, _P, _L, _I, _F, _F, _P),
    # keys, out, n_keys, n_per, minval, span, stream
    "mba_threefry_keys": (_P, _P, _L, _L, _F, _F, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under the CUDA toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def compile_command(obj: Path, src: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(out: Path, objs: list[Path], nvcc: str = "nvcc"
                 ) -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *map(str, objs)]


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ARCH_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmba_kernels_{_digest(sources())}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    # build under private names, then rename: a concurrent build never
    # loads a half-written library
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in (compile_command(o, s, nvcc)
                         for o, s in zip(objs, srcs))]
    try:
        for cmd, proc in procs:
            output, _ = proc.communicate()
            _check_nvcc(cmd, proc.returncode, output)
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        cmd = link_command(tmp, objs, nvcc)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check_nvcc(cmd, proc.returncode, proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        for _, proc in procs:       # the rest, after a failed compile
            if proc.returncode is None:
                proc.kill()
                proc.communicate()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def _check_nvcc(cmd: list[str], code: int, output: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n"
                           f"{output}")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.mba_error_string.argtypes = [ctypes.c_int]
    lib.mba_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point
    (a refused launch never runs, and ``synchronize`` would not say)."""
    if code != 0:
        msg = lib.mba_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")
