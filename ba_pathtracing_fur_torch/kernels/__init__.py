"""Build and load the port's hand-written CUDA kernels.

At first use, nvcc compiles every `csrc/*.cu` into ONE shared library with a
plain C interface, under `ba_pathtracing_fur_torch/_build/` (git-ignored),
and ctypes loads it. Pointers and the stream go in as `c_void_p`; each C
entry point returns `cudaGetLastError()` of its launch, and the wrapper
raises when that is not 0. A failed build raises too: there is never a
quiet fallback to the plain torch versions.

The library's file name carries a hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: Hopper only; no --use_fast_math (approximate division and denormal flush
#: would move the ray/triangle determinant test). FMA contraction stays on.
#: -Xptxas -v reports each kernel's registers, stack and spills into the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_C_VOID_P, _C_INT, _C_FLOAT, _C_UINT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_uint)

#: argtypes of every C entry point in csrc/
SIGNATURES = {
    "full_bounce_launch": (
        [_C_INT] + [_C_VOID_P] * 11            # n_rays, 7 state + 4 uniform arrays
        + [_C_VOID_P, _C_INT, _C_VOID_P, _C_INT, _C_VOID_P, _C_INT]  # tables + counts
        + [_C_VOID_P]                          # env colour + ambient (6 floats)
        + [_C_INT, _C_INT, _C_INT, _C_FLOAT, _C_UINT]  # mis rr rr_gate clamp present
        + [_C_VOID_P] * 7                      # outputs
        + [_C_VOID_P]),                        # cudaStream_t
}

_lock = threading.Lock()
_lib = None
LAST_BUILD_LOG = ""


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if there is none."""
    candidates = [Path(os.environ[k]) / "bin" / "nvcc"
                  for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """The library's path, named by a hash of the sources and the flags."""
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libfur_kernels_{h.hexdigest()[:16]}.so"


def build_command(out: Path, nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that builds every csrc/*.cu into `out`."""
    return [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(out),
            *(str(s) for s in sources())]


def build() -> Path:
    """Compile the library if it is not built yet; returns its path. The
    compiler's output (with the ptxas report) is kept in LAST_BUILD_LOG."""
    global LAST_BUILD_LOG
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = build_command(tmp_out, nvcc_path())
        proc = subprocess.run(cmd, capture_output=True, text=True)
        LAST_BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{LAST_BUILD_LOG}")
        os.replace(tmp_out, out)
    return out


def load_library() -> ctypes.CDLL:
    """The built kernel library, with argtypes set (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
