"""Build and load the port's hand-written CUDA kernels.

At first use, nvcc compiles each `csrc/*.cu` into its own shared library
with a plain C interface, all sources at once (one nvcc process per source,
started together), under `ba_pathtracing_fur_torch/_build/` (git-ignored),
and ctypes loads them. Pointers and the stream go in as `c_void_p`; each C
entry point returns `cudaGetLastError()` of its launch, and the wrapper
raises when that is not 0. A failed build raises too: there is never a
quiet fallback to the plain torch versions.

The build directory's name carries a hash of every source and header and
of the flags, so an edited source is rebuilt and a stale library is never
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import types
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: Hopper only; no --use_fast_math (approximate division and denormal flush
#: would move the ray/triangle determinant test). FMA contraction stays on
#: except where SOURCE_FLAGS turns it off.
#: -Xptxas -v reports each kernel's registers, stack and spills into the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

#: per-source flags on top of NVCC_FLAGS. The traversal, brute-force, hit,
#: shade and camera kernels are built without FMA contraction, so their
#: arithmetic rounds like the plain torch versions' separate ops: the
#: traversal kernels agree with their twins bit for bit on t, rows and
#: found, the hit kernel with the torch assembly on every field of the Hit,
#: the camera kernel with the torch chain on every ray and key, and the
#: shade kernel's hair paths do not drift from its twin's over a render's
#: samples. The full-bounce kernel (its own source) keeps contraction on.
SOURCE_FLAGS = {name: ("-fmad=false",)
                for name in ("traverse.cu", "traverse_stream.cu", "bruteforce.cu", "hit.cu",
                             "shade.cu", "camera.cu")}

_C_VOID_P, _C_INT, _C_FLOAT, _C_UINT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_uint)

#: every C entry point: (source file, argtypes)
SIGNATURES = {
    "full_bounce_launch": ("full_bounce.cu", (
        [_C_INT] + [_C_VOID_P] * 11            # n_rays, 7 state + 4 uniform arrays
        + [_C_VOID_P, _C_INT, _C_VOID_P, _C_INT, _C_VOID_P, _C_INT]  # tables + counts
        + [_C_VOID_P]                          # env colour + ambient (6 floats)
        + [_C_INT, _C_INT, _C_INT, _C_FLOAT, _C_UINT]  # mis rr rr_gate clamp present
        + [_C_VOID_P] * 7                      # outputs
        + [_C_VOID_P])),                       # cudaStream_t
    "traverse_launch": ("traverse.cu", (
        [_C_INT] + [_C_VOID_P] * 7             # n_rays, o d t_max bmin bmax packed uboxes
        + [_C_INT, _C_INT, _C_INT, _C_INT, _C_FLOAT]  # n_leaves leaf_k cone any_hit t_min
        + [_C_VOID_P] * 3                      # t row found
        + [_C_VOID_P])),                       # cudaStream_t
    "stream_launch": ("traverse_stream.cu", (
        [_C_INT] + [_C_VOID_P] * 9             # n_rays, o d t_max bmin bmax sboxes cboxes
                                               # packed uboxes
        + [_C_INT] * 7                         # n_sup fanout leaf_k cone any_hit bf16 mxu
        + [_C_VOID_P, _C_FLOAT]                # is_any (null unless mixed) t_min
        + [_C_VOID_P] * 3                      # t row found
        + [_C_VOID_P])),                       # cudaStream_t
    "stream_occupancy": ("traverse_stream.cu", (
        [_C_INT] * 7                           # n_sup leaf_k cone any_hit mixed bf16 mxu
        + [_C_VOID_P] * 2)),                   # &bytes &blocks
    "bruteforce_launch": ("bruteforce.cu", (
        [_C_INT] + [_C_VOID_P] * 5             # n_rays, o d t_max prims boxes
        + [_C_INT, _C_INT, _C_FLOAT]           # n_prims cone t_min
        + [_C_VOID_P] * 2                      # t idx
        + [_C_VOID_P])),                       # cudaStream_t
    "hit_launch": ("hit.cu", (
        [_C_INT] + [_C_VOID_P] * 3 + [_C_FLOAT]  # n_rays, o d t_max, t_min
        + [_C_VOID_P] * 10                     # tri then cone: aos row found t perm
        + [_C_VOID_P] * 12                     # the Hit's fields
        + [_C_VOID_P])),                       # cudaStream_t
    "shade_launch": ("shade.cu", (
        [_C_INT, _C_VOID_P, _C_VOID_P]         # n_rays, &ShadeIn, &ShadeOut
        + [_C_VOID_P, _C_INT, _C_VOID_P, _C_INT]  # lights and materials tables + counts
        + [_C_INT]                             # bounce
        + [_C_INT, _C_INT, _C_INT, _C_FLOAT, _C_UINT]  # mis rr rr_gate clamp present
        + [_C_INT, _C_INT, _C_INT]             # has_hair hair_p_random env_per_ray
        + [_C_VOID_P]                          # &TexIn, null when untextured
        + [_C_VOID_P])),                       # cudaStream_t
    "camera_launch": ("camera.cu", (
        [_C_INT, _C_VOID_P, _C_UINT, _C_VOID_P, _C_INT]  # n_rays, base key, sample, ids, width
        + [_C_VOID_P] * 4                      # position bottom_left axis_x axis_y
        + [_C_FLOAT] * 3                       # pixel_size focus_distance 3*aperture
        + [_C_INT, _C_INT, _C_FLOAT, _C_FLOAT]  # use_dof qmc, the Hammersley point
        + [_C_INT]                             # first slot
        + [_C_VOID_P] * 8                      # keys and the RayState fields
        + [_C_VOID_P])),                       # cudaStream_t
    "shade_draws_launch": ("shade.cu", (
        [_C_INT, _C_VOID_P, _C_INT, _C_INT]    # n_rays, keys, bounce, n_tags
        + [_C_VOID_P, _C_VOID_P])),            # out, cudaStream_t
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


def build_dir() -> Path:
    """The libraries' directory, named by a hash of the sources and flags."""
    h = hashlib.sha256(repr((NVCC_FLAGS, SOURCE_FLAGS)).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"fur_kernels_{h.hexdigest()[:16]}"


def library_path(src: Path) -> Path:
    return build_dir() / f"lib{src.stem}.so"


def build_command(src: Path, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that builds one csrc/*.cu into `out`."""
    return [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-I", str(SRC_DIR), "-o",
            str(out), str(src)]


def build() -> list[Path]:
    """Compile every library that is not built yet, one nvcc per source, all
    started together; returns their paths. The compilers' output (with the
    ptxas reports) is kept in LAST_BUILD_LOG."""
    global LAST_BUILD_LOG
    outs = [library_path(s) for s in sources()]
    todo = [(s, o) for s, o in zip(sources(), outs) if not o.is_file()]
    if not todo:
        return outs
    outs[0].parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=outs[0].parent) as tmp:
        jobs = []
        for src, out in todo:
            cmd = build_command(src, Path(tmp) / out.name, nvcc)
            jobs.append((cmd, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, out, proc in jobs:
            log = proc.communicate()[0]
            logs.append(f"$ {' '.join(cmd)}\n{log}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        LAST_BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError("\n".join(failed))
        for cmd, out, _ in jobs:
            os.replace(Path(tmp) / out.name, out)
    return outs


def load_library() -> types.SimpleNamespace:
    """The C entry points of the built libraries, with argtypes set (built
    on first use), as attributes of one namespace."""
    global _lib
    with _lock:
        if _lib is None:
            libs = {p.name: ctypes.CDLL(str(p)) for p in build()}
            fns = {}
            for name, (src, argtypes) in SIGNATURES.items():
                fn = getattr(libs[f"lib{Path(src).stem}.so"], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib
