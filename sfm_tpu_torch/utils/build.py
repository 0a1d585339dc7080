"""Build native code from the repository's sources at first use.

Two shared libraries with a plain C interface, loaded with ctypes:

- the CUDA kernels (``sfm_tpu_torch/csrc/*.cu``), compiled by ``nvcc`` for
  ``sm_90a`` (Hopper);
- the track store (``native/trackstore.cpp``), compiled by ``g++``.

Outputs go to ``build/sfm_tpu_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source never loads a stale library.  A failed build raises with the
compiler's stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "sfm_tpu_torch")
CSRC_DIR = os.path.join(_PKG, "csrc")
TRACKSTORE_SRC = os.path.join(REPO_ROOT, "native", "trackstore.cpp")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # No implicit multiply-add contraction: the kernels' fused multiply-adds
    # are explicit (__fmaf_rn), so they round exactly like the plain
    # PyTorch versions.
    "-fmad=false", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of sfm_tpu_torch cannot be built"
        )
    return nvcc


def _build(name: str, compiler: str, flags, sources) -> str:
    """Compile ``sources`` into BUILD_DIR/lib<name>-<hash>.so (once)."""
    h = hashlib.sha1(" ".join([compiler, *flags]).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a private name and rename: concurrent first uses (test
    # workers) never load a half-written file.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [compiler, *flags, "-o", tmp, *sources],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"building {name} failed ({compiler}, rc {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The CUDA kernels, built by nvcc on first call and loaded once."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    lib = ctypes.CDLL(_build("sfm_kernels", _find_nvcc(), NVCC_FLAGS, sources))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.harris_response_f32.argtypes = [ptr, ptr, i32, i32, i32, f32, ptr]
    lib.harris_response_f32.restype = i32
    lib.sample_normalized_patches_bf16.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
    ]
    lib.sample_normalized_patches_bf16.restype = i32
    return lib


def kernel_build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of the loaded kernel library."""
    lib = kernel_library()
    with open(lib._name[:-3] + ".log") as f:
        return f.read()


def cxx_available() -> bool:
    return shutil.which("g++") is not None


@functools.lru_cache(maxsize=None)
def trackstore_library() -> ctypes.CDLL:
    """``native/trackstore.cpp`` built by g++ on first call (the committed
    ``native/libtrackstore.so`` was built on another machine and is never
    loaded)."""
    lib = ctypes.CDLL(
        _build("trackstore", "g++", GXX_FLAGS, [TRACKSTORE_SRC])
    )
    ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib.ts_create.restype = ptr
    lib.ts_create.argtypes = [f64]
    lib.ts_destroy.restype = None
    lib.ts_destroy.argtypes = [ptr]
    lib.ts_add_pairs.restype = None
    lib.ts_add_pairs.argtypes = [ptr, i64, ptr, ptr, ptr]
    lib.ts_info.restype = None
    lib.ts_info.argtypes = [ptr, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.ts_export.restype = None
    lib.ts_export.argtypes = [ptr, ptr, ptr, ptr]
    lib.ts_update_world.restype = None
    lib.ts_update_world.argtypes = [ptr, ptr, i64]
    return lib
