"""Build native code from the repository's sources at first use.

Two shared libraries with a plain C interface, loaded with ctypes:

- the CUDA kernels (``sfm_tpu_torch/csrc/*.cu`` and the ``*.cuh`` they
  share), compiled by ``nvcc`` for ``sm_90a`` (Hopper);
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
import re
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
    "--threads", "0",  # the sources compile side by side
    # No implicit multiply-add contraction: the kernels' fused multiply-adds
    # are explicit (__fmaf_rn), so they round exactly like the plain
    # PyTorch versions.
    "-fmad=false", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ctypes argument types of every ``extern "C" int name(...)`` in csrc/*.cu,
# in the declared order: pointers and the stream as c_void_p (ctypes would
# pass a Python int as a 32-bit int and cut the pointer).  Every entry point
# returns cudaGetLastError() as an int.
KERNEL_ARGTYPES = {
    # img, out, n, h, w, k, stream
    "harris_response_f32": [_PTR, _PTR, _I32, _I32, _I32, _F32, _PTR],
    # gray, img_idx, centers, out, inbounds, m, n, h, w, wid, stream
    "sample_normalized_patches_bf16": [
        _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _PTR,
    ],
    # gray, img_idx, centers, out, m, n, h, w, wid, samples_per_block,
    # double_buffer, extract, stream
    "sample_normalized_patches_tiled_bf16": [
        _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
        _I32, _PTR,
    ],
    # rgb, out, n, h, w, stream
    "rgb_to_gray_f32": [_PTR, _PTR, _I32, _I32, _I32, _PTR],
}


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


def _build(name: str, compiler: str, flags, sources, headers=()) -> str:
    """Compile ``sources`` into BUILD_DIR/lib<name>-<hash>.so (once);
    ``headers`` (files the sources include) only enter the hash."""
    h = hashlib.sha1(" ".join([compiler, *flags]).encode())
    for src in (*sources, *headers):
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


_ENTRY_POINT = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def declared_entry_points(csrc_dir: str = CSRC_DIR) -> dict:
    """The ``extern "C" int name(...)`` entry points declared in
    ``csrc_dir``'s ``*.cu``, as name -> ctypes argument types read off the
    declaration: a pointer or the stream is c_void_p, ``float`` c_float,
    ``int`` c_int."""
    found = {}
    for src in sorted(glob.glob(os.path.join(csrc_dir, "*.cu"))):
        with open(src) as f:
            text = f.read()
        for name, params in _ENTRY_POINT.findall(text):
            types = []
            for param in params.split(","):
                words = param.replace("*", " * ").split()[:-1]  # drop the name
                if "*" in words or "cudaStream_t" in words:
                    types.append(_PTR)
                elif words == ["float"]:
                    types.append(_F32)
                elif words == ["int"]:
                    types.append(_I32)
                else:
                    raise ValueError(f"{src}: {name}: parameter {param!r}")
            found[name] = types
    return found


def build_kernels(csrc_dir: str = CSRC_DIR) -> str:
    """Path of the library nvcc builds from ``csrc_dir``'s ``*.cu`` (once);
    its output (``-Xptxas -v``) lies beside it as ``.log``."""
    sources = sorted(glob.glob(os.path.join(csrc_dir, "*.cu")))
    headers = sorted(glob.glob(os.path.join(csrc_dir, "*.cuh")))
    return _build("sfm_kernels", _find_nvcc(), NVCC_FLAGS, sources, headers)


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The CUDA kernels, built by nvcc on first call and loaded once."""
    lib = ctypes.CDLL(build_kernels())
    for name, argtypes in KERNEL_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I32
    return lib


def kernel_build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of the loaded kernel library."""
    with open(kernel_library()._name[:-3] + ".log") as f:
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
