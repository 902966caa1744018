"""Build and load the CUDA kernels of the port.

The kernel sources under correlation_tpu_torch/csrc/ are compiled at first
use with nvcc into a shared library with a plain C interface, loaded with
ctypes.  The library lives in build/ at the repository root and is named
by a hash of its sources and flags, so a changed source rebuilds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = [_PKG / "csrc" / "fused_assemble.cu"]
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None
# Seconds the last build took (0.0 when the library was already built).
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcorrelation_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds
    path = library_path()
    if path.exists():
        build_seconds = 0.0
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return path


def load_library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.fused_assemble_launch.restype = i32
            lib.fused_assemble_launch.argtypes = [
                i32, i32, i32,  # model, interp, channels
                vp, i32, i32, i32, i32,  # img, hp, wp, img_h, img_w
                vp, i32,  # pix, p_len
                vp, vp, vp,  # center, params, bbox
                vp, i32, i32,  # idx, n, num_subsets
                i32, i32,  # tile_h, tile_w
                vp, vp,  # out, stream
            ]
            lib.fused_assemble_error_string.restype = ctypes.c_char_p
            lib.fused_assemble_error_string.argtypes = [i32]
            _lib = lib
        return _lib
