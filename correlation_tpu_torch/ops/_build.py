"""Build and load the CUDA kernels of the port.

The kernel sources under correlation_tpu_torch/csrc/ are compiled at first
use with nvcc into one shared library with a plain C interface, loaded with
ctypes.  Each source compiles to an object file in its own nvcc process,
all started together, and one more nvcc links them: on an H100 host with
8 cores this took 9.4-11.0 s against 14.5-16.4 s for one nvcc of all
three sources (three runs each, PERF.md section 6).  The library lives in
build/ at the repository root and is named by a hash of its sources and
flags, so a changed source rebuilds it.  Every source is built with
-fmad=false, which the fused assembly and the LM step need to round as
their plain versions do; the experiment kernels are built under it too.
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
_SOURCES = [
    _PKG / "csrc" / name
    for name in ("fused_assemble.cu", "lm_step.cu", "lm_level.cu",
                 "exp_gather.cu", "exp_stages.cu")
]
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
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
    tag = f"{path.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _SOURCES]
    procs = [
        subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(_SOURCES, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [
        f"{src.name} ({proc.returncode}):\n{log}"
        for src, proc, log in zip(_SOURCES, procs, logs) if proc.returncode
    ]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    if not failed:
        link = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode:
            failed.append(f"link ({link.returncode}):\n{link.stdout}"
                          f"{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return path


# Calls that make the host wait for the card.  No launcher may make one:
# the LM loop enqueues a whole chunk without a host sync, and CUDA's sync
# debug mode does not see calls inside this library.
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaMemcpy(", "cudaMemcpy (")


def synchronising_calls() -> dict[str, list[str]]:
    """{source name: the SYNC_CALLS it makes} over the library's sources
    (empty when none synchronises)."""
    found = {}
    for src in _SOURCES:
        text = src.read_text()
        calls = [c for c in SYNC_CALLS if c in text]
        if calls:
            found[src.name] = calls
    return found


def check_launch(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = load_library().fused_assemble_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def load_library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            f32 = ctypes.c_float
            # fused_assemble_launch's arguments before the stream.
            k1 = [
                i32, i32, i32, i32, i32,  # model, interp, channels, threads, chunk
                vp, i32, i32, i32, i32,  # img, hp, wp, img_h, img_w
                vp, i32,  # pix, p_len
                vp, vp, vp,  # center, params, bbox
                vp, vp, i32, i32,  # idx, count, n, num_subsets
                i32, i32,  # tile_h, tile_w
                vp, ctypes.c_longlong,  # work, work_floats
                vp,  # out
            ]
            # lm_step_launch's state arguments, scaling to max_iterations.
            state = [
                vp, vp, vp, vp, i32, i32,  # scaling, n_points, bbox, center, img_h, img_w
                vp, vp, vp, vp, vp,  # p_cur, p_lg, ab, lam, chi_lg
                vp, vp, vp, vp, vp,  # iteration, reached, error, active, init_fail
                f32, f32, f32, f32, f32, i32,  # precision, lambda_min/max/up/down, max_iterations
            ]
            lib.fused_assemble_launch.restype = i32
            lib.fused_assemble_launch.argtypes = k1 + [vp]  # stream
            lib.lm_step_launch.restype = i32
            lib.lm_step_launch.argtypes = [
                i32, i32, vp, vp, vp, i32, i32,  # model, init, out, idx, count, n, S
                *state,
                vp, vp, vp, i32,  # idx_next, count_next, flags, flag_capacity
                vp,  # stream
            ]
            lib.lm_level_launch.restype = i32
            lib.lm_level_launch.argtypes = k1 + state + [
                vp, i32,  # flags, flag_capacity
                vp, vp, i32, vp,  # lists, counts, steps, info (int[4])
                vp,  # stream
            ]
            lib.lm_level_steps.restype = i32
            lib.lm_level_steps.argtypes = [
                vp, vp, i32, vp]  # rows, totals, cap, stream
            lib.lm_step_flags.restype = i32
            lib.lm_step_flags.argtypes = [i32]  # n
            lib.lm_step_workspace_words.restype = i32
            lib.lm_step_workspace_words.argtypes = [i32]  # flags
            lib.fused_assemble_tile_in_shared.restype = i32
            lib.fused_assemble_tile_in_shared.argtypes = [i32] * 5
            lib.fused_assemble_error_string.restype = ctypes.c_char_p
            lib.fused_assemble_error_string.argtypes = [i32]
            lib.empty_kernel_launch.restype = i32
            lib.empty_kernel_launch.argtypes = [vp]  # stream
            # Each launcher ends with (out, stream) and returns cudaError_t.
            launchers = {
                "gather_rows_launch": [vp, vp, i32, i32, i32],  # src, idx, rows, cols, n
                "stage_product_launch":  # batched, a, o, G, B, K, M, P
                    [i32, vp, vp, i32, i32, i32, i32, i32],
                "stage_gram_launch": [i32, vp, i32, i32, i32],  # big, g, G, B, P
                "stage_vpu_launch": [vp, vp, i32, i32, i32],  # sel, rx, G, B, P
            }
            for name, args in launchers.items():
                getattr(lib, name).restype = i32
                getattr(lib, name).argtypes = args + [vp, vp]
            _lib = lib
        return _lib
