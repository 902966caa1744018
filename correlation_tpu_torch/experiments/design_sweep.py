"""Time the designs that two experiment kernels were chosen over.

Run on a machine with an NVIDIA GPU, from the root of a checkout:

  python -m correlation_tpu_torch.experiments.design_sweep

Two questions, at the JAX scripts' sizes, every time read from HBM
(utils/profiling.graph_ms_cold) in two passes, the second in the reverse
order of the first:

  gram_big  csrc/exp_stages.cu rebuilt with GRAM_BIG_WARPS warps a pair of
            subsets (1, 2, 4, 8) and GRAM_BIG_DEPTH chunks in flight a warp
            (1, 2, 4), beside the shipped kernel (the source's defaults,
            from the kernel library) and torch.einsum: time, max |kernel -
            plain| against the 1e-5 x sum |terms| tolerance, and registers
            and spill stores from ptxas.
  gather    the shipped kernel (csrc/exp_gather.cu, src staged in shared
            memory) beside the direct design (csrc/design_sweep.cu),
            torch.take_along_dim and an empty kernel.

The shipped gram_big is read four times (twice itself, twice as the
rebuild with the source's defaults) and the shipped gather twice; the spread of those readings is the
noise the others are read against.  Prints a line per design, the card's
name and power limit, and last a JSON line with every reading; without a
CUDA device it exits with 1.  The variant libraries go to
build/design_sweep/.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from correlation_tpu_torch.experiments import exp_gather as eg
from correlation_tpu_torch.experiments import exp_matmul_overhead as em
from correlation_tpu_torch.ops import _build

WARPS = (1, 2, 4, 8)
DEPTHS = (1, 2, 4)
CSRC = Path(__file__).resolve().parent.parent / "csrc"
OUT_DIR = _build.BUILD_DIR / "design_sweep"


def shipped_gram_big(source: str) -> str:
    """The name (w<warps>_d<depth>) of the design that `source`, the text
    of csrc/exp_stages.cu, builds by default."""
    w, d = (int(re.search(rf"#define GRAM_BIG_{k} (\d+)", source).group(1))
            for k in ("WARPS", "DEPTH"))
    return f"w{w}_d{d}"


def _compile(src: Path, name: str, defines: list[str]):
    """Start nvcc on `src` into OUT_DIR/name.so, with ptxas's report."""
    path = OUT_DIR / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           *(f"-D{d}" for d in defines), "-shared", "-o", str(path), str(src)]
    return path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)


def ptxas_usage(log: str, kernel: str) -> tuple[int | None, int | None]:
    """(registers, spill-store bytes) of the first kernel whose mangled
    name holds `kernel`, from nvcc -Xptxas -v output."""
    lines = log.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" not in line or kernel not in line:
            continue
        spill = None
        for nxt in lines[k + 1:k + 6]:
            m = re.search(r"(\d+) bytes spill stores", nxt)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", nxt)
            if m:
                return int(m.group(1)), spill
    return None, None


def _launcher(lib, name: str, args: list):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = args + [ctypes.c_void_p, ctypes.c_void_p]  # out, stream
    return fn


def _run(fn, what: str, out: torch.Tensor, *args) -> torch.Tensor:
    rc = fn(*args, out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{what}: launch failed, cudaError {rc}")
    return out


def _gram_variant(lib, what: str):
    i32 = ctypes.c_int
    launch = _launcher(lib, "stage_gram_launch", [i32, ctypes.c_void_p, i32,
                                                  i32, i32])

    def gram(g):
        out = torch.empty(g.shape[:2] + (8, 8), dtype=torch.float32,
                          device=g.device)
        return _run(launch, what, out, 1, g.data_ptr(), g.shape[0],
                    g.shape[1], g.shape[3])
    return gram


def _gather_direct(lib):
    i32 = ctypes.c_int
    launch = _launcher(lib, "gather_rows_direct_launch",
                       [ctypes.c_void_p, ctypes.c_void_p, i32, i32, i32])

    def gather(src, idx):
        out = torch.empty(idx.shape, dtype=torch.float32, device=src.device)
        return _run(launch, "gather_rows_direct", out, src.data_ptr(),
                    idx.data_ptr(), src.shape[0], src.shape[1], idx.shape[0])
    return gather


def two_passes(fns: dict) -> dict:
    """{name: [ms, ms]} for fns {name: (fn, inputs)}: each timed from HBM
    in the order given, then again in the reverse order."""
    from correlation_tpu_torch.utils.profiling import graph_ms_cold

    ms = {name: [] for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            fn, inputs = fns[name]
            ms[name].append(graph_ms_cold(fn, inputs))
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("design_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    from correlation_tpu_torch.utils.profiling import card_name_and_power

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    builds = {
        f"w{w}_d{d}": _compile(CSRC / "exp_stages.cu", f"gram_big_w{w}_d{d}",
                               [f"GRAM_BIG_WARPS={w}", f"GRAM_BIG_DEPTH={d}"])
        for w in WARPS for d in DEPTHS
    }
    builds["direct"] = _compile(CSRC / "design_sweep.cu", "design_sweep", [])
    _build.load_library()
    libs, usage = {}, {}
    for name, (path, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(path))
        usage[name] = ptxas_usage(log, "gather_rows_direct_kernelILb1E"
                                  if name == "direct" else
                                  "stage_gram_big_kernelILb1E")
    smi = card_name_and_power()
    dev = torch.device("cuda")
    result = {"card": smi}

    # ---- gram_big ----------------------------------------------------------
    g = em.make_inputs("gram_big", dev)[0]
    ref = em.gram_reference(g)
    scale = em.terms_scale("gram_big", [g])
    grams = {"shipped": em.stage_gram_big}
    grams.update({name: _gram_variant(libs[name], f"gram_big {name}")
                  for name in builds if name != "direct"})
    grams["einsum"] = em.gram_reference
    rows = {}
    for name, fn in grams.items():
        ok, err = em.agreement(fn(g), ref, scale)
        regs, spill = usage.get(name, (None, None))
        rows[name] = {"within_tolerance": ok, "max_abs_err": err,
                      "registers": regs, "spill_store_bytes": spill}
    for name, ms in two_passes({n: (fn, [g]) for n, fn in grams.items()}
                               ).items():
        rows[name]["ms"] = ms
    twin = shipped_gram_big((CSRC / "exp_stages.cu").read_text())
    shipped = rows["shipped"]["ms"] + rows[twin]["ms"]
    result["gram_big"] = rows
    result["gram_big_shipped_spread_ms"] = max(shipped) - min(shipped)
    for name, r in rows.items():
        print(f"gram_big {name:8s}: {r['ms'][0]:.4f} / {r['ms'][1]:.4f} ms "
              f"(two passes, graph, from HBM); max |kernel - plain| "
              f"{r['max_abs_err']:.3e} (within 1e-5 x sum |terms|: "
              f"{r['within_tolerance']}); registers {r['registers']}, "
              f"spill stores {r['spill_store_bytes']} B")
    print(f"gram_big: the shipped design's four readings span "
          f"{result['gram_big_shipped_spread_ms']:.4f} ms ({smi})")
    del g, ref, scale
    torch.cuda.empty_cache()

    # ---- gather ------------------------------------------------------------
    src, idx = eg.make_inputs(dev)
    plain = eg.gather_rows_reference(src, idx)
    direct = _gather_direct(libs["direct"])
    for name, fn in (("shipped", eg.gather_rows), ("direct", direct)):
        if not torch.equal(fn(src, idx), plain):
            raise RuntimeError(f"gather {name} differs from its plain version")
    ms = two_passes({
        "shipped": (eg.gather_rows, [src, idx]),
        "direct": (direct, [src, idx]),
        "take_along_dim": (lambda s, i: torch.take_along_dim(s, i, dim=0),
                           [src, idx.long()]),
        "empty kernel": (lambda s, i: eg.empty_launch(s.device), [src, idx]),
    })
    regs, spill = usage["direct"]
    result["gather"] = {name: {"ms": v} for name, v in ms.items()}
    result["gather"]["direct"].update(registers=regs, spill_store_bytes=spill)
    for name, v in ms.items():
        print(f"gather {name:14s}: {v[0]:.4f} / {v[1]:.4f} ms (two passes, "
              f"graph, from HBM)")
    spread = max(ms["shipped"]) - min(ms["shipped"])
    print(f"gather: direct design {regs} registers, spill stores {spill} B; "
          f"the shipped kernel's readings span {spread:.4f} ms ({smi})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
