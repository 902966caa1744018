"""Time the designs that the port's kernels were chosen over.

Run on a machine with an NVIDIA GPU, from the root of a checkout:

  python -m correlation_tpu_torch.experiments.design_sweep [k1] [gram_big] [gather]

(all three when none is named).  Every time is read in two passes, the
second in the reverse order of the first:

  k1        the fused assembly (csrc/fused_assemble.cu) at the three
            pyramid levels of the dense-grid problem (4096 subsets,
            AFFINE / BICUBIC, C = 1; 448 / 128 / 40 padded pixels), from
            CUDA graphs (utils/profiling.graph_ms, as chip_smoke.py's phase
            6): the shipped kernel (the kernel library, each level on the
            path assemble_v2.subset_threads picks), the source rebuilt
            with ptxas's report and run on each of its two paths, and the
            first design, a 128-thread block a subset
            (csrc/design_sweep.cu).  Each design is checked bit for bit
            against the plain version summing in its own order; ptxas's
            registers and spill stores are read for the AFFINE / BICUBIC /
            C = 1 kernels, and the spill stores of every model /
            interpolation / channel kernel of the build are summed (the
            kernels that spill are named).  Then the split path on the
            blob's three levels (problems.blob_problem, one subset of
            71,264 / 17,816 / 4,456 padded pixels): spans of 128 to 2048
            pixels (SPANS) and one block a subset through the rebuilt
            source, beside the shipped kernel, each bit for bit against
            the plain version of its order, with the span kernels'
            registers and spill stores.
  gram_big  csrc/exp_stages.cu rebuilt with GRAM_BIG_WARPS warps a pair of
            subsets (1, 2, 4, 8) and GRAM_BIG_DEPTH chunks in flight a warp
            (1, 2, 4), beside the shipped kernel (the source's defaults,
            from the kernel library) and torch.einsum, from HBM
            (utils/profiling.graph_ms_cold): time, max |kernel - plain|
            against the 1e-5 x sum |terms| tolerance, and registers and
            spill stores from ptxas.
  gather    the shipped kernel (csrc/exp_gather.cu, src staged in shared
            memory) beside the direct design (csrc/design_sweep.cu),
            torch.take_along_dim and an empty kernel, from HBM.

The shipped K1 and gram_big are each read four times (twice themselves,
twice as the rebuild of their source on the shipped path or design) and
the shipped gather twice; the spread of those readings is the noise the others are read
against.  Prints a line per design, the card's name and power limit, and
last a JSON line with every reading; without a CUDA device it exits with
1.  The libraries it builds go to build/design_sweep/.
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
from correlation_tpu_torch.ops import assemble_v2 as v2

SECTIONS = ("k1", "gram_big", "gather")
WARPS = (1, 2, 4, 8)
DEPTHS = (1, 2, 4)
# ptxas names of K1's AFFINE / BICUBIC / C = 1 kernels.
K1_KERNELS = {"warp": "fused_assemble_warpILi3ELi2ELi1EE",
              "block": "fused_assemble_blockILi3ELi2ELi1EE",
              "first": "fused_assemble_kernelILi3ELi2ELi1EE"}
K1_SPLIT_KERNELS = {"span": "fused_assemble_spanILi3ELi2ELi1EE",
                    "sum": "fused_assemble_span_sumILi3EE"}
# Span lengths (pixels a block) the split path is timed at.
SPANS = (128, 256, 512, 1024, 2048)
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


def ptxas_entries(log: str) -> dict:
    """{mangled kernel name: (registers, spill-store bytes)} from nvcc
    -Xptxas -v output."""
    lines = log.splitlines()
    out = {}
    for k, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if not m:
            continue
        spill = None
        for nxt in lines[k + 1:k + 6]:
            s = re.search(r"(\d+) bytes spill stores", nxt)
            if s:
                spill = int(s.group(1))
            r = re.search(r"Used (\d+) registers", nxt)
            if r:
                out[m.group(1)] = (int(r.group(1)), spill)
                break
    return out


def ptxas_usage(log: str, kernel: str) -> tuple[int | None, int | None]:
    """(registers, spill-store bytes) of the first kernel whose mangled
    name holds `kernel`, from nvcc -Xptxas -v output."""
    for name, usage in ptxas_entries(log).items():
        if kernel in name:
            return usage
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


def k1_design(lib, what: str, threads: int | None,
              chunk: int | None = None):
    """fused_assemble's arguments -> [S, 8, 8] through `lib`: the
    fused_assemble_launch of a build of csrc/fused_assemble.cu on the path
    of `threads`, spans of `chunk` pixels a block (by default p_len: one
    block a subset, the design before the split path), or the first
    design (threads None).  It sums in the order of
    assemble_v2.fused_assemble_reference(..., threads=, chunk=)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    body = [vp, i32, i32, i32, i32, vp, i32, vp, vp, vp, vp, i32, i32, i32,
            i32]
    if threads is None:
        launch = _launcher(lib, "fused_assemble_first_launch",
                           [i32] * 3 + body)
    else:
        # The shipped launcher takes the list's device length after idx.
        launch = _launcher(lib, "fused_assemble_launch",
                           [i32] * 5 + body[:11] + [vp] + body[11:]
                           + [vp, ctypes.c_longlong])

    def assemble(model, interp, th, tw, img_h, img_w, img, pix, center,
                 params, bbox):
        n = params.shape[0]
        out = torch.empty((n, 8, 8), dtype=torch.float32, device=img.device)
        hp, wp, c = img.shape
        p_len = pix.shape[2]
        args = [img.data_ptr(), hp, wp, img_h, img_w, pix.data_ptr(), p_len,
                center.data_ptr(), params.data_ptr(), bbox.data_ptr(), None,
                n, n, th, tw]
        if threads is None:
            return _run(launch, what, out, int(model), int(interp), c, *args)
        span = v2.subset_span(p_len, chunk or p_len)
        work = v2.span_workspace(n, params.shape[1], -(-p_len // span),
                                 img.device)
        return _run(launch, what, out, int(model), int(interp), c, threads,
                    span, *args[:11], None, *args[11:],
                    None if work is None else work.data_ptr(),
                    0 if work is None else work.numel())
    return assemble


def two_passes(fns: dict, cold: bool = True) -> dict:
    """{name: [ms, ms]} for fns {name: (fn, inputs)}: each timed in the
    order given, then again in the reverse order; from HBM
    (graph_ms_cold) when `cold`, else as graph_ms."""
    from correlation_tpu_torch.utils.profiling import graph_ms, graph_ms_cold

    ms = {name: [] for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            fn, inputs = fns[name]
            ms[name].append(graph_ms_cold(fn, inputs) if cold
                            else graph_ms(lambda: fn(*inputs)))
    return ms


def k1_section(libs: dict, logs: dict, smi: str, dev) -> tuple[dict, bool]:
    """K1's designs at the three bench levels; returns (readings, whether
    every design equals the plain version of its own order)."""
    import numpy as np

    from correlation_tpu_torch.ops.pyramid import build_pyramid
    from correlation_tpu_torch.problems import (
        assembly_levels,
        dense_grid_problem,
    )

    cfg, und, dfm, batch, _ = dense_grid_problem(4096)
    pair = torch.as_tensor(np.stack([und, dfm])[..., None], device=dev)
    levels = assembly_levels(cfg, batch, build_pyramid(pair, cfg.pyramid.stop),
                             dev)
    del pair
    def build_spills(log):
        return {k: v[1] for k, v in ptxas_entries(log).items()
                if "fused_assemble_" in k and v[1]}

    # name -> (assemble, threads: None for the rule, ptxas usage, spill
    # stores of every kernel of its build)
    designs = {"shipped": (v2.fused_assemble, None, (None, None), None)}
    lib, log = libs["k1"], logs["k1"]
    for path, threads in (("warp", v2.WARP_LANES),
                          ("block", v2.BLOCK_THREADS)):
        designs[f"source/{path}"] = (
            k1_design(lib, f"K1 source/{path}", threads), threads,
            ptxas_usage(log, K1_KERNELS[path]),
            sum(build_spills(log).values()))
    designs["first"] = (k1_design(libs["sweep"], "K1 first", None), 128,
                        ptxas_usage(logs["sweep"], K1_KERNELS["first"]),
                        sum(build_spills(logs["sweep"]).values()))
    spilling = build_spills(log)
    spills = sum(spilling.values())
    result = {"build_spill_store_bytes": spills,
              "build_spilling_kernels": spilling}
    all_same = True
    for lvl, args in sorted(levels.items()):
        p_len = args[7].shape[2]
        rule = v2.subset_threads(p_len)
        refs, rows = {}, {}
        for name, (fn, threads, (regs, spill), build) in designs.items():
            t = rule if threads is None else threads
            if t not in refs:
                refs[t] = v2.fused_assemble_reference(*args, threads=t)
            same = bool(torch.equal(fn(*args), refs[t]))
            all_same &= same
            rows[name] = {"threads": t, "bit_identical": same,
                          "registers": regs, "spill_store_bytes": spill,
                          "build_spill_store_bytes": build}
        del refs
        ms = two_passes({name: (d[0], list(args)) for name, d in
                         designs.items()}, cold=False)
        for name, v in ms.items():
            rows[name]["ms"] = v
        twin = ("source/warp" if p_len <= v2.WARP_MAX_PIXELS
                else "source/block")
        shipped = rows["shipped"]["ms"] + rows[twin]["ms"]
        spread = max(shipped) - min(shipped)
        beats = [rows["first"]["ms"][i] - rows["shipped"]["ms"][i] > spread
                 for i in (0, 1)]
        key = f"L{lvl}"
        result[key] = {"p_len": p_len, "shipped_threads": rule,
                       "shipped_spread_ms": spread,
                       "shipped_beats_first_by_more_than_spread": beats,
                       "designs": rows}
        for name, r in rows.items():
            print(f"K1 {key} {name:22s} ({r['threads']:3d} threads): "
                  f"{r['ms'][0]:.6f} / {r['ms'][1]:.6f} ms (two passes, "
                  f"graph); bit-identical to its order: {r['bit_identical']};"
                  f" registers {r['registers']}, spill stores "
                  f"{r['spill_store_bytes']} B ({r['build_spill_store_bytes']}"
                  f" B in its build)")
        print(f"K1 {key}: {p_len} padded pixels, shipped path {rule} "
              f"threads; its four readings span {spread:.6f} ms; beats the "
              f"first design by more than that in passes 1 / 2: {beats} "
              f"({smi})")
    print(f"K1: spill stores over every kernel of its build: "
          f"{spills} B {sorted(spilling)}")
    return result, all_same


def k1_split_section(lib, log: str, smi: str, dev) -> tuple[dict, bool]:
    """K1 on the three levels of the blob (problems.blob_problem: one
    subset of 71,264 / 17,816 / 4,456 padded pixels, AFFINE / BICUBIC,
    C = 1): the shipped kernel (its split rule), and through `lib`, the
    rebuilt source, the split path at each span length of SPANS below
    p_len and one block a subset (chunk = p_len, the design before the
    split path), each bit for bit against the plain version of its
    order; returns (readings, whether every design equals it)."""
    from correlation_tpu_torch.domains import make_batch
    from correlation_tpu_torch.ops.pyramid import build_pyramid
    from correlation_tpu_torch.problems import assembly_levels, blob_problem

    cfg, frames, pts, _ = blob_problem(1)
    pyr = build_pyramid(torch.as_tensor(frames, device=dev).float(),
                        cfg.pyramid.stop)
    levels = assembly_levels(cfg, make_batch(pts, None, cfg.pyramid.stop),
                             pyr, dev)
    del pyr
    usage = {name: ptxas_usage(log, kernel)
             for name, kernel in K1_SPLIT_KERNELS.items()}
    result = {"registers_spill_stores": usage}
    all_same = True
    for lvl, args in sorted(levels.items()):
        p_len = args[7].shape[2]
        chunks = {f"chunk {c}": c for c in SPANS if c < p_len}
        chunks.update({"shipped": None, "one block": p_len})
        rows, fns = {}, {}
        for name, c in chunks.items():
            fn = (v2.fused_assemble if c is None else
                  k1_design(lib, f"K1 {name}", v2.BLOCK_THREADS, c))
            same = bool(torch.equal(
                fn(*args), v2.fused_assemble_reference(*args, chunk=c)))
            all_same &= same
            span = v2.subset_span(p_len, c)
            rows[name] = {"chunk": span, "spans": -(-p_len // span),
                          "bit_identical": same}
            fns[name] = (fn, list(args))
        for name, ms in two_passes(fns, cold=False).items():
            rows[name]["ms"] = ms
        result[f"L{lvl}"] = {"p_len": p_len, "designs": rows}
        for name, r in rows.items():
            print(f"K1 blob L{lvl} {name:10s} ({r['spans']:3d} spans of "
                  f"{r['chunk']:5d} px): {r['ms'][0]:.6f} / {r['ms'][1]:.6f}"
                  f" ms (two passes, graph); bit-identical to its order: "
                  f"{r['bit_identical']} ({smi})")
    print(f"K1 split path, ptxas (AFFINE / BICUBIC / C = 1): "
          + ", ".join(f"{k} kernel {v[0]} registers, {v[1]} B spill stores"
                      for k, v in usage.items()))
    return result, all_same


def main(argv: list[str] = ()) -> int:
    """Run the sections named in `argv` (all when empty)."""
    sections = list(argv) or list(SECTIONS)
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        print(f"design_sweep: unknown sections {sorted(unknown)}; choose "
              f"from {SECTIONS}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("design_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    from correlation_tpu_torch.utils.profiling import card_name_and_power

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    builds = {}
    if "gram_big" in sections:
        builds.update({
            f"w{w}_d{d}": _compile(CSRC / "exp_stages.cu",
                                   f"gram_big_w{w}_d{d}",
                                   [f"GRAM_BIG_WARPS={w}",
                                    f"GRAM_BIG_DEPTH={d}"])
            for w in WARPS for d in DEPTHS
        })
    if "k1" in sections:
        builds["k1"] = _compile(CSRC / "fused_assemble.cu", "k1", [])
    if "k1" in sections or "gather" in sections:
        builds["sweep"] = _compile(CSRC / "design_sweep.cu", "design_sweep", [])
    _build.load_library()
    libs, logs = {}, {}
    for name, (path, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(path))
        logs[name] = log
    smi = card_name_and_power()
    dev = torch.device("cuda")
    result = {"card": smi}
    ok = True
    if "k1" in sections:
        result["k1"], ok = k1_section(libs, logs, smi, dev)
        result["k1_split"], split_ok = k1_split_section(
            libs["k1"], logs["k1"], smi, dev)
        ok &= split_ok
        torch.cuda.empty_cache()
    if "gram_big" in sections:
        result.update(gram_big_section(libs, logs, smi, dev))
        torch.cuda.empty_cache()
    if "gather" in sections:
        result["gather"] = gather_section(libs, logs, smi, dev)
    print(json.dumps(result))
    if not ok:
        print("design_sweep: a K1 design differs from the plain version of "
              "its order", file=sys.stderr)
    return 0 if ok else 1


def gram_big_section(libs: dict, logs: dict, smi: str, dev) -> dict:
    """gram_big's designs; returns their readings."""
    g = em.make_inputs("gram_big", dev)[0]
    ref = em.gram_reference(g)
    scale = em.terms_scale("gram_big", [g])
    grams = {"shipped": em.stage_gram_big}
    grams.update({f"w{w}_d{d}": _gram_variant(libs[f"w{w}_d{d}"],
                                              f"gram_big w{w}_d{d}")
                  for w in WARPS for d in DEPTHS})
    grams["einsum"] = em.gram_reference
    rows = {}
    for name, fn in grams.items():
        ok, err = em.agreement(fn(g), ref, scale)
        regs, spill = (ptxas_usage(logs[name], "stage_gram_big_kernelILb1E")
                       if name in logs else (None, None))
        rows[name] = {"within_tolerance": ok, "max_abs_err": err,
                      "registers": regs, "spill_store_bytes": spill}
    for name, ms in two_passes({n: (fn, [g]) for n, fn in grams.items()}
                               ).items():
        rows[name]["ms"] = ms
    twin = shipped_gram_big((CSRC / "exp_stages.cu").read_text())
    shipped = rows["shipped"]["ms"] + rows[twin]["ms"]
    for name, r in rows.items():
        print(f"gram_big {name:8s}: {r['ms'][0]:.4f} / {r['ms'][1]:.4f} ms "
              f"(two passes, graph, from HBM); max |kernel - plain| "
              f"{r['max_abs_err']:.3e} (within 1e-5 x sum |terms|: "
              f"{r['within_tolerance']}); registers {r['registers']}, "
              f"spill stores {r['spill_store_bytes']} B")
    spread = max(shipped) - min(shipped)
    print(f"gram_big: the shipped design's four readings span "
          f"{spread:.4f} ms ({smi})")
    return {"gram_big": rows, "gram_big_shipped_spread_ms": spread}


def gather_section(libs: dict, logs: dict, smi: str, dev) -> dict:
    """The gather's designs; returns their readings."""
    src, idx = eg.make_inputs(dev)
    plain = eg.gather_rows_reference(src, idx)
    direct = _gather_direct(libs["sweep"])
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
    regs, spill = ptxas_usage(logs["sweep"], "gather_rows_direct_kernelILb1E")
    out = {name: {"ms": v} for name, v in ms.items()}
    out["direct"].update(registers=regs, spill_store_bytes=spill)
    for name, v in ms.items():
        print(f"gather {name:14s}: {v[0]:.4f} / {v[1]:.4f} ms (two passes, "
              f"graph, from HBM)")
    spread = max(ms["shipped"]) - min(ms["shipped"])
    print(f"gather: direct design {regs} registers, spill stores {spill} B; "
          f"the shipped kernel's readings span {spread:.4f} ms ({smi})")
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
