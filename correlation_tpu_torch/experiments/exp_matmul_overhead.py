"""The fused assembly's stages as separate kernels, timed on the card.

Port of experiments/exp_matmul_overhead.py, a TPU experiment that timed
the assembly kernel's stages one by one.  Each variant is a hand-written
CUDA kernel (csrc/exp_stages.cu) with a wrapper and a plain PyTorch
version here:

  loop       a[g, b]^T o[g, b] per subset on the tensor cores, a block
             walking its B subsets
  batched    the same product by the same routine, one block per subset
  gram_loop  the 8 x 8 Gram of each subset's [8, P] rows, a warp a subset
  gram_big   the same Gram from packed products on the tensor cores: two
             subsets' 16 rows against each subset's 8, TF32 in the
             3xTF32 split, keeping the diagonal blocks
  vpu        the column weights and three multiply-reduce stages

Sizes as in the JAX script: G = 256 steps of B = 8 subsets, K = 120,
M = 128, P = 512, TW = 32.  Inputs are numpy's default_rng(i)
standard_normal(shape) * 0.1 for the i-th input, in bfloat16 for loop and
batched, float32 otherwise.

Run on a machine with an NVIDIA GPU:

  python -m correlation_tpu_torch.experiments.exp_matmul_overhead [loop batched gram vpu]

For each variant it prints the JAX script's `name: ms total, us/step`
line for the kernel, the plain version and, for loop and batched, the one
PyTorch call that computes the product (product_library: torch.bmm with
out_dtype=float32, the yardstick), device time from a CUDA graph followed
by the eager time with the host's issue cost, with the card's name and
power limit; without a CUDA device it exits with 1.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

B, K, M, P = 8, 120, 128, 512
G = 256
TW = 32
NAMES = ("loop", "batched", "gram_loop", "gram_big", "vpu")
# The product kernel stages a subset's a [K, M] whole in shared memory.
MAX_K = MAX_M = 128

# Kernel launches by each wrapper (CUDA tensors only); callers reset them.
LAUNCHES = dict.fromkeys(NAMES, 0)


def input_shapes(name: str, g: int = G) -> tuple[list[tuple], torch.dtype]:
    """The variant's input shapes for `g` steps, and their dtype."""
    if name in ("loop", "batched"):
        return [(g, B, K, M), (g, B, K, P)], torch.bfloat16
    if name in ("gram_loop", "gram_big"):
        return [(g, B, 8, P)], torch.float32
    if name == "vpu":
        return [(g, B, 4 * TW, P), (g, B, 1, P)], torch.float32
    raise ValueError(f"unknown variant {name!r}")


def make_inputs(name: str, device, g: int = G) -> list[torch.Tensor]:
    """The JAX script's inputs: input i is default_rng(i).standard_normal *
    0.1, rounded to float32 and then, for loop / batched, to bfloat16."""
    shapes, dtype = input_shapes(name, g)
    return [
        torch.from_numpy(np.random.default_rng(i).standard_normal(s) * 0.1)
        .to(torch.float32).to(device).to(dtype)
        for i, s in enumerate(shapes)
    ]


# ---- plain versions ------------------------------------------------------

def product_reference(a: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """[G, B, M, P] = a[g, b]^T o[g, b] in float32."""
    return torch.einsum("gbkm,gbkp->gbmp", a.float(), o.float())


def gram_reference(g: torch.Tensor) -> torch.Tensor:
    """[G, B, 8, 8] Gram of each subset's [8, P] rows."""
    return torch.einsum("gbip,gbjp->gbij", g, g)


def vpu_reference(sel: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """The column weights from d = c - int(rx) and the three multiply-
    reduces over TW columns: sel [G, B, 4 TW, P], rx [G, B, 1, P] ->
    [G, B, 3, P], step for step as the Pallas body."""
    c_sub = torch.arange(TW, dtype=torch.int32, device=sel.device)[:, None]
    d = c_sub - rx.to(torch.int32)  # [G, B, TW, P]
    w_col = torch.zeros(d.shape, dtype=torch.float32, device=sel.device)
    w_col_d = torch.zeros_like(w_col)
    for kk in range(4):
        m = (d == kk).to(torch.float32)
        w_col = w_col + m * 0.3
        w_col_d = w_col_d + m * 0.1
    tmp = sel[:, :, 0:TW]
    tmp_d = sel[:, :, TW : 2 * TW]
    for j in range(1, 4):
        tmp = tmp + 0.25 * sel[:, :, j * TW : (j + 1) * TW]
        tmp_d = tmp_d + 0.1 * sel[:, :, j * TW : (j + 1) * TW]
    w_v = (w_col * tmp).sum(dim=2)
    dwdx = (w_col_d * tmp).sum(dim=2)
    dwdy = (w_col * tmp_d).sum(dim=2)
    return torch.stack([w_v, dwdx, dwdy], dim=2)


def product_library(a: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes the product: torch.bmm with
    out_dtype=float32, bf16 x bf16 -> float32 on the tensor cores (CUDA
    only).  A yardstick for the kernels' time; the port never calls it."""
    g, b, k, m = a.shape
    p = o.shape[3]
    return torch.bmm(a.view(g * b, k, m).transpose(1, 2),
                     o.view(g * b, k, p),
                     out_dtype=torch.float32).view(g, b, m, p)


def terms_scale(name: str, inputs: list[torch.Tensor]) -> torch.Tensor:
    """Per output, the sum of the absolute values of the terms it adds up:
    the plain version on |inputs| (every weight is non-negative)."""
    ref = REFERENCES[name]
    if name == "vpu":
        return ref(inputs[0].abs(), inputs[1])
    return ref(*(x.abs() for x in inputs))


def agreement(got, ref, scale, rtol: float = 1e-5) -> tuple[bool, float]:
    """Whether |got - ref| <= rtol * scale everywhere (sums that differ
    only in their order), and the largest |got - ref|."""
    diff = (got.float() - ref.float()).abs()
    return bool((diff <= rtol * scale).all()), float(diff.max())


# ---- kernels ---------------------------------------------------------------

def _check(tensors, dtype, shapes_ok: bool, what: str):
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{what}: need {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if not shapes_ok:
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _launch(name: str, fn, out: torch.Tensor, *args):
    from correlation_tpu_torch.ops._build import check_launch, load_library

    ptr = ctypes.c_void_p
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = getattr(load_library(), fn)(
        *(ptr(a.data_ptr()) if torch.is_tensor(a) else a for a in args),
        ptr(out.data_ptr()), ptr(stream),
    )
    check_launch(rc, name)
    LAUNCHES[name] += 1
    return out


def _product(name: str, a: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    ok = a.dim() == o.dim() == 4 and a.shape[:3] == o.shape[:3]
    dev = _check([a, o], torch.bfloat16, ok, name)
    if a.shape[2] > MAX_K or a.shape[3] > MAX_M:
        raise ValueError(f"{name}: K = {a.shape[2]}, M = {a.shape[3]}; the "
                         f"kernel takes K <= {MAX_K} and M <= {MAX_M}")
    if dev.type == "cpu":
        return product_reference(a, o)
    g, b, k, m = a.shape
    p = o.shape[3]
    out = torch.empty((g, b, m, p), dtype=torch.float32, device=a.device)
    return _launch(name, "stage_product_launch", out, int(name == "batched"),
                   a, o, g, b, k, m, p)


def stage_loop(a: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """a [G, B, K, M], o [G, B, K, P] bfloat16 -> [G, B, M, P] float32; on
    the card a block per g walks its B subsets."""
    return _product("loop", a, o)


def stage_batched(a: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """As stage_loop; on the card one block per subset."""
    return _product("batched", a, o)


def _gram(name: str, g: torch.Tensor) -> torch.Tensor:
    ok = g.dim() == 4 and g.shape[2] == 8
    if _check([g], torch.float32, ok, name).type == "cpu":
        return gram_reference(g)
    out = torch.empty(g.shape[:2] + (8, 8), dtype=torch.float32,
                      device=g.device)
    return _launch(name, "stage_gram_launch", out, int(name == "gram_big"),
                   g, g.shape[0], g.shape[1], g.shape[3])


def stage_gram_loop(g: torch.Tensor) -> torch.Tensor:
    """g [G, B, 8, P] float32 -> [G, B, 8, 8]; on the card a warp a subset."""
    return _gram("gram_loop", g)


def stage_gram_big(g: torch.Tensor) -> torch.Tensor:
    """As stage_gram_loop; on the card a block per pair of subsets packs
    them into one tensor-core product (csrc/exp_stages.cu)."""
    return _gram("gram_big", g)


def stage_vpu(sel: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """sel [G, B, 4 TW, P], rx [G, B, 1, P] float32 -> [G, B, 3, P]."""
    ok = (sel.dim() == rx.dim() == 4 and sel.shape[2] == 4 * TW
          and rx.shape == sel.shape[:2] + (1, sel.shape[3]))
    if _check([sel, rx], torch.float32, ok, "vpu").type == "cpu":
        return vpu_reference(sel, rx)
    g, b, _, p = sel.shape
    out = torch.empty((g, b, 3, p), dtype=torch.float32, device=sel.device)
    return _launch("vpu", "stage_vpu_launch", out, sel, rx, g, b, p)


KERNELS = {
    "loop": stage_loop,
    "batched": stage_batched,
    "gram_loop": stage_gram_loop,
    "gram_big": stage_gram_big,
    "vpu": stage_vpu,
}
REFERENCES = {
    "loop": product_reference,
    "batched": product_reference,
    "gram_loop": gram_reference,
    "gram_big": gram_reference,
    "vpu": vpu_reference,
}
# One PyTorch call computing each variant's function, as (name, fn), or
# None where the function takes a chain of calls.
LIBRARY = {
    "loop": ("torch.bmm(out_dtype=float32)", product_library),
    "batched": ("torch.bmm(out_dtype=float32)", product_library),
    "gram_loop": ("torch.einsum", gram_reference),
    "gram_big": ("torch.einsum", gram_reference),
    "vpu": None,
}


def main(argv=None) -> int:
    which = (sys.argv[1:] if argv is None else argv) or [
        "loop", "batched", "gram", "vpu"]
    if not torch.cuda.is_available():
        print("exp_matmul_overhead: needs a CUDA device", file=sys.stderr)
        return 1
    from correlation_tpu_torch.utils.profiling import (
        card_name_and_power,
        cuda_time_ms,
        graph_ms,
    )

    print(f"card: {card_name_and_power()}")
    names = [n for n in NAMES
             if n in which or (n.startswith("gram") and "gram" in which)]
    for name in names:
        inputs = make_inputs(name, torch.device("cuda"))
        rows = [(name, KERNELS[name]), (f"{name}/plain", REFERENCES[name])]
        if name in ("loop", "batched"):
            rows.append((f"{name}/library", product_library))
        for label, fn in rows:
            ms = graph_ms(lambda fn=fn: fn(*inputs))
            eager = cuda_time_ms(lambda fn=fn: fn(*inputs))
            print(f"{label:16s}: {ms:8.3f} ms total, {ms / G * 1e3:8.2f} "
                  f"us/step (graph); eager {eager:8.3f} ms")
        del inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
