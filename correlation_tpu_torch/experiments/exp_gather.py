"""The per-column row gather out[i, j] = src[idx[i, j], j].

Port of experiments/exp_gather.py, a TPU experiment on a per-lane sublane
gather inside a Pallas kernel.  On the card the same gather is the fused
assembly's tile read, and `gather_rows` launches the hand-written CUDA
kernel csrc/exp_gather.cu: a block stages a 32-column slab of src in
shared memory and gathers from it.  `gather_rows_reference` is its plain
PyTorch version.

Run on a machine with an NVIDIA GPU:

  python -m correlation_tpu_torch.experiments.exp_gather

It prints the JAX script's line (the kernel's result against NumPy's
take_along_axis), then the device time from a CUDA graph, inputs read from
HBM (utils/profiling.graph_ms_cold), of the kernel, of the plain version,
of one torch.take_along_dim call and of a launch that does nothing
(empty_launch), with the card's name and power limit; without a CUDA
device it exits with 1.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

TH, P, N = 64, 512, 16  # src rows, columns, gathered rows

# Kernel launches by gather_rows (CUDA tensors only); callers reset it.
LAUNCHES = 0


def make_inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's inputs: src [TH, P] float32, idx [N, P] int32."""
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.standard_normal((TH, P))).to(torch.float32)
    idx = torch.from_numpy(rng.integers(0, TH, (N, P))).to(torch.int32)
    return src.to(device), idx.to(device)


def gather_rows_reference(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of gather_rows."""
    return torch.take_along_dim(src, idx.long(), dim=0)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = src[idx[i, j], j]: src [R, C] float32, idx [N, C] int32.

    CUDA tensors launch the CUDA kernel, CPU tensors run the plain version.
    An index outside [0, R) raises IndexError on the CPU; on the card it
    stops the kernel like a device-side assert, and the next synchronising
    call raises.
    """
    global LAUNCHES
    if src.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"need float32 src and int32 idx, got {src.dtype}, "
                        f"{idx.dtype}")
    if src.dim() != 2 or idx.dim() != 2 or idx.shape[1] != src.shape[1]:
        raise ValueError(f"src {tuple(src.shape)} and idx {tuple(idx.shape)} "
                         "must be [R, C] and [N, C]")
    if src.device != idx.device:
        raise ValueError(f"src on {src.device}, idx on {idx.device}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("src and idx must be contiguous")
    if src.device.type == "cpu":
        # take_along_dim wraps negative indices and does not check the
        # upper bound on the CPU.
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
            raise IndexError(f"idx outside [0, {src.shape[0]})")
        return gather_rows_reference(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    from correlation_tpu_torch.ops._build import check_launch, load_library

    lib = load_library()
    out = torch.empty(idx.shape, dtype=torch.float32, device=src.device)
    ptr = ctypes.c_void_p
    rc = lib.gather_rows_launch(
        ptr(src.data_ptr()), ptr(idx.data_ptr()), src.shape[0], src.shape[1],
        idx.shape[0], ptr(out.data_ptr()),
        ptr(torch.cuda.current_stream(src.device).cuda_stream),
    )
    check_launch(rc, "gather_rows")
    LAUNCHES += 1
    return out


def empty_launch(device) -> None:
    """Launch a CUDA kernel that does nothing on the current stream: the
    floor under any kernel's time.  Not counted."""
    from correlation_tpu_torch.ops._build import check_launch, load_library

    stream = torch.cuda.current_stream(device).cuda_stream
    check_launch(load_library().empty_kernel_launch(ctypes.c_void_p(stream)),
                 "empty")


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_gather: needs a CUDA device", file=sys.stderr)
        return 1
    from correlation_tpu_torch.utils.profiling import (
        card_name_and_power,
        graph_ms_cold,
    )

    src, idx = make_inputs(torch.device("cuda"))
    ref = np.take_along_axis(src.cpu().numpy(), idx.cpu().numpy(), axis=0)
    out = gather_rows(src, idx).cpu().numpy()
    print("take_along_axis sublane gather: OK, max err", np.abs(out - ref).max())
    fns = {  # name: (fn, its inputs); take_along_dim takes int64 indices
        "kernel": (gather_rows, [src, idx]),
        "plain": (gather_rows_reference, [src, idx]),
        "take_along_dim": (lambda s, i: torch.take_along_dim(s, i, dim=0),
                           [src, idx.long()]),
        "empty kernel": (lambda s, i: empty_launch(s.device), [src, idx]),
    }
    times = "; ".join(f"{k} {graph_ms_cold(fn, ins):.4f} ms"
                      for k, (fn, ins) in fns.items())
    print(f"gather_rows [{N}, {P}] from [{TH}, {P}], graph, from HBM: "
          f"{times} ({card_name_and_power()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
