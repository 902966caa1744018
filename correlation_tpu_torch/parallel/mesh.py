"""Subset-sharded data parallelism over torch.distributed.

Port of correlation_tpu/parallel/mesh.py.  One process per card: a
launcher (torchrun, or anything that sets RANK, WORLD_SIZE, LOCAL_RANK and
MASTER_ADDR / MASTER_PORT) starts one process a card, init_distributed
joins them in a process group and make_mesh names the rank's place in it.

Every rank receives the caller's S subsets in the caller's order (where
JAX hands one global array to its single controller).  The subset axis
pads to a multiple of the mesh size with fully masked rows (pad_to_mesh),
each rank solves its contiguous slice (shard_inputs) on its own device,
images and pyramids are the same on every rank (replicate), and the
results all-gather in rank order and lose the padding (gather_rows).
There is no collective inside the LM loop: each shard's loop stops on its
own, as JAX's shard_map bodies do.  A shard keeps the whole batch's padded
point counts and extents, so it assembles in the same order and with the
same tiles as the unsharded solve, and the sharded solve equals it bit
for bit.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from correlation_tpu_torch.domains import SubsetBatch

SUBSET_AXIS = "subsets"

# Seconds a collective waits for the other ranks before it raises: short,
# so a rank that died or raised alone ends the run instead of hanging it
# for torch's default of ten minutes or more.
DEFAULT_TIMEOUT_S = 120.0

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in a 1-D mesh of processes.

    group: the process group, or None for a world of one (no collective
    runs); rank: this process's index in it; size: the number of ranks;
    device: where this rank solves.
    """

    group: object | None
    rank: int
    size: int
    device: torch.device


def _backend_for(device) -> str:
    dev = torch.device(device if device is not None else "cuda")
    return "nccl" if dev.type == "cuda" else "gloo"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    device=None,
) -> bool:
    """Join this process to the default process group.

    coordinator_address ("host:port"), num_processes and process_id name
    the rendezvous; without them the launcher's environment does (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  A no-op returning False when
    neither arguments nor that environment announce several processes,
    so a run of one needs no special casing; True once the group exists.

    backend: "nccl" or "gloo"; by default NCCL when the ranks solve on a
    card (device None or a CUDA device) and gloo when `device` is the CPU.
    A failed NCCL init raises; it never falls back to gloo.  Two ranks that
    share one card must name gloo, since NCCL refuses them.  timeout: the
    seconds a collective waits for the other ranks.
    """
    if dist.is_initialized():
        return True
    env_says_cluster = all(os.environ.get(k) for k in _LAUNCHER_ENV)
    if (coordinator_address is None and num_processes is None
            and not env_says_cluster):
        return False
    backend = backend or _backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the NCCL backend needs a CUDA device and none is "
                "available; pass device='cpu' (gloo) to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    dist.init_process_group(
        backend=backend, timeout=datetime.timedelta(seconds=timeout),
        **kwargs)
    return True


def make_mesh(device=None) -> Mesh:
    """The mesh over the default process group when one is initialised,
    else a world of one.

    device: where this rank solves; by default its card,
    cuda:{LOCAL_RANK} (made the current device), raising RuntimeError
    where there is none.  Pass "cpu" to solve on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the mesh solves on a CUDA device and none is available; "
                "pass device='cpu' to solve on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return Mesh(None, 0, 1, device)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                device)


def padded_count(num_subsets: int, mesh: Mesh) -> int:
    """The subset count rounded up to a multiple of the mesh size."""
    return -(-num_subsets // mesh.size) * mesh.size


def _pad_rows(a, target: int):
    """`a` with zero rows appended along axis 0 up to `target` rows."""
    pad = target - a.shape[0]
    if pad == 0:
        return a
    if torch.is_tensor(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    a = np.asarray(a)
    return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))


def shard_rows(mesh: Mesh, a):
    """This rank's contiguous slice of `a` (numpy or tensor, None passes)
    along axis 0, after padding it with zero rows to padded_count."""
    if a is None:
        return None
    a = _pad_rows(a, padded_count(a.shape[0], mesh))
    per = a.shape[0] // mesh.size
    return a[mesh.rank * per:(mesh.rank + 1) * per]


def pad_to_mesh(batch: SubsetBatch, mesh: Mesh) -> SubsetBatch:
    """Pad the subset axis to a multiple of the mesh size.

    Padding subsets are fully masked (no points, center 0), resolve to
    BAD_DOMAIN in the engine and are dropped by gather_rows.  The padded
    point counts and the extents are the batch's, so the tiles and the
    order of every real subset's sums do not change.
    """
    target = padded_count(batch.num_subsets, mesh)
    return SubsetBatch(
        xy=[_pad_rows(a, target) for a in batch.xy],
        mask=[_pad_rows(a, target) for a in batch.mask],
        center0=_pad_rows(batch.center0, target),
        extents=batch.extents,
    )


def shard_inputs(mesh: Mesh, batch: SubsetBatch, params0):
    """This rank's contiguous slice of the batch, padded to the mesh
    (pad_to_mesh), and of the [S, NP] guesses, on the rank's device.

    Returns (SubsetBatch, params0 float32 tensor).  The slice keeps the
    whole batch's padded point counts and extents.
    """
    padded = pad_to_mesh(batch, mesh)
    shard = SubsetBatch(
        xy=[shard_rows(mesh, a) for a in padded.xy],
        mask=[shard_rows(mesh, a) for a in padded.mask],
        center0=shard_rows(mesh, padded.center0),
        extents=padded.extents,
    ).to_device(mesh.device)
    if not torch.is_tensor(params0):
        params0 = np.asarray(params0, np.float32)
    return shard, replicate(mesh, shard_rows(mesh, params0))


def replicate(mesh: Mesh, tree):
    """Images, pyramids (lists and tuples of them) or guesses on the
    rank's device, as float32; every rank holds the whole of them."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, a) for a in tree)
    if not torch.is_tensor(tree):
        tree = torch.from_numpy(np.array(tree))
    return tree.to(device=mesh.device).to(torch.float32)


def gather_rows(mesh: Mesh, t: torch.Tensor, num_subsets: int,
                dim: int = 0) -> torch.Tensor:
    """All-gather every rank's shard of `t` along the subset axis `dim`,
    in rank order, and strip the padding down to `num_subsets` rows.
    Every rank receives the whole result."""
    if mesh.group is not None:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t, group=mesh.group)
        t = torch.cat(parts, dim=dim)
    return t.narrow(dim, 0, num_subsets)


def broadcast_flag(mesh: Mesh | None, poll):
    """A poll () -> bool that every rank calls at the same point: rank 0
    calls `poll` and its answer is broadcast, so every rank takes the same
    branch.  Returns `poll` itself for no mesh or a world of one, and None
    for no poll."""
    if poll is None or mesh is None or mesh.group is None:
        return poll

    def agreed() -> bool:
        flag = torch.zeros(1, dtype=torch.int32, device=mesh.device)
        if mesh.rank == 0:
            flag += int(bool(poll()))
        dist.broadcast(flag, 0, group=mesh.group)
        return bool(flag.item())

    return agreed


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (a no-op without a process group)."""
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)
