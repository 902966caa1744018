"""Tracing, throughput metering and card timing.

trace_region and start_trace / stop_trace are the JAX package's profiler
hooks on torch.profiler: a region is a record_function range (and an NVTX
range once the card is in use), and a trace is a Chrome trace file.

SolveMeter is the JAX package's always-on solves/s meter
(correlation_tpu/utils/profiling.py).  It reads the host's clock around
a region and synchronises nothing, so that a pipelined loop keeps its
overlap; PyTorch returns from a CUDA call before the card has finished,
so a region measures the card's work only where it ends by fetching
results (run_sequence's per-pair solve and its waits for a chunk).

cuda_time_ms times eager calls, host issue included: for a kernel of tens
of microseconds that is mostly the wrapper's host cost.  graph_ms replays
the calls from a CUDA graph and so times the device alone; inputs smaller
than the card's 50 MB L2 then stay in it from call to call.
graph_ms_cold rotates the calls over copies of the inputs so that each
call finds its inputs evicted, as a caller that streams them from HBM
would.
"""

from __future__ import annotations

import contextlib
import math
import os
import subprocess
import time

import torch


@contextlib.contextmanager
def trace_region(name: str):
    """Name a host-side region in a torch.profiler trace, and in NVTX
    (for external CUDA profilers) once the card is in use.  A CPU-only
    build never touches torch.cuda.nvtx."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_initialized():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


_TRACE: list = []  # the running trace: [(profiler, logdir)]


def start_trace(logdir: str) -> None:
    """Start a torch.profiler trace of the host and, where there is a card,
    the device; stop_trace writes it into `logdir`."""
    if _TRACE:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _TRACE.append((prof, logdir))


def stop_trace() -> str:
    """Stop the running trace and write it as a Chrome trace (JSON) into
    its logdir; returns the file's path."""
    if not _TRACE:
        raise RuntimeError("no trace is running")
    prof, logdir = _TRACE.pop()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


class SolveMeter:
    """Accumulates subsets solved and wall time; reports solves/s."""

    def __init__(self):
        self.subsets = 0
        self.seconds = 0.0
        self.frames = 0

    @contextlib.contextmanager
    def measure(self, num_subsets: int):
        """Time the block on the host's clock, as the JAX package's meter
        does: a block that fetches its results waits for the card.  A
        block of 0 subsets (a wait for results) adds its time and no
        call."""
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.subsets += num_subsets
        self.frames += num_subsets > 0

    @property
    def solves_per_s(self) -> float:
        return self.subsets / self.seconds if self.seconds else 0.0

    def summary(self) -> str:
        return (
            f"{self.subsets} subset solves over {self.frames} frames in "
            f"{self.seconds:.3f}s = {self.solves_per_s:.1f} solves/s"
        )


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of `fn` on the card: one warm-up call, then
    `reps` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _replay_ms(calls) -> float:
    """Device milliseconds per call of the zero-argument `calls`, captured
    in order in one CUDA graph after a warm-up of each, the graph's second
    replay timed with CUDA events."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(calls)


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of `fn`, without the host's cost of
    issuing it: `reps` calls replayed from one CUDA graph."""
    return _replay_ms([fn] * reps)


L2_BYTES = 50 * 1024 * 1024  # the H100's L2 cache


def graph_ms_cold(fn, inputs, reps: int = 20) -> float:
    """As graph_ms for `fn(*inputs)`, with the inputs coming from HBM: the
    calls rotate over copies of `inputs` whose other copies together exceed
    the L2, and there are at least as many calls as copies, so every call
    reads a copy that the calls since its last use have pushed out."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = math.ceil(L2_BYTES / nbytes) + 1
    sets = [list(inputs)] + [[t.clone() for t in inputs]
                             for _ in range(copies - 1)]
    n = max(reps, copies)
    return _replay_ms([lambda c=sets[i % copies]: fn(*c) for i in range(n)])


def card_name_and_power() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]
