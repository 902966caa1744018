"""Tracing, throughput metering and card timing.

trace_region and start_trace / stop_trace are the JAX package's profiler
hooks on torch.profiler: a region is a record_function range while a
profiler runs, and a trace is a Chrome trace file.  recording() keeps the
same regions in memory instead (spans on the host's clock, with their
parents) and counts the LM loop's steps run, its empty steps and its
levels, for a caller that reads them itself.  With neither open, a
region costs one flag check and one query of the profiler's state.  The
span names the program opens are the constants below; traced and
trace_each open them around a function's calls and a loop's passes.

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
import dataclasses
import functools
import math
import os
import subprocess
import time

import torch

from correlation_tpu_torch.ops import solve


# The spans the program opens, from the sequence layer down to one
# pyramid level's LM loop; none is opened inside the loop.
SEQ_RUN = "seq.run"  # run_sequence, whole
SEQ_MAKE_BATCH = "seq.make_batch"  # the point lists flattened, a batch built
SEQ_STAGE = "seq.stage"  # a chunk's frame stack, stacked and sent
SEQ_DISPATCH = "seq.dispatch"  # a chunk's correlate_frames and result copy
SEQ_FETCH = "seq.fetch"  # the wait for a chunk's results
SEQ_EMIT = "seq.emit"  # records and checkpoints of a chunk or a pair
SEQ_PAIR = "seq.pair"  # the pair-by-pair path's solve and its copy back
SEQ_ADVANCE = "seq.advance"  # a Lagrangian pair's domain moved on the host
ENGINE_PREPARE = "engine.prepare"  # a chunk's pyramid, statics, levels
ENGINE_PAIR = "engine.pair"  # one pair of a chunk
ENGINE_SOLVE_LEVEL = "engine.solve_level"  # one level's LM loop


@dataclasses.dataclass
class Span:
    """A region recorded on the host's clock (time.perf_counter_ns)."""

    name: str
    start_ns: int
    end_ns: int  # 0 while the region is open
    parent: int | None  # index of the enclosing span in Recording.spans


class Recording:
    """What recording() collects: `spans` in the order they opened, and
    `counters`: `steps`, the LM steps run, and `empty_steps`, those run
    on an empty list; `levels`, the pyramid levels' LM loops issued,
    `native_levels`, those issued by one call into the kernel library,
    `split_levels`, those whose fused assembly took K1's split path
    (ops/assemble_v2.subset_chunks above 1), `graph_levels`, those run
    as one CUDA graph launch, and `graph_instantiations`, those whose
    graph had to be instantiated; `batches`, the subset batches
    run_sequence built, and `batches_on_device`, those built on a card.
    A step's list length may be a device tensor; such lengths are read
    when the recording closes, and a negative one is a step that did not
    run."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._open: list[int] = []
        self._lengths: list = []  # ints, and int32 tensors of lengths
        # levels, native, split, graph levels, graph instantiations
        self._levels = [0, 0, 0, 0, 0]
        self._batches = [0, 0]  # batches, those built on a card

    @contextlib.contextmanager
    def _span(self, name: str):
        parent = self._open[-1] if self._open else None
        span = Span(name, time.perf_counter_ns(), 0, parent)
        self._open.append(len(self.spans))
        self.spans.append(span)
        try:
            yield
        finally:
            span.end_ns = time.perf_counter_ns()
            self._open.pop()

    def add_lengths(self, lengths: list) -> None:
        """The list lengths of LM steps (ints, and int32 tensors of
        lengths that the steps write on the device, -1 for a step that
        did not run); nothing is read until the recording closes."""
        self._lengths += lengths

    def add_level(self, native: bool, split: bool, graph: bool = False,
                  instantiated: bool = False) -> None:
        """One pyramid level's LM loop issued; `native`: by one call into
        the kernel library; `split`: its assembly on K1's split path;
        `graph`: run as one CUDA graph launch, which had to be
        `instantiated`."""
        for i, flag in enumerate((True, native, split, graph,
                                  graph and instantiated)):
            self._levels[i] += bool(flag)

    def add_batch(self, on_device: bool) -> None:
        """One subset batch built by run_sequence; `on_device`: on a
        card."""
        self._batches[0] += 1
        self._batches[1] += bool(on_device)

    def _resolve(self) -> None:
        """Read every deferred length (one copy to the host) and count the
        steps run and the empty ones."""
        tensors = [x.reshape(-1) for x in self._lengths if torch.is_tensor(x)]
        lengths = torch.cat(tensors).tolist() if tensors else []
        lengths += [int(x) for x in self._lengths if not torch.is_tensor(x)]
        lengths = [x for x in lengths if x >= 0]
        self.counters = {"steps": len(lengths),
                         "empty_steps": lengths.count(0),
                         "levels": self._levels[0],
                         "native_levels": self._levels[1],
                         "split_levels": self._levels[2],
                         "graph_levels": self._levels[3],
                         "graph_instantiations": self._levels[4],
                         "batches": self._batches[0],
                         "batches_on_device": self._batches[1]}
        self._lengths = []


_RECORDING: list = []  # the open recording: [Recording]
_OFF = contextlib.nullcontext()


def trace_region(name: str):
    """A context manager naming a host-side region `name`: a span of the
    open recording(), else a record_function range while a torch profiler
    runs (it lands in the profiler's trace beside the kernels and copies,
    on their clock), else nothing at all."""
    if _RECORDING:
        return _RECORDING[0]._span(name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def traced(name: str):
    """A decorator: each call of the function is a trace_region(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with trace_region(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def trace_each(name: str, items):
    """Yield each of `items` inside a trace_region(name), so that each
    pass of a loop over them is a region."""
    for item in items:
        with trace_region(name):
            yield item


def current_recording() -> Recording | None:
    """The open recording, or None."""
    return _RECORDING[0] if _RECORDING else None


@contextlib.contextmanager
def recording():
    """Record the program's spans and counters in memory while the block
    runs; yields the Recording.  On exit the device is synchronised once,
    the LM steps' list lengths are read, and the launch counters take the
    steps that the LM loop's graphs ran (ops/solve.resolve_launches).  One
    at a time: a second raises RuntimeError."""
    if _RECORDING:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    _RECORDING.append(rec)
    try:
        yield rec
    finally:
        _RECORDING.pop()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        rec._resolve()
        solve.resolve_launches()


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
