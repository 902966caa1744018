"""The port's spans and LM-step counters (utils/profiling.py): trace_region
off, under a torch profiler and under recording(); the spans run_sequence
and the engine open, with their parents; the list lengths the LM loop
hands a recording, against a count taken around ops/solve.lm_step; the
levels counted, those issued by one native call and those on K1's
split path; the subset batches built; and records unchanged by a
recording."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from correlation_tpu_torch import engine
from correlation_tpu_torch.problems import sequence_problem
from correlation_tpu_torch.sequence import SequenceConfig, run_sequence
from correlation_tpu_torch.utils import profiling

torch.set_num_threads(2)

PAIRS = 3
# Each span's parent, as the program opens them (engine.solve_level under
# the chunk's pair or the pair-by-pair path's pair).
PARENTS = {
    profiling.SEQ_RUN: {None},
    profiling.SEQ_MAKE_BATCH: {profiling.SEQ_RUN},
    profiling.SEQ_STAGE: {profiling.SEQ_RUN},
    profiling.SEQ_DISPATCH: {profiling.SEQ_RUN},
    profiling.SEQ_FETCH: {profiling.SEQ_RUN},
    profiling.SEQ_EMIT: {profiling.SEQ_RUN},
    profiling.SEQ_PAIR: {profiling.SEQ_RUN},
    profiling.ENGINE_PREPARE: {profiling.SEQ_DISPATCH},
    profiling.ENGINE_PAIR: {profiling.SEQ_DISPATCH},
    profiling.ENGINE_SOLVE_LEVEL: {profiling.ENGINE_PAIR,
                                   profiling.SEQ_PAIR},
}
CHUNKED = {profiling.SEQ_RUN, profiling.SEQ_MAKE_BATCH, profiling.SEQ_STAGE,
           profiling.SEQ_DISPATCH, profiling.SEQ_FETCH, profiling.SEQ_EMIT,
           profiling.ENGINE_PREPARE, profiling.ENGINE_PAIR,
           profiling.ENGINE_SOLVE_LEVEL}
PAIR_BY_PAIR = {profiling.SEQ_RUN, profiling.SEQ_MAKE_BATCH,
                profiling.SEQ_PAIR, profiling.SEQ_EMIT,
                profiling.ENGINE_SOLVE_LEVEL}
PATHS = {"chunked": (PAIRS + 1, CHUNKED), "pair_by_pair": (1, PAIR_BY_PAIR)}


@pytest.fixture(scope="module")
def problem():
    cfg, frames, pts, centers = sequence_problem(16, PAIRS, img_hw=128)
    return dataclasses.replace(cfg, backend="torch"), frames, pts, centers


def _run(problem, chunk, backend="torch"):
    cfg, frames, pts, centers = problem
    scfg = SequenceConfig(solver=dataclasses.replace(cfg, backend=backend),
                          frame_chunk=chunk)
    return run_sequence(list(frames), pts, scfg, centers=centers,
                        device="cpu")


def _levels(problem):
    return len(problem[0].pyramid.levels_coarse_to_fine())


@pytest.mark.parametrize("how", ["region", "traced", "each"])
def test_off_opens_no_record_function(monkeypatch, how):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.current_recording() is None
    if how == "region":
        region = profiling.trace_region(profiling.ENGINE_PAIR)
        with region:
            pass
        assert region is profiling.trace_region(profiling.SEQ_RUN)
    elif how == "traced":
        assert profiling.traced(profiling.SEQ_RUN)(lambda x: x + 1)(2) == 3
    else:
        assert list(profiling.trace_each(profiling.ENGINE_PAIR, "ab")) == [
            "a", "b"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_in_the_profiler_trace(tmp_path, problem, path):
    chunk, names = PATHS[path]
    profiling.start_trace(str(tmp_path))
    try:
        _run(problem, chunk)
    finally:
        trace = profiling.stop_trace()
    with open(trace) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") in PARENTS]
    assert {e["name"] for e in spans} == names

    def parent(e):
        outer = [o for o in spans if o is not e and o["tid"] == e["tid"]
                 and o["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        return min(outer, key=lambda o: o["dur"])["name"] if outer else None

    for e in spans:
        assert parent(e) in PARENTS[e["name"]], e["name"]


def test_one_recording_at_a_time():
    with profiling.recording() as rec:
        assert profiling.current_recording() is rec
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert profiling.current_recording() is None
    with pytest.raises(ValueError):
        with profiling.recording():
            raise ValueError
    assert profiling.current_recording() is None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_recorded_spans_and_parents(problem, path):
    chunk, names = PATHS[path]
    calls = 2
    with profiling.recording() as rec:
        for _ in range(calls):
            _run(problem, chunk)
    spans = rec.spans
    assert {s.name for s in spans} == names
    by = {n: [s for s in spans if s.name == n] for n in names}
    assert len(by[profiling.SEQ_RUN]) == calls
    pair = (profiling.ENGINE_PAIR if path == "chunked"
            else profiling.SEQ_PAIR)
    assert len(by[pair]) == calls * PAIRS
    levels = by[profiling.ENGINE_SOLVE_LEVEL]
    assert len(levels) == calls * PAIRS * _levels(problem)
    # Each pair's span holds one span a pyramid level.
    for i, s in enumerate(spans):
        if s.name == pair:
            assert sum(spans[c].name == profiling.ENGINE_SOLVE_LEVEL
                       for c in range(i + 1, len(spans))
                       if spans[c].parent == i) == _levels(problem)
    for i, s in enumerate(spans):
        up = None if s.parent is None else spans[s.parent]
        assert (None if up is None else up.name) in PARENTS[s.name], s.name
        assert s.end_ns >= s.start_ns > 0
        if up is not None:
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
            assert s.parent < i


@pytest.mark.parametrize("backend", ["torch", "sep", "field"])
def test_counters_equal_the_steps_issued(monkeypatch, problem, backend):
    issued = []
    real = engine.lm_step

    def counted(cfg, state, out, idx, count, *args, **kwargs):
        issued.append(idx.shape[0] if count is None else int(count))
        return real(cfg, state, out, idx, count, *args, **kwargs)

    monkeypatch.setattr(engine, "lm_step", counted)
    with profiling.recording() as rec:
        _run(problem, PAIRS + 1, backend)
    levels = PAIRS * _levels(problem)
    assert rec.counters == {"steps": len(issued), "empty_steps": 0,
                            "levels": levels, "native_levels": 0,
                            "split_levels": 0, "graph_levels": 0,
                            "graph_instantiations": 0, "batches": 1,
                            "batches_on_device": 0}
    assert len(issued) > levels and 0 not in issued


@pytest.mark.parametrize("path", sorted(PATHS))
def test_records_unchanged_by_a_recording(problem, path):
    chunk = PATHS[path][0]
    plain = _run(problem, chunk)
    with profiling.recording():
        recorded = _run(problem, chunk)
    assert len(plain) == len(recorded) == PAIRS
    for a, b in zip(plain, recorded):
        for f in ("params", "chi", "iterations", "error", "def_center",
                  "def_angle", "def_e"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_empty_lengths_count_as_empty_steps():
    """A device count of 0, read when the recording closes, is an empty
    step; host lengths and device counts mix in one level."""
    with profiling.recording() as rec:
        with profiling.trace_region(profiling.ENGINE_SOLVE_LEVEL):
            rec.add_lengths([torch.tensor([5], dtype=torch.int32), 3,
                             torch.tensor([[4], [0]], dtype=torch.int32),
                             torch.zeros((0, 1), dtype=torch.int32), 0])
        rec.add_lengths([torch.tensor([2], dtype=torch.int32)])
        assert rec.counters == {}  # nothing read while open
    assert rec.counters == {"steps": 6, "empty_steps": 2, "levels": 0,
                            "native_levels": 0, "split_levels": 0,
                            "graph_levels": 0, "graph_instantiations": 0,
                            "batches": 0, "batches_on_device": 0}
    (span,) = rec.spans
    assert span.name == profiling.ENGINE_SOLVE_LEVEL and span.parent is None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_levels_counted_on_the_cpu(problem, path):
    """Every solve_level under a recording is a level; on the CPU none is
    issued by the one native call (the card's path)."""
    with profiling.recording() as rec:
        _run(problem, PATHS[path][0])
    assert rec.counters["levels"] == PAIRS * _levels(problem)
    assert rec.counters["native_levels"] == 0


def test_native_levels_counted():
    with profiling.recording() as rec:
        rec.add_level(True, False)
        rec.add_level(False, False)
        rec.add_level(True, True)
        assert rec.counters == {}
    assert rec.counters == {"steps": 0, "empty_steps": 0, "levels": 3,
                            "native_levels": 2, "split_levels": 1,
                            "graph_levels": 0, "graph_instantiations": 0,
                            "batches": 0, "batches_on_device": 0}


@pytest.mark.parametrize("made, want", [
    ([], (0, 0)), (["instantiated"], (1, 1)), (["updated"] * 3, (3, 0)),
    (["instantiated", "updated", "updated", "instantiated"], (4, 2))],
    ids=["none", "new", "kept", "mixed"])
def test_graph_levels_counted(made, want):
    """A level run as one graph launch is a graph level; one whose graph
    had to be instantiated is also an instantiation.  A level issued
    otherwise is neither, whatever it claims."""
    with profiling.recording() as rec:
        for what in made:
            rec.add_level(True, False, True, what == "instantiated")
        rec.add_level(False, False, False, True)
    counters = rec.counters
    assert (counters["graph_levels"], counters["graph_instantiations"]) == (
        want)
    assert counters["levels"] == counters["native_levels"] + 1 == len(made) + 1


@pytest.mark.parametrize("first, rows, want", [
    (6, [[5], [3], [-1], [-1]], (3, 0)), (0, [[-1], [-1], [-1]], (1, 1)),
    (7, [[7], [7], [7], [-1]], (4, 0)), (4, [[0], [-1]], (2, 1))],
    ids=["stopped", "empty-first-list", "bound", "zero-run"])
def test_steps_not_run_are_not_counted(first, rows, want):
    """A level's lengths as solve_level hands them on the card: the
    first list's count, then the count rows but the last, where the graph
    writes -1 for each step it did not run; those are dropped, so only
    the steps run count (steps, empty_steps)."""
    counts = torch.tensor(rows, dtype=torch.int32)
    with profiling.recording() as rec:
        rec.add_lengths([torch.tensor([first], dtype=torch.int32),
                         counts[:-1]])
        rec.add_lengths([-1, 2])
    assert (rec.counters["steps"], rec.counters["empty_steps"]) == (
        want[0] + 1, want[1])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_batches_counted_on_the_cpu(problem, path):
    """One batch a call, built on the CPU here (the card's are counted
    in tests_gpu)."""
    with profiling.recording() as rec:
        _run(problem, PATHS[path][0])
    assert (rec.counters["batches"], rec.counters["batches_on_device"]) == (
        1, 0)


def test_make_batch_span_encloses_the_build(monkeypatch, problem):
    """The point lists' flattening, their means and the batch's build,
    upload and read-back all run inside seq.make_batch spans."""
    import correlation_tpu_torch.sequence as seq

    calls = []

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            calls.append((fn.__name__, t0, time.perf_counter_ns()))
            return out
        return call

    monkeypatch.setattr(seq, "FlatPoints", timed(seq.FlatPoints))
    monkeypatch.setattr(seq, "build_batch", timed(seq.build_batch))
    cfg, frames, pts, _ = problem
    with profiling.recording() as rec:
        run_sequence(list(frames), pts, SequenceConfig(solver=cfg),
                     centers=None, device="cpu")
    spans = [s for s in rec.spans if s.name == profiling.SEQ_MAKE_BATCH]
    assert [c[0] for c in calls] == ["FlatPoints", "build_batch"]
    for _, t0, t1 in calls:
        assert any(s.start_ns <= t0 <= t1 <= s.end_ns for s in spans)


def test_recording_resolves_the_launch_counters(monkeypatch):
    """A recording's close adds the steps that the LM loop's graphs ran
    to the launch counters (ops/solve.resolve_launches), after its one
    sync: here a stand-in for the card's totals, one graph that ran 7
    steps."""
    import types

    from correlation_tpu_torch.ops import _build, solve
    from correlation_tpu_torch.ops import assemble_v2 as v2

    v2.reset_launches()
    solve.reset_launches()
    monkeypatch.setattr(_build, "load_library", types.SimpleNamespace)
    monkeypatch.setattr(solve, "_graph_totals",
                        lambda lib, device: [[0, 441, 40, 40, 16, 7]])
    monkeypatch.setattr(solve, "_STEPS_READ", {})
    monkeypatch.setattr(solve, "_GRAPH_DEVICES", {0})
    with profiling.recording():
        assert solve.LAUNCHES == 0
    assert (solve.LAUNCHES, v2.LAUNCHES) == (7, 7)
    assert v2.LAUNCHES_BY_SHAPE == {(441, 40, 40): [7, 7 * 16]}
    assert not solve._GRAPH_DEVICES
    v2.reset_launches()
    solve.reset_launches()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_sequence_returns_with_the_launches_resolved(problem,
                                                         monkeypatch, path):
    """run_sequence reads the launch counters' pending graph steps once
    (ops/solve.resolve_launches), on either loop, so that they are
    current when a caller reads them after it returns."""
    from correlation_tpu_torch.ops import solve

    calls = []
    monkeypatch.setattr(solve, "resolve_launches",
                        lambda: calls.append("resolved"))
    assert len(_run(problem, PATHS[path][0])) == PAIRS
    assert calls == ["resolved"]
