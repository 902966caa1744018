"""The one-call LM level (ops/solve.lm_level, csrc/lm_level.cu) on the
CPU: what can be checked without a card.

On the card engine.solve_level runs a level's LM loop (K1 and the LM step
a step, at most 53 steps) as one CUDA graph launch, by one call into the
kernel library.  Here: the ctypes
signatures the library is loaded with, and the argument tuples the
wrappers build, against the C parameter lists of the sources; the names
the wrapper gives the library's reports against the source's enums; the
launch counters added in bulk against the same launches counted one by
one, and the steps the graphs ran added to them from a stand-in for the
library's totals; the wrapper's argument checks; and solve_level on the
CPU keeping its per-step loop.  The kernels themselves, and the level against the
per-step loop bit for bit, are tests_gpu/test_lm_step_gpu.py's.
"""

import contextlib
import ctypes
import re
import types

import numpy as np
import pytest
import torch

from correlation_tpu_torch import engine
from correlation_tpu_torch.ops import _build
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops import solve
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.problems import assembly_levels, dense_grid_problem

torch.set_num_threads(2)


def _c_params(name: str) -> int:
    """The parameter count of the C function `name`, from its definition
    in the library's sources."""
    for src in _build._SOURCES:
        m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{", src.read_text())
        if m:
            return m.group(1).count(",") + 1
    raise AssertionError(f"{name} is defined in no source")


@pytest.fixture
def fake_library(monkeypatch):
    """load_library() over a stand-in for the built library: the ctypes
    declarations it makes, with nothing compiled."""
    made = {}

    class Lib:
        def __getattr__(self, name):
            return made.setdefault(name, types.SimpleNamespace())

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: "none")
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())
    return _build.load_library()


@pytest.mark.parametrize("name", ["fused_assemble_launch", "lm_step_launch",
                                  "lm_level_launch", "lm_level_steps"])
def test_ctypes_signatures_match_the_sources(fake_library, name):
    assert len(getattr(fake_library, name).argtypes) == _c_params(name)


def test_lm_level_is_built():
    assert "lm_level.cu" in [src.name for src in _build._SOURCES]
    assert _build.synchronising_calls() == {}


@pytest.fixture(scope="module")
def level():
    """(cfg, K1's arguments as fused_assemble takes them, LevelArrays,
    LevelStatic) at level 0 of a 16-subset grid, on the CPU."""
    cfg, und, dfm, batch, _ = dense_grid_problem(16, img_hw=128)
    pair = torch.as_tensor(np.stack([und, dfm])[..., None])
    pyr = build_pyramid(pair, cfg.pyramid.stop)
    args = assembly_levels(cfg, batch, pyr, "cpu")[0]
    statics = engine.compute_level_statics(cfg, batch,
                                           [p[1] for p in pyr])
    gb = batch.to_device("cpu")
    levels = engine.prepare_levels(cfg, [p[0] for p in pyr],
                                   [p[1] for p in pyr], gb.xy, gb.mask,
                                   gb.center0, statics)
    return cfg, args, levels[0], statics[0]


def _level_args(cfg, args, steps=4):
    """lm_level's arguments on K1's inputs `args`, the first list every
    subset."""
    _, _, th, tw, h, w, img, pix, center, params, bbox = args
    s = params.shape[0]
    state = solve.LMState.start(cfg, params)
    n_points = pix[:, v2.ROW_MASK].sum(dim=1)
    scaling = 1.0 / n_points
    idx, count = engine.active_list(torch.ones(s, dtype=torch.bool))
    lists = torch.zeros((2, s), dtype=torch.int32)
    counts = torch.zeros((steps, 1), dtype=torch.int32)
    return [cfg, state, (th, tw, h, w, img, pix), scaling, n_points, bbox,
            center, (h, w), idx, count, lists, counts]


def test_argument_tuples_match_the_sources(level):
    """The tuples the wrappers splice into the library's calls have the
    C parameter lists' lengths: K1's and the step's state arguments."""
    cfg, args, *_ = level
    out = torch.empty((args[9].shape[0], 8, 8))
    k1, work = v2.launch_args(*args, None, None, out)
    assert len(k1) + 1 == _c_params("fused_assemble_launch")
    assert work is None  # one block a subset
    a = _level_args(cfg, args)
    state = solve._state_args(cfg, a[1], *a[3:8])
    # lm_step_launch: model, init, out, idx, count, n, S, the state
    # arguments, idx_next, count_next, flags, flag_capacity, stream.
    assert 7 + len(state) + 5 == _c_params("lm_step_launch")
    # lm_level_launch: K1's, the state arguments, flags, flag_capacity,
    # lists, counts, steps, info, stream.
    assert len(k1) + len(state) + 7 == _c_params("lm_level_launch")


def _c_enum(name: str) -> list[str]:
    """The enumerators of the enum `name` in csrc/lm_level.cu, in order."""
    src = (_build._PKG / "csrc" / "lm_level.cu").read_text()
    body = re.search(rf"enum {name} \{{([^}}]*)\}}", src).group(1)
    return [e.split("=")[0].strip() for e in body.split(",")]


def test_graph_reports_follow_the_source():
    """The names lm_level gives the library's info words: a stage a
    failure came from, the kernel whose plan or capture failed, what the
    call did with the level's graph, in the order of the C enums."""
    assert _c_enum("Stage") == ["kOk", "kPlan", "kCapture", "kInstantiate",
                                "kUpdate", "kLaunch"]
    assert solve._STAGES[1:] == ("plan", "capture", "instantiation",
                                 "update", "launch")
    assert _c_enum("Kernel") == ["kNoKernel", "kK1", "kLmStep", "kControl"]
    assert solve._KERNELS == ("fused_assemble", "lm_step", "level_control")
    assert _c_enum("Made") == ["kUpdated", "kInstantiated"]
    assert solve._MADE == ("updated", "instantiated")
    assert "kNoKernel = -1" in (_build._PKG / "csrc" / "lm_level.cu"
                                ).read_text()


def test_split_path_arguments_carry_a_workspace(level):
    cfg, args, *_ = level
    pix = torch.zeros((3, 8, 2 * v2.CHUNK_MIN_PIXELS + 1))
    params = torch.zeros((3, 6))
    out = torch.empty((3, 8, 8))
    k1, work = v2.launch_args(cfg.model, cfg.interpolation, *args[2:7], pix,
                              args[8][:3], params, args[10][:3], None, None,
                              out)
    spans = v2.subset_chunks(pix.shape[2])
    assert work.numel() == 3 * spans * 8 * 9 // 2 == k1[-2]


def test_launches_counted_in_bulk_equal_one_by_one():
    v2.reset_launches()
    for _ in range(53):
        v2.count_launches(441, 40, 40, 4096)
    one_by_one = (v2.LAUNCHES, dict(v2.LAUNCHES_BY_SHAPE))
    v2.reset_launches()
    v2.count_launches(441, 40, 40, 4096, 53)
    assert (v2.LAUNCHES, v2.LAUNCHES_BY_SHAPE) == one_by_one
    assert one_by_one == (53, {(441, 40, 40): [53, 53 * 4096]})
    v2.reset_launches()


@pytest.fixture
def graph_totals(monkeypatch):
    """A stand-in for the graphs' totals on the card: {device: rows of
    (graph id, padded pixels, tile_h, tile_w, list room n, steps run in
    all)} that a test fills, read by solve._graph_totals, whose calls
    (the devices read) are listed; no totals read before, and the launch
    counters zeroed before and after."""
    totals, reads = {}, []

    def read(lib, device):
        reads.append(device)
        return [list(row) for row in totals[device]]

    v2.reset_launches()
    solve.reset_launches()
    monkeypatch.setattr(_build, "load_library", types.SimpleNamespace)
    monkeypatch.setattr(solve, "_graph_totals", read)
    monkeypatch.setattr(solve, "_GRAPH_DEVICES", set())
    monkeypatch.setattr(solve, "_STEPS_READ", {})
    yield totals, reads
    solve._GRAPH_DEVICES.clear()
    v2.reset_launches()
    solve.reset_launches()


def _launched(totals):
    """Marks the devices of `totals` as having launched a graph, as
    lm_level does."""
    solve._GRAPH_DEVICES.update(totals)


@pytest.mark.parametrize("rows", [
    {0: [(0, 441, 40, 40, 4096, 2)]},
    {0: [(0, 441, 40, 40, 4096, 3), (1, 441, 40, 40, 512, 5),
         (2, 121, 24, 24, 512, 9)]},
    {0: [(0, 441, 40, 40, 64, 4)], 1: [(0, 441, 40, 40, 64, 6)]}],
    ids=["one", "shared-shape", "two-devices"])
def test_resolve_launches_counts_the_steps_run(graph_totals, rows):
    """After graph levels, resolve_launches adds each graph's steps run
    to both launch counters, one K1 launch over the list room and one LM
    step a step; later, only the steps run since, on the devices that
    launched a graph since; then nothing is left to read."""
    totals, reads = graph_totals
    totals.update({d: [list(r) for r in rs] for d, rs in rows.items()})
    _launched(totals)
    solve.resolve_launches()
    want = {}
    for p_len, th, tw, n, k in (r[1:] for rs in rows.values() for r in rs):
        got = want.setdefault((p_len, th, tw), [0, 0])
        got[0] += k
        got[1] += k * n
    steps = sum(k for k, _ in want.values())
    assert solve.LAUNCHES == v2.LAUNCHES == steps
    assert v2.LAUNCHES_BY_SHAPE == want
    assert reads == sorted(rows)
    # Two more steps on the first graph of the first device alone.
    first = min(rows)
    totals[first][0][5] += 2
    _launched({first: None})
    solve.resolve_launches()
    solve.resolve_launches()
    assert reads == sorted(rows) + [first]
    assert solve.LAUNCHES == v2.LAUNCHES == steps + 2
    key = tuple(totals[first][0][1:4])
    assert v2.LAUNCHES_BY_SHAPE[key][0] == want[key][0] + 2


def test_resolve_launches_without_a_graph_reads_nothing(graph_totals):
    totals, reads = graph_totals
    totals[0] = [[0, 441, 40, 40, 4096, 2]]
    solve.resolve_launches()
    assert reads == [] and solve.LAUNCHES == v2.LAUNCHES == 0


@pytest.mark.parametrize("module", [v2, solve], ids=["assemble_v2", "solve"])
def test_reset_counts_earlier_graphs_first(graph_totals, module):
    """Steps that graphs launched before a reset ran are added before the
    reset zeroes its module's counters, so none reaches a later count."""
    totals, _ = graph_totals
    totals[0] = [[0, 441, 40, 40, 4096, 4]]
    _launched(totals)
    module.reset_launches()
    other = solve if module is v2 else v2
    assert module.LAUNCHES == 0 and other.LAUNCHES == 4
    _launched(totals)
    solve.resolve_launches()
    assert module.LAUNCHES == 0 and other.LAUNCHES == 4


def test_resolve_launches_names_a_failure(monkeypatch):
    """A failed read of the library's totals raises, naming the call and
    the error, and leaves the device's graphs to be read again."""
    lib = types.SimpleNamespace(
        lm_level_steps=lambda *a: -700,
        fused_assemble_error_string=lambda rc: b"an illegal address")
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(solve, "_GRAPH_DEVICES", {0})
    with pytest.raises(RuntimeError,
                       match="lm_level_steps failed: an illegal address"):
        solve.resolve_launches()
    assert solve._GRAPH_DEVICES == {0}


def _bad(a, what):
    a = list(a)
    s = a[8].shape[0]
    if what == "lists of the wrong room":
        a[10] = torch.zeros((2, s - 1), dtype=torch.int32)
    elif what == "int64 counts":
        a[11] = a[11].long()
    elif what == "a strided counts buffer":
        a[11] = torch.zeros((4, 2), dtype=torch.int32)[:, :1]
    elif what == "a host list":
        a[9] = None
    elif what == "no step":
        a[11] = a[11][:0]
    elif what == "a float list":
        a[8] = a[8].float()
    elif what == "the CPU":
        pass
    return a


@pytest.mark.parametrize("what", [
    "lists of the wrong room", "int64 counts", "a strided counts buffer",
    "a host list", "no step", "a float list", "the CPU"])
def test_lm_level_checks_its_arguments(level, what):
    """Each argument the library would misread raises before any launch;
    on CPU tensors (here) every call raises, naming the device."""
    cfg, args, *_ = level
    with pytest.raises((ValueError, TypeError)) as err:
        solve.lm_level(*_bad(_level_args(cfg, args), what))
    if what == "the CPU":
        assert "CUDA" in str(err.value)


def test_solve_level_on_the_cpu_keeps_its_loop(level, monkeypatch):
    """On the CPU the device-list loop stops at its first empty list,
    step by step; the one-call level is the card's."""
    cfg, args, lv, st = level

    def refuse(*a, **k):
        raise AssertionError("lm_level called on the CPU")

    monkeypatch.setattr(engine, "lm_level", refuse)
    steps = []
    real = engine.lm_step

    def counted(*a, **k):
        steps.append(1)
        return real(*a, **k)

    monkeypatch.setattr(engine, "lm_step", counted)
    skip = torch.zeros(args[9].shape[0], dtype=torch.bool)
    res = engine.solve_level(cfg, lv, args[9], skip, st)
    assert 1 < len(steps) < cfg.max_iterations + 3
    assert int(res.reached.max()) < len(steps)
