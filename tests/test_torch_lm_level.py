"""The one-call LM level (ops/solve.lm_level, csrc/lm_level.cu) on the
CPU: what can be checked without a card.

On the card engine.solve_level issues a level's 53 steps (K1 and the LM
step each) by one call into the kernel library.  Here: the ctypes
signatures the library is loaded with, and the argument tuples the
wrappers build, against the C parameter lists of the sources; the launch
counters added in bulk against the same launches counted one by one; the
wrapper's argument checks; and solve_level on the CPU keeping its
per-step loop.  The kernels themselves, and the level against the
per-step loop bit for bit, are tests_gpu/test_lm_step_gpu.py's.
"""

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
                                  "lm_level_launch"])
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
    # lists, counts, steps, failed, stream.
    assert len(k1) + len(state) + 7 == _c_params("lm_level_launch")


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
