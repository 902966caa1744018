"""The CUDA LM-step kernel against its plain PyTorch version on the card,
the fused assembly's device-side list length, and the LM loop's lack of
host syncs.

The kernel repeats the plain version's float32 operations in order,
built with -fmad=false, with IEEE division and the pivot's sqrt in
float64, so the two agree bit for bit (a NaN as a NaN) over every branch
of problems.lm_step_problem, for the four models, in both modes, at 4096
subsets; and its output list (the listed subsets still active, written
by a scan across blocks in the same launch) equals the plain version's
and engine.active_list's, over problems.lm_step_list's lists at 1, 37,
4096 and 16384 subsets, when every subset stops and when none does, and
from a CUDA graph replayed twice.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from correlation_tpu_torch import engine
from correlation_tpu_torch.config import ErrorCode, FittingModel
from correlation_tpu_torch.domains import SubsetBatch
from correlation_tpu_torch.engine import active_list, correlate_frames
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops import solve
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.domains import annular_batch, blob_batch
from correlation_tpu_torch.problems import (
    LM_STEP_LISTS,
    annular_problem,
    assembly_levels,
    blob_problem,
    dense_grid_problem,
    lm_step_list,
    lm_step_problem,
)
from correlation_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def same_bits(a, b):
    """Equal bit for bit, any NaN equal to any NaN."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int32)[~nan],
                                b.view(torch.int32)[~nan]))


def _inputs(model, dev, s=4096, seed=0):
    cfg, arrays, out, scaling, n_points, bbox, center, hw = lm_step_problem(
        model, s, seed)

    def t(a):
        return torch.as_tensor(a, device=dev)

    state = solve.LMState(**{k: t(v) for k, v in arrays.items()})
    return cfg, state, t(out), t(scaling), t(n_points), t(bbox), t(center), hw


@pytest.mark.parametrize("init", [False, True], ids=["step", "init"])
@pytest.mark.parametrize("model", list(FittingModel), ids=lambda m: m.name)
def test_kernel_equals_plain(dev, model, init):
    cfg, state, out, scaling, n_points, bbox, center, hw = _inputs(model, dev)
    s = state.p_cur.shape[0]
    perm = torch.randperm(s, generator=torch.Generator().manual_seed(1))
    idx = perm.to(torch.int32).to(dev)
    count = torch.tensor([3 * s // 4], dtype=torch.int32, device=dev)
    listed = out[perm.to(dev)]
    got = solve.LMState(*(a.clone() for a in state))
    ref = solve.LMState(*(a.clone() for a in state))
    nxt = [torch.full((s,), -1, dtype=torch.int32, device=dev)
           for _ in range(2)]
    cnt = [torch.full((1,), -1, dtype=torch.int32, device=dev)
           for _ in range(2)]
    before = solve.LAUNCHES
    solve.lm_step(cfg, got, listed, idx, count, scaling, n_points, bbox,
                  center, hw, init, nxt[0], cnt[0])
    assert solve.LAUNCHES == before + 1
    solve.lm_step_reference(cfg, ref, listed, idx, count, scaling, n_points,
                            bbox, center, hw, init, nxt[1], cnt[1])
    torch.cuda.synchronize()
    for name, a in got._asdict().items():
        assert same_bits(a, ref._asdict()[name]), name
    # The output list keeps the (shuffled) input list's order.
    assert torch.equal(cnt[0], cnt[1]) and torch.equal(nxt[0], nxt[1])
    rest = perm[3 * s // 4:].to(dev)
    for name, a in got._asdict().items():
        assert same_bits(a[rest], state._asdict()[name][rest]), name


@functools.lru_cache(maxsize=None)
def _problem(model, s, stop):
    return lm_step_problem(model, s, seed=int(model), stop=stop)


def _list_case(dev, model, s, kind, stop, init):
    """(cfg, state, args, img_hw, count): the state's active flags are the
    listed subsets (none in init mode, as LMState.start)."""
    cfg, arrays, out, *rest, hw = _problem(model, s, stop)
    idx, count = lm_step_list(s, kind, seed=s + int(model))
    arrays = dict(arrays)
    arrays["active"] = np.isin(np.arange(s), idx[:count]) & (not init)

    def t(a):
        return torch.as_tensor(a, device=dev)

    state = solve.LMState(**{k: t(v) for k, v in arrays.items()})
    args = (t(out[np.minimum(idx, s - 1)]), t(idx),
            t(np.int32([count])), *(t(a) for a in rest))
    return cfg, state, args, hw, count


@pytest.mark.parametrize("stop", [None, "none", "all"],
                         ids=["roles", "none-stop", "all-stop"])
@pytest.mark.parametrize("kind", LM_STEP_LISTS)
@pytest.mark.parametrize("s", [1, 37, 4096, 16384])
@pytest.mark.parametrize("init", [False, True], ids=["step", "init"])
@pytest.mark.parametrize("model", list(FittingModel), ids=lambda m: m.name)
def test_kernel_writes_the_next_list(dev, model, init, s, kind, stop):
    """State and output list bit for bit with the plain version, the list
    equal to active_list of the flags the step leaves, nothing written
    past its count."""
    cfg, state, args, hw, count = _list_case(dev, model, s, kind, stop, init)
    got = solve.LMState(*(a.clone() for a in state))
    ref = solve.LMState(*(a.clone() for a in state))
    nxt = torch.full((s,), -5, dtype=torch.int32, device=dev)
    cnt = torch.full((1,), -5, dtype=torch.int32, device=dev)
    ref_nxt, ref_cnt = nxt.clone(), cnt.clone()
    solve.lm_step(cfg, got, *args, hw, init, nxt, cnt)
    solve.lm_step_reference(cfg, ref, *args, hw, init, ref_nxt, ref_cnt)
    torch.cuda.synchronize()
    for name, a in got._asdict().items():
        assert same_bits(a, ref._asdict()[name]), name
    assert torch.equal(cnt, ref_cnt) and torch.equal(nxt, ref_nxt)
    want, want_count = active_list(got.active)
    n = int(cnt)
    assert n == int(want_count) and torch.equal(nxt[:n], want[:n])
    assert bool((nxt[n:] == -5).all())
    if stop == "all":
        assert n == 0
    elif stop == "none":
        assert n == count


def test_graph_replays_write_the_same_list(dev):
    """The kernel captured in a CUDA graph and replayed twice from the
    same state writes the same list both times: its look-back workspace
    is clean again after each launch."""
    cfg, state, args, hw, _ = _list_case(dev, FittingModel.AFFINE, 16384,
                                         "gaps", None, False)
    work = solve.LMState(*(a.clone() for a in state))
    nxt = torch.zeros(16384, dtype=torch.int32, device=dev)
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    ref = solve.LMState(*(a.clone() for a in state))
    ref_nxt, ref_cnt = nxt.clone(), cnt.clone()
    solve.lm_step_reference(cfg, ref, *args, hw, False, ref_nxt, ref_cnt)
    solve.lm_step(cfg, work, *args, hw, False, nxt, cnt)  # warm, eager
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        solve.lm_step(cfg, work, *args, hw, False, nxt, cnt)
    for _ in range(2):
        for a, b in zip(work, state):
            a.copy_(b)
        nxt.zero_()
        cnt.zero_()
        graph.replay()
        torch.cuda.synchronize()
        n = int(ref_cnt)
        assert torch.equal(cnt, ref_cnt)
        assert torch.equal(nxt[:n], ref_nxt[:n])
        for name, a in work._asdict().items():
            assert same_bits(a, ref._asdict()[name]), name


def test_empty_and_host_lists(dev):
    cfg, state, out, scaling, n_points, bbox, center, hw = _inputs(
        FittingModel.AFFINE, dev, s=300)
    idx = torch.arange(300, dtype=torch.int32, device=dev)
    got = solve.LMState(*(a.clone() for a in state))
    solve.lm_step(cfg, got, out, idx, torch.zeros(1, dtype=torch.int32,
                                                  device=dev),
                  scaling, n_points, bbox, center, hw)
    for name, a in got._asdict().items():
        assert same_bits(a, state._asdict()[name]), name
    # A list without a device length (the separable and field paths').
    ref = solve.LMState(*(a.clone() for a in state))
    solve.lm_step(cfg, got, out[:77], idx[:77], None, scaling, n_points,
                  bbox, center, hw)
    solve.lm_step_reference(cfg, ref, out[:77], idx[:77], None, scaling,
                            n_points, bbox, center, hw)
    for name, a in got._asdict().items():
        assert same_bits(a, ref._asdict()[name]), name


@pytest.fixture(scope="module")
def levels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda")
    cfg, und, dfm, batch, _ = dense_grid_problem(4096)
    pair = torch.as_tensor(np.stack([und, dfm])[..., None], device=dev)
    return assembly_levels(cfg, batch, build_pyramid(pair, cfg.pyramid.stop),
                           dev)


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_fused_assembly_with_a_device_length(dev, levels, lvl):
    """K1 with the list's length on the device equals its plain version
    on idx[:count], and writes nothing past it, counts 0 to all."""
    args = levels[lvl]
    s = args[9].shape[0]
    mask = torch.rand(s, generator=torch.Generator().manual_seed(lvl)) < 0.3
    idx, count = active_list(mask.to(dev))
    for n in (0, 1, int(count), s):
        c = torch.tensor([n], dtype=torch.int32, device=dev)
        got = v2.fused_assemble(*args, idx, c)
        ref = v2.fused_assemble_reference(*args, idx[:n])
        torch.cuda.synchronize()
        assert torch.equal(got[:n], ref)
        assert torch.equal(got[:n], v2.fused_assemble(*args, idx[:n]))


def test_chunk_enqueues_without_a_host_sync(dev):
    """A chained solve on the tiled path runs from the staged stack to the
    packed result with no synchronising call (CUDA sync debug mode
    "error" raises at one), builds a list with active_list once a level,
    and equals the same solve on the CPU."""
    cfg, und, dfm, batch, params0 = dense_grid_problem(256, img_hw=256)
    stack = np.stack([und] + [dfm] * 3)[..., None].astype(np.uint8)
    stack_dev = torch.from_numpy(stack).to(dev)
    gb = batch.to_device(dev)
    p0 = torch.as_tensor(params0, device=dev)
    torch.cuda.synchronize()
    solve.reset_launches()
    lists = []
    orig = engine.active_list

    def counted(mask):
        lists.append(mask)
        return orig(mask)

    engine.active_list = counted
    with profiling.recording() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = correlate_frames(cfg, stack_dev, gb, p0, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            engine.active_list = orig
    # The LM-step kernel ran the steps the graphs ran: at least two a
    # level of each pair, fewer than the levels' bound of 53.
    assert solve.LAUNCHES == rec.counters["steps"]
    assert 2 * 3 * 3 <= solve.LAUNCHES < 3 * 3 * (cfg.max_iterations + 3)
    assert len(lists) == 3 * 3  # once a level of each pair
    cpu = correlate_frames(cfg, stack, batch, params0, device="cpu")
    for key in ("params", "chi", "iterations", "error"):
        assert same_bits(out[key].cpu(), cpu[key]), key


def test_subsetbatch_on_card_is_not_copied(dev):
    cfg, und, dfm, batch, _ = dense_grid_problem(64, img_hw=256)
    gb = batch.to_device(dev)
    again = SubsetBatch.to_device(gb, dev)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(gb.xy, again.xy))


@functools.lru_cache(maxsize=None)
def _levels_of(kind):
    """(cfg, levels, statics) of the dense grid (4096 subsets), the
    benchmark's annulus (512 sectors) or a blob (K1's split path at every
    level) on a pair of 1 MP frames, on the card."""
    dev = torch.device("cuda")
    if kind == "grid":
        cfg, und, dfm, batch, _ = dense_grid_problem(4096)
        pair = np.stack([und, dfm])[..., None]
    else:
        make, split = {"annulus": (annular_problem, annular_batch),
                       "blob": (blob_problem, blob_batch)}[kind]
        cfg, frames, _, dom = make(1)
        batch = split(dom, cfg.pyramid.stop)
        pair = frames[:2].astype(np.float32)
    pyr = build_pyramid(torch.as_tensor(pair, device=dev), cfg.pyramid.stop)
    statics = engine.compute_level_statics(cfg, batch, [p[1] for p in pyr])
    gb = batch.to_device(dev)
    levels = engine.prepare_levels(cfg, [p[0] for p in pyr],
                                   [p[1] for p in pyr], gb.xy, gb.mask,
                                   gb.center0, statics)
    return cfg, levels, statics


def _guesses(n, lvl, dev, seed=1):
    """assembly_levels' parameters: the motion with noise, subset 7 (where
    there is one) warped out of the image."""
    rng = np.random.default_rng(seed)
    p = np.zeros((n, 6), np.float32)
    p[:, :2] = rng.normal(0, 0.3, (n, 2))
    p[:, 1] += 1.0 / (1 << lvl)
    p[:, 2:] = rng.normal(0, 0.003, (n, 4))
    if n > 7:
        p[7, 0] = 4000.0
    return torch.as_tensor(p, device=dev)


def _level_inputs(cfg, level, params0, skip):
    """solve_level's state and step inputs of a level: (state, scaling,
    n_points, bbox, center, idx, count), the first list active_list's."""
    state = solve.LMState.start(cfg, params0)
    n_points = level.n_points.contiguous()
    scaling = torch.where(n_points > 0, 1.0 / n_points.clamp(min=1.0), 0.0)
    bbox, center = level.bbox.contiguous(), level.center.contiguous()
    return (state, scaling, n_points, bbox, center, *active_list(~skip))


def _stepwise_level(cfg, level, params0, skip, static, steps=None):
    """solve_level's device-list loop as the per-step wrappers issue it,
    all `steps` (the level's budget by default): (LevelResult, counts,
    each step's list length)."""
    state, scaling, n_points, bbox, center, idx, count = _level_inputs(
        cfg, level, params0, skip)
    s = params0.shape[0]
    steps = steps or cfg.max_iterations + 3
    lists = torch.zeros((2, s), dtype=torch.int32, device=params0.device)
    counts = torch.empty((steps, 1), dtype=torch.int32,
                         device=params0.device)
    lengths = [count]
    for k in range(steps):
        out = v2.fused_assemble(cfg.model, cfg.interpolation, static.tile_h,
                                static.tile_w, static.img_h, static.img_w,
                                level.def_img, level.pix, level.center,
                                state.p_cur, level.bbox, idx, count)
        solve.lm_step(cfg, state, out, idx, count, scaling, n_points, bbox,
                      center, level.img_hw, k == 0, lists[k % 2], counts[k])
        idx, count = lists[k % 2], counts[k]
        lengths.append(count)
    res = engine.LevelResult(state.p_cur, state.chi_lg, state.reached,
                             state.error, state.init_fail)
    return res, counts, torch.cat(lengths[:steps]).tolist()


def _steps_run(lengths):
    """The list lengths of the steps the card's graph runs: up to the
    first empty list, as the plain loop, but the initial step always."""
    k = lengths.index(0) if 0 in lengths else len(lengths)
    return lengths[:max(k, 1)]


def _graph_counts(lengths, steps):
    """The counts buffer the graph leaves: step k's next length where
    step k + 1 runs, else -1."""
    k = len(_steps_run(lengths))
    return lengths[1:k] + [-1] * (steps - k + 1)


def _launches():
    return (v2.LAUNCHES, solve.LAUNCHES,
            {k: list(v) for k, v in v2.LAUNCHES_BY_SHAPE.items()})


def _graph_level(monkeypatch, cfg, level, p0, skip, static):
    """solve_level on the card under a recording: (LevelResult, the counts
    buffer lm_level filled, what it did with the graph, the recording's
    counters)."""
    captured = []
    real = engine.lm_level

    def capture(*args):
        made = real(*args)
        captured.append((args[-1], made))
        return made

    monkeypatch.setattr(engine, "lm_level", capture)
    with profiling.recording() as rec:
        got = engine.solve_level(cfg, level, p0, skip, static)
    monkeypatch.setattr(engine, "lm_level", real)
    ((counts, made),) = captured
    return got, counts, made, rec.counters


def _check_graph_level(cfg, level, got, counts, made, counters, want,
                       lengths):
    """The graph's level against the per-step loop's: every state tensor
    bit for bit, the count rows of the steps run, -1 after, and the
    recording's counters over the steps run."""
    steps = cfg.max_iterations + 3
    run = _steps_run(lengths)
    torch.cuda.synchronize()
    for name, a in got._asdict().items():
        assert same_bits(a, want._asdict()[name]), name
    assert counts.reshape(-1).tolist() == _graph_counts(lengths, steps)
    assert made in ("instantiated", "updated")
    assert counters == {"steps": len(run), "empty_steps": run.count(0),
                        "levels": 1, "native_levels": 1,
                        "split_levels": int(v2.subset_chunks(
                            level.pix.shape[-1]) > 1),
                        "graph_levels": 1,
                        "graph_instantiations": int(made == "instantiated"),
                        "batches": 0, "batches_on_device": 0}


@pytest.mark.parametrize("kind, lvl, skipped", [
    ("grid", 0, False), ("grid", 2, False), ("annulus", 0, False),
    ("annulus", 2, False), ("grid", 1, True), ("annulus", 1, True),
    ("blob", 0, False), ("blob", 2, False)])
def test_native_level_equals_the_stepwise_loop(dev, monkeypatch, kind, lvl,
                                               skipped):
    """solve_level's one graph launch against the level's 53 steps issued
    through v2.fused_assemble and lm_step: the LevelResult bit for bit,
    the count rows of the steps the graph ran, and the recorded steps and
    the launch counters (those 53 launches each for the per-step loop)
    the plain loop's steps, which stop at the first empty list.  The blob
    takes K1's split path."""
    cfg, levels, statics = _levels_of(kind)
    level, static = levels[lvl], statics[lvl]
    s = level.pix.shape[0]
    if kind == "blob":
        assert v2.subset_chunks(level.pix.shape[2]) > 1
    p0 = _guesses(s, lvl, dev)
    skip = torch.zeros(s, dtype=torch.bool, device=dev)
    if skipped:
        skip[torch.randperm(s, generator=torch.Generator().manual_seed(3))[
            :s // 3].to(dev)] = True
    v2.reset_launches()
    solve.reset_launches()
    want, _, lengths = _stepwise_level(cfg, level, p0, skip, static)
    stepwise = _launches()
    v2.reset_launches()
    solve.reset_launches()
    got, counts, made, counters = _graph_level(monkeypatch, cfg, level, p0,
                                               skip, static)
    steps = cfg.max_iterations + 3
    assert stepwise[:2] == (steps, steps)
    k = len(_steps_run(lengths))
    assert _launches() == (k, k, {key: [k, k * m // steps]
                                  for key, (_, m) in stepwise[2].items()})
    _check_graph_level(cfg, level, got, counts, made, counters, want,
                       lengths)
    assert lengths[0] == int((~skip).sum())
    assert 1 < len(_steps_run(lengths)) < cfg.max_iterations + 3
    assert counters["empty_steps"] == 0


@pytest.mark.parametrize("kind", ["grid", "blob"])
def test_native_level_with_an_empty_first_list(dev, monkeypatch, kind):
    """Every subset skipped: the graph runs the initial step alone, on an
    empty list (the one empty step a level can run), and leaves the
    state as the per-step loop does."""
    cfg, levels, statics = _levels_of(kind)
    level, static = levels[2], statics[2]
    s = level.pix.shape[0]
    p0 = _guesses(s, 2, dev)
    skip = torch.ones(s, dtype=torch.bool, device=dev)
    want, _, lengths = _stepwise_level(cfg, level, p0, skip, static)
    assert set(lengths) == {0}
    got, counts, made, counters = _graph_level(monkeypatch, cfg, level, p0,
                                               skip, static)
    _check_graph_level(cfg, level, got, counts, made, counters, want,
                       lengths)
    assert (counters["steps"], counters["empty_steps"]) == (1, 1)


def test_native_level_to_max_iterations(dev, monkeypatch):
    """Precision 0: no subset converges, each runs to max_iterations
    (MAX_ITERS_REACHED) or an error, so the graph's loop runs far past
    the usual two iterations; bit for bit with the per-step loop."""
    cfg, levels, statics = _levels_of("annulus")
    cfg = dataclasses.replace(cfg, precision=0.0)
    level, static = levels[2], statics[2]
    s = level.pix.shape[0]
    p0 = _guesses(s, 2, dev)
    skip = torch.zeros(s, dtype=torch.bool, device=dev)
    want, _, lengths = _stepwise_level(cfg, level, p0, skip, static)
    got, counts, made, counters = _graph_level(monkeypatch, cfg, level, p0,
                                               skip, static)
    _check_graph_level(cfg, level, got, counts, made, counters, want,
                       lengths)
    assert counters["steps"] > 4
    assert int((got.error == int(ErrorCode.MAX_ITERS_REACHED)).sum()) > 0


def _direct_level(cfg, level, p0, skip, static, steps):
    """ops/solve.lm_level called as solve_level calls it, with `steps`
    count rows: (LevelResult, counts, what it did)."""
    state, scaling, n_points, bbox, center, idx, count = _level_inputs(
        cfg, level, p0, skip)
    s = p0.shape[0]
    lists = torch.zeros((2, s), dtype=torch.int32, device=p0.device)
    counts = torch.empty((steps, 1), dtype=torch.int32, device=p0.device)
    made = solve.lm_level(cfg, state, (static.tile_h, static.tile_w,
                                       static.img_h, static.img_w,
                                       level.def_img, level.pix),
                          scaling, n_points, bbox, center, level.img_hw, idx,
                          count, lists, counts)
    res = engine.LevelResult(state.p_cur, state.chi_lg, state.reached,
                             state.error, state.init_fail)
    return res, counts, made


@pytest.mark.parametrize("kind", ["grid", "blob"])
def test_native_level_stops_at_its_step_bound(dev, kind):
    """A budget of 4 steps on a level whose lists are all non-empty there
    (precision 0): the graph runs all 4 and stops at the bound, bit for
    bit with the per-step loop's 4 steps."""
    cfg, levels, statics = _levels_of(kind)
    cfg = dataclasses.replace(cfg, precision=0.0)
    level, static = levels[1], statics[1]
    s = level.pix.shape[0]
    p0 = _guesses(s, 1, dev)
    skip = torch.zeros(s, dtype=torch.bool, device=dev)
    want, _, lengths = _stepwise_level(cfg, level, p0, skip, static, 4)
    assert 0 not in lengths
    got, counts, made = _direct_level(cfg, level, p0, skip, static, 4)
    torch.cuda.synchronize()
    for name, a in got._asdict().items():
        assert same_bits(a, want._asdict()[name]), name
    assert counts.reshape(-1).tolist() == _graph_counts(lengths, 4)
    assert counts.reshape(-1).tolist()[-1] == -1


def test_native_level_reuses_its_graph(dev, monkeypatch):
    """A level run again with new tensors takes the graph its key made
    (updated, not instantiated; graph_instantiations unchanged); the
    results equal the first run's bit for bit."""
    cfg, levels, statics = _levels_of("annulus")
    level, static = levels[1], statics[1]
    s = level.pix.shape[0]
    p0 = _guesses(s, 1, dev)
    skip = torch.zeros(s, dtype=torch.bool, device=dev)
    first = _graph_level(monkeypatch, cfg, level, p0, skip, static)
    again = _graph_level(monkeypatch, cfg, level, p0, skip, static)
    assert again[2] == "updated"
    assert again[3]["graph_instantiations"] == 0
    assert again[3]["graph_levels"] == 1
    torch.cuda.synchronize()
    for name, a in again[0]._asdict().items():
        assert same_bits(a, first[0]._asdict()[name]), name
    assert torch.equal(again[1], first[1])


@pytest.mark.parametrize("fault, stage, what", [
    ("k1", "plan", "fused_assemble"), ("step", "capture", "lm_step")])
def test_native_level_names_the_failing_step(dev, monkeypatch, fault, stage,
                                             what):
    """An argument the library refuses (K1 on a path it has not, a scan
    workspace too small) raises, naming the stage of the level's graph
    (K1's plan, the capture of the initial step), the step and the
    kernel; the level runs again after it."""
    cfg, levels, statics = _levels_of("grid")
    p0 = _guesses(4096, 2, dev)
    skip = torch.zeros(4096, dtype=torch.bool, device=dev)
    if fault == "k1":
        real = v2.launch_args

        def bad_path(*args):
            k1, work = real(*args)
            return (*k1[:3], 7, *k1[4:]), work  # 7 threads a subset

        monkeypatch.setattr(v2, "launch_args", bad_path)
    else:
        real = solve._workspace
        monkeypatch.setattr(solve, "_workspace",
                            lambda lib, d, n: (real(lib, d, n)[0], 0))
    with pytest.raises(RuntimeError,
                       match=f"{stage} failed at step 0 of 53, {what} "
                             "kernel"):
        engine.solve_level(cfg, levels[2], p0, skip, statics[2])
    torch.cuda.synchronize()
    monkeypatch.undo()
    want, _, _ = _stepwise_level(cfg, levels[2], p0, skip, statics[2])
    got = engine.solve_level(cfg, levels[2], p0, skip, statics[2])
    torch.cuda.synchronize()
    for name, a in got._asdict().items():
        assert same_bits(a, want._asdict()[name]), name
