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

import functools

import numpy as np
import pytest
import torch

from correlation_tpu_torch import engine
from correlation_tpu_torch.config import FittingModel
from correlation_tpu_torch.domains import SubsetBatch
from correlation_tpu_torch.engine import active_list, correlate_frames
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops import solve
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.problems import (
    LM_STEP_LISTS,
    assembly_levels,
    dense_grid_problem,
    lm_step_list,
    lm_step_problem,
)

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
    want, want_count = active_list(got.active, True)
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
    idx, count = active_list(mask.to(dev), True)
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
    before = solve.LAUNCHES
    lists = []
    orig = engine.active_list

    def counted(*args):
        lists.append(args[1])
        return orig(*args)

    engine.active_list = counted
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = correlate_frames(cfg, stack_dev, gb, p0, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        engine.active_list = orig
    assert solve.LAUNCHES - before == 3 * 3 * (cfg.max_iterations + 3)
    assert lists == [True] * 3 * 3  # once a level of each pair
    cpu = correlate_frames(cfg, stack, batch, params0, device="cpu")
    for key in ("params", "chi", "iterations", "error"):
        assert same_bits(out[key].cpu(), cpu[key]), key


def test_subsetbatch_on_card_is_not_copied(dev):
    cfg, und, dfm, batch, _ = dense_grid_problem(64, img_hw=256)
    gb = batch.to_device(dev)
    again = SubsetBatch.to_device(gb, dev)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(gb.xy, again.xy))
