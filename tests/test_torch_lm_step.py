"""The port's LM step (ops/solve.lm_step) and its device-list loop
against the JAX engine.

One step: the plain lm_step against one step of JAX's _make_body (its
LM iteration, correlation_tpu/engine.py), given the same packed state made
with NumPy from a seed and the same assembly (a stub that returns fixed
Grams), over rows that converge, diverge, meet a singular system, an
interpolation error with the bounding box inside or outside the image,
max_iterations, lambda at either clamp, convergence, and inactive rows.
The initial step (init=True) likewise against JAX's solve_level with the
loop taken out.  Error codes, iterations, reached, active and lambda are
held exactly; parameters and chi to rtol 1e-5, the tolerance of
test_torch_solve.py, since JAX takes lax.rsqrt of the pivot.

Then: a listed step equals the whole batch's step on its rows bit for
bit and leaves the other rows alone; the step's output list (the listed
subsets still active, in list order) equals active_list of the flags
after it, on problems.lm_step_list's lists with gaps, in every model and
mode; the device-side list (active_list), and the device length taken
by the three assemblies (fused, separable, field) on the CPU; the Python
constants round as the kernel takes them; solve_level's fixed-budget
loop (no stop at the first empty list, as on the card), whose lists
after the first are the steps' output lists in two alternating buffers,
equals the early-stopping one bit for bit and JAX's solve on
tests/test_engine.py's oracle problem; and the separable and field
paths run the same device-list loop.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu import engine as jeng
from correlation_tpu.config import FittingModel as JModel
from correlation_tpu.config import SolverConfig as JSolver
from correlation_tpu_torch import engine
from correlation_tpu_torch.config import (
    NUM_PARAMS,
    ErrorCode,
    FittingModel,
    Interpolation,
    SolverConfig,
)
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops.assemble import field_assemble, sep_assemble
from correlation_tpu_torch.ops.interp import precompute_field
from correlation_tpu_torch.ops.solve import LMState, lm_step
from correlation_tpu_torch.problems import (
    LM_STEP_LISTS,
    lm_step_list,
    lm_step_problem,
)

torch.set_num_threads(2)

RTOL = 1e-5
IMG_HW = (90, 100)
MAX_IT = 12
S = 16

# Row roles in the step test.
CONVERGE, DIVERGE, SING_FRESH, SING_CACHED = 0, 1, 2, 3
ERR_INSIDE, ERR_OUTSIDE, MAX_ITERS, LAM_LOW = 4, 5, 6, 7
LAM_HIGH, CONVERGED, INACTIVE, INACTIVE2 = 8, 9, 10, 11


def _spd(rng, num_p, scale=50.0):
    g = rng.normal(size=(num_p, 3 * num_p))
    return (g @ g.T * scale).astype(np.float32)


def _gram(rng, num_p, chi_raw, bad=0.0, singular=False):
    """An 8x8 Gram in the fused assembly's layout."""
    out = np.zeros((8, 8), np.float32)
    if not singular:
        out[:num_p, :num_p] = _spd(rng, num_p)
        out[:num_p, num_p] = rng.normal(size=num_p) * 30.0
        out[num_p, :num_p] = out[:num_p, num_p]
    out[num_p, num_p] = chi_raw
    out[num_p + 1, num_p + 1] = bad
    return out


def _problem(model, seed=3):
    """(cfg, state arrays, out [S, 8, 8], scaling, n_points, bbox, center)."""
    rng = np.random.default_rng(seed)
    num_p = NUM_PARAMS[model]
    cfg = SolverConfig(model=model, max_iterations=MAX_IT)
    center = np.stack([rng.uniform(30, 60, S), rng.uniform(30, 60, S)],
                      -1).astype(np.float32)
    half = 6.0
    bbox = np.stack([center + [-half, -half], center + [-half, half],
                     center + [half, -half], center + [half, half]],
                    1).astype(np.float32)
    n_points = rng.integers(60, 170, S).astype(np.float32)
    scaling = np.float32(1.0) / n_points  # float32 division, as JAX's
    p_cur = (rng.normal(size=(S, num_p)) * 0.05).astype(np.float32)
    p_lg = (p_cur + rng.normal(size=(S, num_p)) * 0.01).astype(np.float32)
    lam = (10.0 ** rng.uniform(-6, 2, S)).astype(np.float32)
    chi_lg = rng.uniform(50, 200, S).astype(np.float32)
    iteration = rng.integers(1, MAX_IT - 1, S).astype(np.int32)
    reached = np.maximum(iteration - 1, 0).astype(np.int32)
    error = np.zeros(S, np.int32)
    active = np.ones(S, bool)
    ab = np.stack([_gram(rng, num_p, c * n) for c, n in
                   zip(chi_lg, n_points)])
    # Fresh chi below the last-good one converges, above it diverges.
    chi_new = chi_lg * rng.uniform(0.5, 0.9, S).astype(np.float32)
    chi_new[[DIVERGE, SING_CACHED, LAM_HIGH]] *= 3.0
    chi_new[CONVERGED] = chi_lg[CONVERGED] * (1 - 2e-4)
    out = np.stack([_gram(rng, num_p, c * n) for c, n in
                    zip(chi_new, n_points)])
    out[SING_FRESH] = _gram(rng, num_p, out[SING_FRESH, num_p, num_p],
                            singular=True)
    ab[SING_CACHED] = _gram(rng, num_p, ab[SING_CACHED, num_p, num_p],
                            singular=True)
    out[ERR_INSIDE, num_p + 1, num_p + 1] = 3.0
    out[ERR_OUTSIDE, num_p + 1, num_p + 1] = 1.0
    p_cur[ERR_OUTSIDE, 0] = 70.0  # the warped box leaves the image
    iteration[MAX_ITERS] = MAX_IT
    lam[LAM_LOW] = 2e-9
    lam[LAM_HIGH] = 3e8
    active[[INACTIVE, INACTIVE2]] = False
    error[INACTIVE2] = int(ErrorCode.SOLVER)
    state = dict(p_cur=p_cur, p_lg=p_lg, ab=ab, lam=lam, chi_lg=chi_lg,
                 iteration=iteration, reached=reached, error=error,
                 active=active, init_fail=np.zeros(S, bool))
    return cfg, state, out, scaling, n_points, bbox, center


def _port_state(arrays) -> LMState:
    return LMState(**{k: torch.from_numpy(np.array(v))
                      for k, v in arrays.items()})


def _jax_cfg(cfg):
    return JSolver(model=JModel(int(cfg.model)),
                   max_iterations=cfg.max_iterations)


def _jax_stub(out, num_p):
    flat_t = jnp.asarray(out.reshape(out.shape[0], 64).T)

    def assemble(params):
        del params
        return flat_t, flat_t[9 * num_p], flat_t[9 * (num_p + 1)] > 0.0

    return assemble


def _jax_level(bbox, center, n_points):
    return types.SimpleNamespace(
        center=jnp.asarray(center), bbox=jnp.asarray(bbox),
        img_hw=IMG_HW, n_points=jnp.asarray(n_points), pixdata=None)


def _step(cfg, state, out, scaling, n_points, bbox, center, rows,
          init=False, count=None):
    """lm_step on the list `rows` (out in list order) of a copy of
    `state`; returns the copy."""
    st = LMState(*(t.clone() for t in state))
    idx = torch.as_tensor(np.asarray(rows, np.int32))
    lm_step(cfg, st, torch.from_numpy(out[np.asarray(rows, int)]), idx,
            count, torch.from_numpy(scaling), torch.from_numpy(n_points),
            torch.from_numpy(bbox), torch.from_numpy(center), IMG_HW, init)
    return st


@pytest.mark.parametrize("model", list(FittingModel), ids=lambda m: m.name)
def test_step_matches_jax_body(model):
    cfg, arrays, out, scaling, n_points, bbox, center = _problem(model)
    num_p = NUM_PARAMS[model]
    rows = np.flatnonzero(arrays["active"])
    got = _step(cfg, _port_state(arrays), out, scaling, n_points, bbox,
                center, rows)

    jcfg = _jax_cfg(cfg)
    a = arrays
    st = jeng._PackedState(
        scal=jnp.asarray(np.stack([
            a["lam"], a["chi_lg"], a["iteration"].astype(np.float32),
            a["reached"].astype(np.float32), a["active"].astype(np.float32),
            a["error"].astype(np.float32)])),
        pvec=jnp.asarray(np.concatenate([a["p_cur"].T, a["p_lg"].T])),
        ab=jnp.asarray(a["ab"].reshape(S, 64).T),
        steps=jnp.int32(0),
    )
    level = _jax_level(bbox, center, n_points)
    body = jeng._make_body(jcfg, _jax_stub(out, num_p), 8,
                           jeng._make_oob(jcfg, level), jnp.asarray(scaling))
    ref = jax.tree_util.tree_map(np.asarray, body(st))
    scal = ref.scal

    np.testing.assert_array_equal(got.error.numpy(), scal[5].astype(np.int32))
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  scal[2].astype(np.int32))
    np.testing.assert_array_equal(got.reached.numpy(),
                                  scal[3].astype(np.int32))
    np.testing.assert_array_equal(got.active.numpy(), scal[4] > 0)
    np.testing.assert_array_equal(got.lam.numpy(), scal[0])
    np.testing.assert_array_equal(got.ab.numpy().reshape(S, 64), ref.ab.T)
    np.testing.assert_allclose(got.chi_lg.numpy(), scal[1], rtol=RTOL)
    np.testing.assert_allclose(got.p_cur.numpy(), ref.pvec[:num_p].T,
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got.p_lg.numpy(), ref.pvec[num_p:].T,
                               rtol=RTOL, atol=1e-6)

    # Every case did what its role says.
    err = got.error.numpy()
    assert err[SING_FRESH] == err[SING_CACHED] == ErrorCode.SOLVER
    assert err[ERR_INSIDE] == ErrorCode.INTERPOLATION_OUT_OF_IMAGE
    assert err[ERR_OUTSIDE] == ErrorCode.MODEL_OUT_OF_IMAGE
    assert err[MAX_ITERS] == err[LAM_HIGH] == ErrorCode.MAX_ITERS_REACHED
    assert err[INACTIVE2] == ErrorCode.SOLVER
    assert got.lam[LAM_LOW] == np.float32(cfg.lambda_min)
    assert got.lam[LAM_HIGH] == np.float32(cfg.lambda_max)
    act = got.active.numpy()
    assert act[[CONVERGE, DIVERGE]].all()
    assert not act[[CONVERGED, MAX_ITERS, LAM_HIGH, SING_FRESH]].any()
    assert err[CONVERGED] == ErrorCode.NONE
    for row in (INACTIVE, INACTIVE2):
        for name, t in got._asdict().items():
            np.testing.assert_array_equal(t.numpy()[row], arrays[name][row],
                                          err_msg=name)


@pytest.mark.parametrize("model", list(FittingModel), ids=lambda m: m.name)
def test_initial_step_matches_jax(monkeypatch, model):
    """init=True against JAX's solve_level with its while loop taken out:
    a normal row, an interpolation error inside and outside the image, an
    empty subset (BAD_DOMAIN), a singular system (SOLVER), and skipped
    rows, which the port leaves untouched."""
    cfg, arrays, out, scaling, n_points, bbox, center = _problem(model, 5)
    num_p = NUM_PARAMS[model]
    start = LMState.start(cfg, torch.from_numpy(arrays["p_cur"]))
    n_points[3] = 0.0
    scaling[3] = 0.0
    skip = np.zeros(S, bool)
    skip[[6, 9]] = True
    got = _step(cfg, start, out, scaling, n_points, bbox, center,
                np.flatnonzero(~skip), init=True)

    monkeypatch.setattr(jeng, "_make_assemble",
                        lambda c, lv, st: (_jax_stub(out, num_p), 8))
    monkeypatch.setattr(jax.lax, "while_loop", lambda cond, body, st: st)
    jcfg = _jax_cfg(cfg)
    ref = jeng.solve_level(jcfg, _jax_level(bbox, center, n_points),
                           jnp.asarray(arrays["p_cur"]), jnp.asarray(skip))
    ref = [np.asarray(a) for a in ref]
    np.testing.assert_array_equal(got.error.numpy(), ref[3])
    np.testing.assert_array_equal(got.init_fail.numpy(), ref[4])
    np.testing.assert_array_equal(got.reached.numpy(), ref[2])
    live = ~skip
    np.testing.assert_allclose(got.chi_lg.numpy()[live], ref[1][live],
                               rtol=RTOL)
    np.testing.assert_allclose(got.p_cur.numpy()[live], ref[0][live],
                               rtol=RTOL, atol=1e-6)
    err = got.error.numpy()
    assert err[3] == ErrorCode.BAD_DOMAIN
    assert err[SING_FRESH] == ErrorCode.SOLVER
    assert err[ERR_INSIDE] == ErrorCode.INTERPOLATION_OUT_OF_IMAGE
    assert err[ERR_OUTSIDE] == ErrorCode.MODEL_OUT_OF_IMAGE
    assert got.active.numpy().tolist() == (~got.init_fail.numpy()
                                           & live).tolist()
    np.testing.assert_array_equal(got.ab.numpy()[live], out[live])
    for name, t in got._asdict().items():
        np.testing.assert_array_equal(t.numpy()[skip],
                                      start._asdict()[name].numpy()[skip],
                                      err_msg=name)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("model", list(FittingModel), ids=lambda m: m.name)
def test_listed_step_equals_whole_batch_step(model):
    """A list in any order (with a device length past which the list
    holds rows that must not be touched) equals the whole batch's step on
    its rows bit for bit, NaN rows included, and leaves the rest alone."""
    cfg, arrays, out, scaling, n_points, bbox, center = _problem(model, 7)
    arrays["p_cur"][12] = np.nan
    arrays["p_lg"][13] = np.inf
    out[14, 0, 0] = np.nan
    state = _port_state(arrays)
    whole = _step(cfg, state, out, scaling, n_points, bbox, center,
                  np.arange(S))
    rows = np.random.default_rng(0).permutation(S)
    listed, rest = rows[:9], rows[9:]
    got = _step(cfg, state, out, scaling, n_points, bbox, center, rows,
                count=torch.tensor([len(listed)], dtype=torch.int32))
    for name, t in got._asdict().items():
        want = whole._asdict()[name]
        assert torch.equal(_bits(t[listed]), _bits(want[listed])), name
        assert torch.equal(_bits(t[rest]), _bits(state._asdict()[name][rest])), name
    empty = _step(cfg, state, out, scaling, n_points, bbox, center, rows,
                  count=torch.zeros(1, dtype=torch.int32))
    for name, t in empty._asdict().items():
        assert torch.equal(_bits(t), _bits(state._asdict()[name])), name


@pytest.mark.parametrize("stop", [None, "none", "all"],
                         ids=["roles", "none-stop", "all-stop"])
@pytest.mark.parametrize("kind", LM_STEP_LISTS)
@pytest.mark.parametrize("init", [False, True], ids=["step", "init"])
@pytest.mark.parametrize("model", list(FittingModel), ids=lambda m: m.name)
def test_step_writes_the_next_list(model, init, kind, stop):
    """The step's output list is the stable filter of idx[:count] by the
    flags it leaves, so, the listed subsets being the active ones, it
    equals active_list of those flags on its first count entries, bit
    for bit; the state equals the step's without an output list, and the
    buffer past the count is left as it was."""
    s = 37  # not a multiple of the kernel's 8-lane teams or 16-subset blocks
    cfg, arrays, out, *rest, img_hw = lm_step_problem(model, s, seed=3,
                                                      stop=stop)
    idx, count = lm_step_list(s, kind, seed=int(model))
    arrays["active"] = np.isin(np.arange(s), idx[:count])
    if init:
        arrays["active"][:] = False
    state = _port_state(arrays)
    args = [torch.from_numpy(a) for a in (out[np.minimum(idx, s - 1)],
                                          idx, np.int32([count]), *rest)]
    plain = LMState(*(t.clone() for t in state))
    lm_step(cfg, plain, *args, img_hw, init)
    got = LMState(*(t.clone() for t in state))
    idx_next = torch.full((s,), -3, dtype=torch.int32)
    count_next = torch.full((1,), -3, dtype=torch.int32)
    lm_step(cfg, got, *args, img_hw, init, idx_next, count_next)
    for name, t in got._asdict().items():
        assert torch.equal(_bits(t), _bits(plain._asdict()[name])), name
    want, want_count = engine.active_list(got.active)
    n = int(count_next)
    assert n == int(want_count)
    assert torch.equal(idx_next[:n], want[:n])
    assert (idx_next[n:] == -3).all()
    if stop == "all":
        assert n == 0
    elif stop == "none":
        assert n == count


def test_output_list_arguments_are_checked():
    cfg, arrays, out, *rest, img_hw = lm_step_problem(FittingModel.UV, 20)
    state = _port_state(arrays)
    idx = torch.arange(20, dtype=torch.int32)
    count = torch.tensor([20], dtype=torch.int32)
    tail = [torch.from_numpy(a) for a in rest]
    out = torch.from_numpy(out)
    nxt = torch.zeros(20, dtype=torch.int32)
    cnt = torch.zeros(1, dtype=torch.int32)
    bad = {
        "a host list": (None, nxt, cnt),
        "no count_next": (count, nxt, None),
        "the input list": (count, idx, cnt),
        "the input count": (count, nxt, count),
        "too little room": (count, nxt[:19], cnt),
        "int64 entries": (count, nxt.long(), cnt),
    }
    for what, (c, i_next, c_next) in bad.items():
        with pytest.raises(ValueError):
            lm_step(cfg, state, out, idx, c, *tail, img_hw, False, i_next,
                    c_next)
            pytest.fail(what)


def test_constants_round_as_the_kernel_takes_them():
    """The kernel gets precision and lambda_* as float32 (ctypes c_float,
    round to nearest); PyTorch rounds a Python scalar against a float32
    tensor the same way before the operation, for the products, clamps,
    sums and comparisons of the step."""
    rng = np.random.default_rng(11)
    t = torch.from_numpy((rng.uniform(-1, 1, 200_000)
                          * 10.0 ** rng.integers(-12, 12, 200_000))
                         .astype(np.float32))
    cfg = SolverConfig()
    for c in (cfg.precision, cfg.lambda_min, cfg.lambda_max, cfg.lambda_up,
              cfg.lambda_down):
        c32 = torch.tensor(np.float32(c))
        assert torch.equal(t * c, t * c32)
        assert torch.equal(t + c, t + c32)
        assert torch.equal(torch.clamp(t, min=c), torch.maximum(t, c32))
        assert torch.equal(torch.clamp(t, max=c), torch.minimum(t, c32))
        assert torch.equal(t < c, t < c32) and torch.equal(t >= c, t >= c32)
    assert not torch.equal(t * cfg.lambda_down,
                           (t.double() * cfg.lambda_down).float())


def test_active_list_on_the_device():
    mask = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.bool)
    idx, count = engine.active_list(mask)
    assert idx.dtype == count.dtype == torch.int32
    assert count.tolist() == [4] and idx[:4].tolist() == [1, 2, 4, 7]
    assert sorted(idx.tolist()) == list(range(8))


def _k1_args(s=6, side=9, seed=2):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 255, (60, 70, 1))
                           .astype(np.float32))
    xy = []
    for i in range(s):
        cx, cy = 15 + 7 * i, 20 + 4 * i
        gx, gy = np.meshgrid(np.arange(cx - side // 2, cx + side // 2 + 1),
                             np.arange(cy - side // 2, cy + side // 2 + 1),
                             indexing="ij")
        xy.append(np.stack([gx.ravel(), gy.ravel()], -1))
    xy = torch.from_numpy(np.stack(xy).astype(np.float32))
    mask = torch.ones(xy.shape[:2], dtype=torch.bool)
    center = xy.mean(dim=1)
    und = img[xy[..., 1].long(), xy[..., 0].long()]
    pix = v2.pack_pixels(xy, mask, und, center)
    params = torch.from_numpy((rng.normal(size=(s, 6)) * 0.02 + [0.6, -0.3,
                               0, 0, 0, 0]).astype(np.float32))
    th, tw = v2.choose_tile(side - 1, side - 1, 64, 72)
    return (FittingModel.AFFINE, Interpolation.BICUBIC, th, tw, 60, 70,
            v2.prepare_image(img, th, tw), pix, center, params,
            v2.subset_bbox(xy, mask))


def _assembly(kind):
    """assemble(idx, count=None) of `kind` on _k1_args' subsets."""
    model, interp, th, tw, h, w, img, pix, center, params, bbox = _k1_args()
    if kind == "fused":
        return lambda *lst: v2.fused_assemble(model, interp, th, tw, h, w,
                                              img, pix, center, params, bbox,
                                              *lst)
    if kind == "sep":
        return lambda *lst: sep_assemble(model, interp, th, tw, h, w, img,
                                         pix, center, params, *lst)
    field = precompute_field(img[:h, :w], interp)
    return lambda *lst: field_assemble(model, interp, field, pix, center,
                                       params, *lst)


@pytest.mark.parametrize("kind, count", [
    pytest.param(k, c, id=str(c) if k == "fused" else f"{k}-{c}")
    for k in ("fused", "sep", "field") for c in (0, 1, 4, 6)])
def test_fused_assembly_takes_a_device_length(kind, count):
    """Each assembly with count assembles idx[:count] exactly as with that
    list, and returns zero rows past it."""
    assemble = _assembly(kind)
    idx = torch.tensor([4, 1, 5, 0, 2, 3], dtype=torch.int32)
    got = assemble(idx, torch.tensor([count], dtype=torch.int32))
    assert got.shape == (6, 8, 8)
    assert not got[count:].any()
    assert count == 0 or got[:count].any()
    if count or kind == "fused":  # sep and field take no empty host list
        assert torch.equal(got[:count], assemble(idx[:count]))


def _oracle_problem():
    from synthetic import Speckle

    spk = Speckle(72, 70, seed=23)
    und = np.floor(spk.image())
    dfm = np.floor(spk.warped_image(u=0.9, v=0.7))
    grids = [(16, 16, 32, 34), (36, 20, 52, 36), (24, 40, 44, 56)]
    subsets = [np.stack(np.meshgrid(np.arange(x0, x1 + 1),
                                    np.arange(y0, y1 + 1), indexing="ij"),
                        -1).reshape(-1, 2).astype(np.float32)
               for x0, y0, x1, y1 in grids]
    return und, dfm, subsets


@pytest.fixture
def pallas_interpret(monkeypatch):
    from correlation_tpu.ops import assemble_v2 as jv2

    orig = jv2.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jv2.pl, "pallas_call", patched)
    jv2.fused_assemble.clear_cache()
    yield
    jv2.fused_assemble.clear_cache()


def test_fixed_budget_loop_matches_early_stop_and_jax(monkeypatch,
                                                      pallas_interpret):
    """tests/test_engine.py's oracle case (UV / BICUBIC, level 0): the
    loop run for its whole budget of max_iterations + 2 iterations, as on
    the card, whose late lists are empty, equals the loop that stops at
    the first empty list bit for bit, and both equal JAX's Pallas solve
    (iterations and codes exactly, parameters 5e-5, chi 5e-5 relative,
    test_torch_engine.py's tolerances).  In both, active_list runs once
    (one level), every later list is the previous step's output list, in
    the other of two alternating buffers (its length in the step's own
    row of the counts), and equals the active subsets in index order."""
    from correlation_tpu.config import Interpolation as JInterp
    from correlation_tpu.config import PyramidConfig as JPyramid
    from correlation_tpu.domains import make_batch as jax_make_batch
    from correlation_tpu.ops.pyramid import build_pyramid as jax_pyramid
    from correlation_tpu_torch.config import PyramidConfig
    from correlation_tpu_torch.domains import make_batch

    und, dfm, subsets = _oracle_problem()
    guesses = np.full((3, 2), 0.5, np.float32)
    jcfg = JSolver(model=JModel.UV, interpolation=JInterp.BICUBIC,
                   pyramid=JPyramid(0, 1, 0), backend="pallas")
    cfg = SolverConfig(model=FittingModel.UV,
                       interpolation=Interpolation.BICUBIC,
                       pyramid=PyramidConfig(0, 1, 0), backend="torch")
    und_pyr = jax_pyramid(jnp.asarray(und[..., None], jnp.float32), 0)
    def_pyr = jax_pyramid(jnp.asarray(dfm[..., None], jnp.float32), 0)
    ref = jeng.correlate(jcfg, und_pyr, def_pyr,
                         jax_make_batch(subsets, None, 0), guesses)

    def solve():
        return engine.correlate(cfg, [np.asarray(a) for a in und_pyr],
                                [np.asarray(a) for a in def_pyr],
                                make_batch(subsets, None, 0), guesses,
                                device="cpu")

    steps, lists, buffers = [], [], []
    orig_step = engine.lm_step
    orig_list = engine.active_list

    def counted(*args, **kwargs):
        state, idx, count, init, idx_next, count_next = (
            args[1], args[3], args[4], args[10], args[11], args[12])
        n = int(count[0])
        steps.append(n)
        if not init:
            assert torch.equal(idx[:n],
                               torch.nonzero(state.active).flatten().int())
            assert idx.data_ptr() == buffers[-1][0]
            assert count.data_ptr() == buffers[-1][1]
        buffers.append((idx_next.data_ptr(), count_next.data_ptr()))
        return orig_step(*args, **kwargs)

    def listed(*args, **kwargs):
        lists.append(args)
        return orig_list(*args, **kwargs)

    monkeypatch.setattr(engine, "lm_step", counted)
    monkeypatch.setattr(engine, "active_list", listed)
    early = solve()
    n_early = len(steps)
    assert len(lists) == 1
    steps.clear()
    lists.clear()
    buffers.clear()
    monkeypatch.setattr(engine, "_ends_level", lambda length: False)
    budget = solve()
    assert n_early < len(steps) == cfg.max_iterations + 3
    assert steps[-1] == 0  # the budget's late lists are empty
    assert len(lists) == 1
    # Two list buffers, alternating; a count row each step, in step order,
    # so that the level's list lengths stay on the device.
    lists_at = [b[0] for b in buffers]
    assert len(set(lists_at)) == 2
    assert lists_at[0] != lists_at[1] and lists_at[0] == lists_at[2]
    assert [b[1] for b in buffers] == [buffers[0][1] + 4 * k
                                       for k in range(len(steps))]
    for a, b in zip(early, budget):
        assert torch.equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(budget.error.numpy(), np.asarray(ref.error))
    np.testing.assert_array_equal(budget.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(budget.params.numpy(), np.asarray(ref.params),
                               atol=5e-5)
    np.testing.assert_allclose(budget.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)


@pytest.mark.parametrize("backend", ["sep", "field"])
def test_plain_assemblies_take_the_device_list(monkeypatch, backend):
    """The separable and field assemblies run the fused CPU path's loop:
    active_list once a level, and every step on a device list (an int32
    [1] count) asking for the next list, which the following step takes;
    the solve has no error."""
    from correlation_tpu_torch.config import PyramidConfig
    from correlation_tpu_torch.domains import make_batch

    und, dfm, subsets = _oracle_problem()
    cfg = SolverConfig(model=FittingModel.UV,
                       interpolation=Interpolation.BICUBIC,
                       pyramid=PyramidConfig(0, 1, 0), backend=backend)
    calls, lists = [], []
    orig_step, orig_list = engine.lm_step, engine.active_list

    def counted(*args, **kwargs):
        calls.append(args[3:5] + args[11:])
        return orig_step(*args, **kwargs)

    def listed(mask):
        lists.append(mask)
        return orig_list(mask)

    monkeypatch.setattr(engine, "lm_step", counted)
    monkeypatch.setattr(engine, "active_list", listed)
    res = engine.correlate(cfg, [und[..., None].astype(np.float32)],
                           [dfm[..., None].astype(np.float32)],
                           make_batch(subsets, None, 0),
                           np.full((3, 2), 0.5, np.float32), device="cpu")
    assert len(lists) == 1 and len(calls) > 1
    for k, (idx, count, idx_next, count_next) in enumerate(calls):
        assert count.dtype == count_next.dtype == torch.int32
        assert count.shape == count_next.shape == (1,)
        assert idx.shape == idx_next.shape == (len(subsets),)
        if k:
            prev = calls[k - 1]
            assert idx.data_ptr() == prev[2].data_ptr()
            assert count.data_ptr() == prev[3].data_ptr()
    assert int(calls[-1][3]) == 0  # the loop stopped at the empty list
    assert (res.error.numpy() == 0).all()


def test_no_kernel_launcher_synchronises():
    """The LM loop enqueues without a host sync only if the launchers in
    the kernel library wait for nothing: none calls a synchronising CUDA
    function (CUDA's sync debug mode does not see inside the library)."""
    from correlation_tpu_torch.ops import _build

    names = [src.name for src in _build._SOURCES]
    assert "lm_step.cu" in names and "fused_assemble.cu" in names
    assert _build.synchronising_calls() == {}
    assert "cudaMemcpy(" in _build.SYNC_CALLS
