"""Batched Levenberg-Marquardt updates for tiny (NP <= 6) systems.

Port of correlation_tpu/ops/solve.py (lm_delta / _chol_solve_rows) in one
[S, NP] layout.  The system is scaled by 1/N and its diagonal multiplied
by (1 + lambda), then solved by an unrolled Cholesky over the subset
axis.  A non-positive pivot makes 1/sqrt return inf or NaN, so a singular
system yields a non-finite update: that is the SOLVER signal the LM
loop reads.  torch.linalg.cholesky would raise or report instead, so
it is not used.  This is plain tensor code; the JAX package leaves the
same step to XLA.

lm_step is one whole LM iteration of a pyramid level after the assembly
(the tail of the JAX engine's _make_body, correlation_tpu/engine.py:343-453,
and, as its `init` mode, the initial step of its solve_level :597-626) over
a list of subsets: chi, the lambda schedule, the choice of the fresh or
the cached Gram, lm_delta, the saved-parameter step, the error codes and
every write of the state; given an output list, it also writes the
listed subsets still active after the step, in list order, and their
number: the next iteration's list.  On CUDA tensors it launches the
hand-written kernel csrc/lm_step.cu (a team of 8 lanes a listed subset,
the next list by a scan across blocks in the same launch), which reads
the list's length from the device and writes the next one there, so an
LM loop needs no host read and no list-building op between iterations;
on CPU tensors it runs lm_step_reference, the plain version, whose
arithmetic the kernel repeats op for op, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from correlation_tpu_torch.config import ErrorCode, SolverConfig
from correlation_tpu_torch.models.warp import warp_points

_FLT_MAX = float(np.finfo(np.float32).max)

# Launches of the LM-step kernel (CUDA tensors only): lm_step's, one a
# call, and the steps that lm_level's graphs ran, which resolve_launches()
# reads from the device and adds; reset_launches() zeroes it.
LAUNCHES = 0

# The devices where an lm_level graph was launched since
# resolve_launches() last read the steps the graphs ran, and the steps
# each graph had run then, {(device index, graph id): steps}.
_GRAPH_DEVICES: set[int] = set()
_STEPS_READ: dict[tuple[int, int], int] = {}

# The kernel's scan workspaces, {(device index, list room n): (int64
# tensor of the flags, two sets of group words and the launches' epoch;
# its flags)}, zeroed once; each launch tags its flags with the epoch and
# zeroes the group words the next one uses, so none needs clearing.  None
# is ever freed, so a CUDA graph that captured one keeps it; launches
# that share one are ordered on one stream.
_WORKSPACES: dict = {}


def reset_launches() -> None:
    """Zero LAUNCHES, after resolve_launches() has added the steps that
    graphs launched before ran."""
    global LAUNCHES
    resolve_launches()
    LAUNCHES = 0


def resolve_launches() -> None:
    """Add the steps that lm_level's graphs ran since the last call to the
    launch counters: a step is one LM-step launch here and one
    fused_assemble launch over the list room in assemble_v2's.  Where a
    graph was launched since the last call, reads the graphs' totals of
    steps on its device (_graph_totals: a sync); else does nothing."""
    global LAUNCHES
    if not _GRAPH_DEVICES:
        return
    from correlation_tpu_torch.ops import assemble_v2 as v2
    from correlation_tpu_torch.ops._build import load_library

    lib = load_library()
    for device in sorted(_GRAPH_DEVICES):
        for graph, p_len, tile_h, tile_w, n, total in _graph_totals(lib,
                                                                   device):
            steps = total - _STEPS_READ.get((device, graph), 0)
            _STEPS_READ[(device, graph)] = total
            if steps:
                v2.count_launches(p_len, tile_h, tile_w, n, steps)
                LAUNCHES += steps
    _GRAPH_DEVICES.clear()


def _graph_totals(lib, device: int) -> list[list[int]]:
    """A row (graph id, padded pixels, tile_h, tile_w, list room n, steps
    run in all) for each lm_level graph on CUDA device `device`: after
    the device's work, the library's lm_level_steps copies the totals
    into a tensor, which is read once."""
    def checked(m):
        if m < 0:
            msg = lib.fused_assemble_error_string(-m).decode()
            raise RuntimeError(f"lm_level_steps failed: {msg}")
        return m

    ptr = ctypes.c_void_p
    with torch.cuda.device(device):
        m = checked(lib.lm_level_steps(None, None, 0, None))  # the graphs
        torch.cuda.synchronize()
        rows = (ctypes.c_longlong * (5 * m))()
        totals = torch.zeros(m, dtype=torch.int64, device=f"cuda:{device}")
        if m:
            checked(lib.lm_level_steps(
                rows, ptr(totals.data_ptr()), m,
                ptr(torch.cuda.current_stream().cuda_stream)))
        return [list(rows[5 * i:5 * i + 5]) + [total]
                for i, total in enumerate(totals.tolist())]


def _chol_solve_cols(a, b, n):
    """a: n x n nested list of [S] columns, b: n [S] columns -> n [S]."""
    l = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for j in range(n):
        d = a[j][j]
        for k in range(j):
            d = d - l[j][k] * l[j][k]
        # The pivot's float32 sqrt, correctly rounded on every device: CUDA
        # builds of torch.sqrt / torch.rsqrt on float32 are approximate,
        # while a float64 sqrt rounded to float32 is the exact IEEE result.
        inv = 1.0 / torch.sqrt(d.double()).float()
        inv_d[j] = inv
        l[j][j] = d * inv  # sqrt(d); NaN when d <= 0 (singular)
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s * inv_d[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s * inv_d[i]
    return x


def lm_delta(a_mat, b_vec, lam, scaling):
    """Solve (scaling*A with diagonal * (1 + lam)) dp = scaling*b per subset.

    a_mat [S, NP, NP] and b_vec [S, NP] are unscaled sums; lam and scaling
    are [S].  Returns dp [S, NP]; singular systems give non-finite rows.
    """
    n = b_vec.shape[-1]
    damp = 1.0 + lam
    a = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            e = a_mat[:, i, j] * scaling
            if i == j:
                e = e * damp
            a[i][j] = e
    b = [b_vec[:, i] * scaling for i in range(n)]
    return torch.stack(_chol_solve_cols(a, b, n), dim=-1)


class LMState(NamedTuple):
    """The LM loop's state of one level, [S]-major; lm_step updates it in
    place (only the listed rows)."""

    p_cur: torch.Tensor  # [S, NP] float32, the tentative parameters
    p_lg: torch.Tensor  # [S, NP] float32, the last-good parameters
    ab: torch.Tensor  # [S, 8, 8] float32, the last-good Gram (cached A/b)
    lam: torch.Tensor  # [S] float32
    chi_lg: torch.Tensor  # [S] float32, the last-good chi
    iteration: torch.Tensor  # [S] int32, 1-based
    reached: torch.Tensor  # [S] int32, completed iterations
    error: torch.Tensor  # [S] int32 ErrorCode
    active: torch.Tensor  # [S] bool
    init_fail: torch.Tensor  # [S] bool, the initial step failed

    @classmethod
    def start(cls, cfg: SolverConfig, params0: torch.Tensor) -> "LMState":
        """The state before the initial step: p_cur = p_lg = params0,
        lambda = lambda_init, iteration 1, the rest zero or False."""
        s = params0.shape[0]
        dev = params0.device

        def zeros(dtype, *shape):
            return torch.zeros((s, *shape), dtype=dtype, device=dev)

        return cls(
            p_cur=params0.clone(memory_format=torch.contiguous_format),
            p_lg=params0.clone(memory_format=torch.contiguous_format),
            ab=zeros(torch.float32, 8, 8),
            lam=torch.full((s,), cfg.lambda_init, dtype=torch.float32,
                           device=dev),
            chi_lg=zeros(torch.float32),
            iteration=torch.ones(s, dtype=torch.int32, device=dev),
            reached=zeros(torch.int32), error=zeros(torch.int32),
            active=zeros(torch.bool), init_fail=zeros(torch.bool),
        )


def oob_code(model, params, bbox, center, img_hw):
    """MODEL_OUT_OF_IMAGE where a warped bounding-box corner leaves the
    image (or is not finite), else INTERPOLATION_OUT_OF_IMAGE: params
    [n, NP], bbox [n, 4, 2], center [n, 2] -> [n] int32."""
    img_h, img_w = img_hw
    corners = warp_points(model, params, bbox, center)
    x, y = corners[..., 0], corners[..., 1]
    out = (
        ~torch.isfinite(x) | ~torch.isfinite(y)
        | (x < 0.0) | (x > img_w - 1.0) | (y < 0.0) | (y > img_h - 1.0)
    )
    return torch.where(
        out.any(dim=1),
        int(ErrorCode.MODEL_OUT_OF_IMAGE),
        int(ErrorCode.INTERPOLATION_OUT_OF_IMAGE),
    ).to(torch.int32)


def _code(code: ErrorCode, like):
    return torch.full_like(like, int(code), dtype=torch.int32)


def _write_list(state: LMState, listed, idx_next, count_next) -> None:
    """The stable filter of the int32 list `listed` by state.active into
    idx_next[:k], and k into count_next."""
    if idx_next is None:
        return
    kept = listed[state.active[listed.long()]]
    idx_next[:kept.numel()] = kept
    count_next.fill_(kept.numel())


def lm_step_reference(cfg: SolverConfig, state: LMState, out, idx, count,
                      scaling, n_points, bbox, center, img_hw,
                      init: bool = False, idx_next=None,
                      count_next=None) -> None:
    """Plain PyTorch lm_step; same arguments.  Gathers the listed rows,
    updates them and writes them back (index_put), in the JAX body's
    arithmetic, each float32 op as the kernel does it; then the next
    list, where asked for."""
    rows = idx if count is None else idx[:int(count)]
    n = rows.numel()
    if n == 0:
        _write_list(state, rows, idx_next, count_next)
        return
    listed = rows
    rows = rows.long()
    out = out[:n]
    num_p = state.p_cur.shape[1]
    st = state
    sc = scaling[rows]
    q = st.p_cur[rows]
    bb, cc = bbox[rows], center[rows]
    if init:
        chi0 = out[:, num_p, num_p] * sc
        interp_err = out[:, num_p + 1, num_p + 1] > 0.0
        dp0 = lm_delta(out[:, :num_p, :num_p], out[:, :num_p, num_p],
                       st.lam[rows], sc)
        nok = n_points[rows] > 0
        solver0 = ~interp_err & nok & ~torch.isfinite(dp0).all(dim=-1)
        fail = interp_err | ~nok | solver0
        st.error[rows] = torch.where(
            interp_err,
            oob_code(cfg.model, q, bb, cc, img_hw),
            torch.where(
                ~nok,
                _code(ErrorCode.BAD_DOMAIN, rows),
                torch.where(solver0, _code(ErrorCode.SOLVER, rows),
                            _code(ErrorCode.NONE, rows)),
            ),
        )
        st.p_cur[rows] = torch.where(fail[:, None], q, q + dp0)
        st.chi_lg[rows] = torch.where(fail, _FLT_MAX, chi0)
        st.active[rows] = ~fail
        st.init_fail[rows] = fail
        st.ab[rows] = out
        _write_list(st, listed, idx_next, count_next)
        return

    prec = cfg.precision
    plg = st.p_lg[rows]
    lam_c = st.lam[rows]
    lgc = st.chi_lg[rows]
    it = st.iteration[rows]

    chi = out[:, num_p, num_p] * sc
    err_now = out[:, num_p + 1, num_p + 1] > 0.0
    delta_chi = torch.abs((lgc - chi) / (torch.maximum(lgc, chi) + prec))
    converging = chi <= lgc
    lam_next = torch.where(
        converging,
        torch.clamp(lam_c * cfg.lambda_down, min=cfg.lambda_min),
        torch.clamp(lam_c * cfg.lambda_up, max=cfg.lambda_max),
    )
    ab_old = st.ab[rows]
    ab_sel = torch.where(converging[:, None, None], out, ab_old)
    dp = lm_delta(ab_sel[:, :num_p, :num_p], ab_sel[:, :num_p, num_p],
                  lam_next, sc)
    p_new = torch.where(converging[:, None], q, plg) + dp
    solver_now = ~err_now & ~torch.isfinite(dp).all(dim=-1)
    do_step = ~(err_now | solver_now)
    converged = delta_chi < prec
    next_iter = it + 1
    exhausted = (next_iter > cfg.max_iterations) | (lam_next >= cfg.lambda_max)
    accept = do_step & converging

    st.p_cur[rows] = torch.where(do_step[:, None], p_new, q)
    st.p_lg[rows] = torch.where(accept[:, None], q, plg)
    st.ab[rows] = torch.where(accept[:, None, None], out, ab_old)
    st.chi_lg[rows] = torch.where(accept, chi, lgc)
    st.lam[rows] = torch.where(do_step, lam_next, lam_c)
    st.iteration[rows] = torch.where(do_step, next_iter, it)
    st.reached[rows] = torch.where(do_step, it, st.reached[rows])
    st.active[rows] = do_step & ~(converged | exhausted)
    st.error[rows] = torch.where(
        err_now,
        oob_code(cfg.model, q, bb, cc, img_hw),
        torch.where(
            solver_now,
            _code(ErrorCode.SOLVER, rows),
            torch.where(
                do_step & exhausted & ~converged,
                _code(ErrorCode.MAX_ITERS_REACHED, rows),
                st.error[rows],
            ),
        ),
    )
    _write_list(st, listed, idx_next, count_next)


def _check_step(state: LMState, out, idx, count, scaling, n_points, bbox,
                center, idx_next=None, count_next=None):
    """Raise unless every tensor has the dtype, shape, device and layout
    the kernel reads, and the output list is whole, on a device list and
    apart from the input list."""
    s, num_p = state.p_cur.shape
    if num_p not in (1, 2, 3, 6):
        raise ValueError(f"p_cur must be [S, NP], NP in (1, 2, 3, 6), got "
                         f"{list(state.p_cur.shape)}")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    want = {
        "p_cur": (state.p_cur, f32, (s, num_p)),
        "p_lg": (state.p_lg, f32, (s, num_p)),
        "ab": (state.ab, f32, (s, 8, 8)),
        "lam": (state.lam, f32, (s,)),
        "chi_lg": (state.chi_lg, f32, (s,)),
        "iteration": (state.iteration, i32, (s,)),
        "reached": (state.reached, i32, (s,)),
        "error": (state.error, i32, (s,)),
        "active": (state.active, b8, (s,)),
        "init_fail": (state.init_fail, b8, (s,)),
        "scaling": (scaling, f32, (s,)),
        "n_points": (n_points, f32, (s,)),
        "bbox": (bbox, f32, (s, 4, 2)),
        "center": (center, f32, (s, 2)),
        "idx": (idx, i32, (idx.shape[0],)),
        "out": (out, f32, (out.shape[0], 8, 8)),
    }
    if count is not None:
        want["count"] = (count, i32, (1,))
    if (idx_next is None) != (count_next is None):
        raise ValueError("idx_next and count_next go together")
    if idx_next is not None:
        if count is None:
            raise ValueError("an output list needs a device list (count)")
        want["idx_next"] = (idx_next, i32, (idx_next.shape[0],))
        want["count_next"] = (count_next, i32, (1,))
        if idx_next.shape[0] < idx.shape[0]:
            raise ValueError(f"idx_next has room for {idx_next.shape[0]} "
                             f"entries, the list {idx.shape[0]}")
        if (idx_next.data_ptr() == idx.data_ptr()
                or count_next.data_ptr() == count.data_ptr()):
            raise ValueError("the output list must not be the input list")
    dev = state.p_cur.device
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if out.shape[0] < idx.shape[0]:
        raise ValueError(f"out has {out.shape[0]} rows for a list of "
                         f"{idx.shape[0]}")


def _workspace(lib, dev: torch.device, n: int) -> tuple[torch.Tensor, int]:
    """The scan workspace on `dev` for launches over n list positions,
    and its flags: a power of two, at least the launch's blocks."""
    key = (dev.index, n)
    if key not in _WORKSPACES:
        flags = max(256, 1 << (lib.lm_step_flags(n) - 1).bit_length())
        _WORKSPACES[key] = (torch.zeros(lib.lm_step_workspace_words(flags),
                                        dtype=torch.int64, device=dev),
                            flags)
    return _WORKSPACES[key]


def lm_step(cfg: SolverConfig, state: LMState, out, idx, count, scaling,
            n_points, bbox, center, img_hw, init: bool = False,
            idx_next=None, count_next=None) -> None:
    """One LM iteration (init: the initial step) of the subsets listed in
    idx[:count], in place on `state`.

    out: [n, 8, 8] the assembly of list position i at row i (A, b, chi and
    the bad-pixel count in the fused assembly's layout); idx: int32 [n]
    subset indices, without repeats; count: int32 [1] on the device, the
    list's length (None: all n); scaling [S] = 1/N (0 for an empty
    subset); n_points [S] float32; bbox [S, 4, 2] and center [S, 2] the
    level's; img_hw the deformed image's (height, width); idx_next int32
    [>= n] and count_next int32 [1] (with a device count only; both or
    neither): the output list, the subsets of idx[:count] still active
    after the step in list order, and their number (entries past it are
    left as they were).

    The initial step classifies the assembly at the guess (error code,
    init_fail, active), takes the first step from it and caches it; an
    iteration compares the fresh chi with the last-good one, updates
    lambda, steps from the fresh Gram on a converging step and from the
    cached one from the last-good parameters on a diverging one, and
    stops a subset on convergence (delta-chi < precision), on
    max_iterations or lambda_max, or on an error.

    CUDA tensors launch the kernel; CPU tensors run lm_step_reference.
    """
    global LAUNCHES
    _check_step(state, out, idx, count, scaling, n_points, bbox, center,
                idx_next, count_next)
    dev = state.p_cur.device
    if dev.type == "cpu":
        lm_step_reference(cfg, state, out, idx, count, scaling, n_points,
                          bbox, center, img_hw, init, idx_next, count_next)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from correlation_tpu_torch.ops._build import check_launch, load_library

    n = idx.shape[0]
    if n == 0:
        if count_next is not None:
            count_next.zero_()
        return
    if (out.data_ptr() | state.ab.data_ptr()) % 16:
        raise ValueError("out and ab must be 16-byte aligned (the kernel "
                         "reads their rows 16 bytes at a time)")
    lib = load_library()
    ws, flags = (None, 0) if idx_next is None else _workspace(lib, dev, n)
    ptr = ctypes.c_void_p
    rc = lib.lm_step_launch(
        int(cfg.model), int(bool(init)), ptr(out.data_ptr()),
        ptr(idx.data_ptr()),
        ptr(count.data_ptr() if count is not None else None), n,
        state.p_cur.shape[0],
        *_state_args(cfg, state, scaling, n_points, bbox, center, img_hw),
        ptr(None if ws is None else idx_next.data_ptr()),
        ptr(None if ws is None else count_next.data_ptr()),
        ptr(None if ws is None else ws.data_ptr()),
        flags,
        ptr(torch.cuda.current_stream(dev).cuda_stream),
    )
    check_launch(rc, "lm_step")
    LAUNCHES += 1


def _state_args(cfg: SolverConfig, state: LMState, scaling, n_points, bbox,
                center, img_hw) -> tuple:
    """The kernel library's lm_step_launch arguments from `scaling` to
    `max_iterations`: the level's inputs, the state and the constants."""
    ptr = ctypes.c_void_p
    st = state
    img_h, img_w = img_hw
    return (
        ptr(scaling.data_ptr()), ptr(n_points.data_ptr()),
        ptr(bbox.data_ptr()), ptr(center.data_ptr()), int(img_h), int(img_w),
        ptr(st.p_cur.data_ptr()), ptr(st.p_lg.data_ptr()),
        ptr(st.ab.data_ptr()), ptr(st.lam.data_ptr()),
        ptr(st.chi_lg.data_ptr()), ptr(st.iteration.data_ptr()),
        ptr(st.reached.data_ptr()), ptr(st.error.data_ptr()),
        ptr(st.active.data_ptr()), ptr(st.init_fail.data_ptr()),
        cfg.precision, cfg.lambda_min, cfg.lambda_max, cfg.lambda_up,
        cfg.lambda_down, int(cfg.max_iterations),
    )


# lm_level_launch's info[0], the stage a failed call came from, and
# info[2], the kernel whose plan or capture failed (-1: none); info[3],
# what it did with the level's graph.
_STAGES = ("", "plan", "capture", "instantiation", "update", "launch")
_KERNELS = ("fused_assemble", "lm_step", "level_control")
_MADE = ("updated", "instantiated")


def lm_level(cfg: SolverConfig, state: LMState, assembly, scaling,
             n_points, bbox, center, img_hw, idx, count, lists,
             counts) -> str | None:
    """A pyramid level's LM loop on the card, on a device list, as one
    CUDA graph launch (csrc/lm_level.cu): the initial step, then a
    conditional WHILE node that runs an iteration while the list is not
    empty, at most counts.shape[0] - 1 of them; each step is the fused
    assembly (assemble_v2.fused_assemble) of the current list at
    state.p_cur and lm_step on it, which writes the next list.  Their
    launches are captured from the library's launchers with the per-step
    wrappers' arguments, so the results equal that loop's; nothing is
    read back.

    assembly: the fused assembly's inputs after its model and
    interpolation and before its center, (tile_h, tile_w, img_h, img_w,
    img, pix); it reads `center` and `bbox` as the step does.  idx, count:
    the first list (int32 [n], its length int32 [1] on the device); lists:
    int32 [2, n], rows the graph overwrites; counts: int32 [steps, 1],
    row k step k's next length where step k + 1 runs, else -1.  The other
    arguments are lm_step's.  Every tensor is checked once, as the
    wrappers check them at each step.  The steps that the graph runs
    reach assemble_v2's and this module's launch counters through
    resolve_launches().  Returns what the library did with the level's
    graph, "updated" (a graph of the same key kept, its arguments set
    anew) or "instantiated", or None for an empty list room (no launch).
    CUDA tensors only.
    """
    from correlation_tpu_torch.ops import assemble_v2 as v2

    tile_h, tile_w, img_h, img_w, img, pix = assembly
    n = idx.shape[0]
    steps = counts.shape[0]
    for name, t, shape in (("lists", lists, (2, n)),
                           ("counts", counts, (steps, 1))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 "
                             f"{list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
    if steps < 1 or count is None:
        raise ValueError("a level needs a step and a device list (count)")
    v2._check_inputs(img, pix, center, state.p_cur, bbox, idx, tile_h,
                     tile_w, count)
    dev = state.p_cur.device
    if dev.type != "cuda":
        raise ValueError(f"lm_level runs on a CUDA device, not {dev}")
    if n == 0:
        counts.fill_(-1)
        return None
    out = torch.empty((n, 8, 8), dtype=torch.float32, device=dev)
    _check_step(state, out, idx, count, scaling, n_points, bbox, center,
                lists[1], counts[0])
    if (out.data_ptr() | state.ab.data_ptr()) % 16:
        raise ValueError("out and ab must be 16-byte aligned (the kernel "
                         "reads their rows 16 bytes at a time)")
    from correlation_tpu_torch.ops._build import load_library

    lib = load_library()
    ws, flags = _workspace(lib, dev, n)
    k1, work = v2.launch_args(cfg.model, cfg.interpolation, tile_h, tile_w,
                              img_h, img_w, img, pix, center, state.p_cur,
                              bbox, idx, count, out)
    info = (ctypes.c_int * 4)()
    ptr = ctypes.c_void_p
    rc = lib.lm_level_launch(
        *k1, *_state_args(cfg, state, scaling, n_points, bbox, center,
                          img_hw),
        ptr(ws.data_ptr()), flags, ptr(lists.data_ptr()),
        ptr(counts.data_ptr()), steps, info,
        ptr(torch.cuda.current_stream(dev).cuda_stream),
    )
    if rc != 0:
        msg = lib.fused_assemble_error_string(rc).decode()
        where = (f" at step {info[1]} of {steps}, {_KERNELS[info[2]]} "
                 "kernel" if info[2] >= 0 else "")
        raise RuntimeError(f"lm_level: the level's graph "
                           f"{_STAGES[info[0]]} failed{where}: {msg}")
    _GRAPH_DEVICES.add(dev.index)
    return _MADE[info[3]]
