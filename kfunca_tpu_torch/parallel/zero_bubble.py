"""Zero-bubble pipeline schedules (ZB-H1 and ZB-V): hand-scheduled F/B/W.

Counterpart of kfunca_tpu/parallel/zero_bubble.py.  The pipelines of
parallel/pipeline.py get their backward from autograd through the ticks,
so the backward inherits the forward's bubble.  The zero-bubble family (Qi
et al., "Zero Bubble Pipeline Parallelism") splits each stage's backward
into

  * B, the input gradient dx, which the upstream stage waits for, and
  * W, the weight gradient dW, which nothing downstream needs and which
    fills what would be bubble ticks,

and list-schedules {F, B, W} per device.  The schedules (`zb_schedule`,
`zbv_schedule`), their audits and their costs are numpy, copied from the
JAX package as they are, so the op tables are the same bit for bit.

The runtime differs in form only.  The JAX package scans the op table in
one SPMD program under shard_map; the port walks the same table in a host
loop over the mesh's per-rank lists (parallel/mesh.py).  Each tick it hops
the activations one stage on and the gradients one stage back
(mesh.collective("shift"), non-cyclic; one batch_isend_irecv a direction
on a process group, skipped at the ticks where the table says nothing
arrives), files each arrival into a per-microbatch buffer, and runs each
rank's op for the tick:

  * F runs the stage without a graph and sends its output on;
  * B re-runs the stage with the params detached and takes
    torch.autograd.grad with respect to the INPUT only (on the last stage
    together with the loss's gradient dy), and sends dx back;
  * W re-runs the stage with the input detached and takes the gradient
    with respect to the PARAMS only, added into an fp32 dW.

B and W each re-run the stage forward, as the JAX B and W do (each is a
jax.vjp of the stage), so F, B and W launch the stage's forward kernels
three times a microbatch and its backward kernels twice.  The gradients
are sums over microbatches.  A stage function is one rank's
(stage_fn(stage_params, x)); ranks over the mesh's other axes, if any, run
their own copies.

Cost model (the JAX docstring's, in stage-forward units): GPipe + remat
~ 4 (M + S - 1) a device, ZB-H1 5 M busy plus a small residual bubble, ZB-V
6 M / (6 M + S - 1) busy.  On one card, where a LocalMesh runs the ranks
one after another, the readings measure the recompute, not the bubble.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .mesh import as_mesh
from .pipeline import _stack, rank_inputs, rank_trees

IDLE, OP_F, OP_B, OP_W = 0, 1, 2, 3


def zb_schedule(n_stages: int, n_micro: int) -> np.ndarray:
    """Greedy ZB-H1-style list schedule -> (n_stages, T) int32 op table.

    Per device, per tick, pick the first available of:
      B (critical path) > F (bounded by the 1F1B in-flight cap n-d) > W.
    Availability honors the one-tick ppermute latency: an op's producers
    must have run on a STRICTLY earlier tick.
    """
    n, m = n_stages, n_micro
    done_f = [[-1] * m for _ in range(n)]
    done_b = [[-1] * m for _ in range(n)]
    f_cnt = [0] * n
    b_cnt = [0] * n
    w_cnt = [0] * n
    cols: list[list[int]] = []
    t = 0
    while not all(c == m for c in w_cnt):
        assert t < 4 * (m + n) * n + 64, "schedule failed to converge"
        col = []
        for d in range(n):
            op = IDLE
            ib, if_, iw = b_cnt[d], f_cnt[d], w_cnt[d]
            b_ok = (
                ib < m
                and 0 <= done_f[d][ib] < t
                and (d == n - 1 or 0 <= done_b[d + 1][ib] < t)
            )
            f_ok = (
                if_ < m
                and (d == 0 or 0 <= done_f[d - 1][if_] < t)
                and (if_ - ib) < (n - d)
            )
            w_ok = iw < m and 0 <= done_b[d][iw] < t
            if b_ok:
                op = OP_B
                done_b[d][ib] = t
                b_cnt[d] += 1
            elif f_ok:
                op = OP_F
                done_f[d][if_] = t
                f_cnt[d] += 1
            elif w_ok:
                op = OP_W
                w_cnt[d] += 1
            col.append(op)
        cols.append(col)
        t += 1
    return np.asarray(cols, np.int32).T  # (n, T)


def validate_schedule(sched: np.ndarray, n_micro: int) -> None:
    """Host-side dependency audit of an op table (raises AssertionError).

    Checks, per device: ops of each kind run in microbatch order and the
    right number of times; F_i on d needs F_i on d-1 strictly earlier;
    B_i needs local F_i and downstream B_i strictly earlier; W_i needs
    local B_i strictly earlier."""
    n, T = sched.shape
    m = n_micro
    done_f = np.full((n, m), -1)
    done_b = np.full((n, m), -1)
    done_w = np.full((n, m), -1)
    cnt = np.zeros((n, 3), int)
    for t in range(T):
        for d in range(n):
            op = sched[d, t]
            if op == IDLE:
                continue
            kind = {OP_F: 0, OP_B: 1, OP_W: 2}[op]
            i = cnt[d, kind]
            assert i < m, f"device {d} ran too many ops of kind {op}"
            if op == OP_F:
                if d > 0:
                    assert 0 <= done_f[d - 1, i] < t, (d, t, i, "F needs upstream F")
                done_f[d, i] = t
            elif op == OP_B:
                assert 0 <= done_f[d, i] < t, (d, t, i, "B needs local F")
                if d < n - 1:
                    assert 0 <= done_b[d + 1, i] < t, (d, t, i, "B needs downstream B")
                done_b[d, i] = t
            else:
                assert 0 <= done_b[d, i] < t, (d, t, i, "W needs local B")
                done_w[d, i] = t
            cnt[d, kind] += 1
    assert (cnt == m).all(), f"incomplete schedule: {cnt.tolist()}"


def schedule_cost(n_stages: int, n_micro: int) -> dict:
    """Analytic tick counts: ZB-H1 table vs the scan pipeline's fwd+bwd.

    Units are TICKS of the respective schedule (a ZB tick is one of
    F/B/W ~ 1-2 fwd units; a scan-pipeline backward tick is ~3)."""
    T = zb_schedule(n_stages, n_micro).shape[1]
    scan_ticks = 2 * (n_micro + n_stages - 1)  # fwd scan + its AD transpose
    return {"zb_ticks": int(T), "scan_ticks": scan_ticks,
            "zb_busy_frac": 3 * n_micro / T}


# ---------------------------------------------------------------------------
# ZB-V: two model chunks per device in a V pattern (round 3)
# ---------------------------------------------------------------------------
#
# Each device hosts TWO chunks of the 2N-stage model: device d runs stage d
# (chunk 0) and stage 2N-1-d (chunk 1).  A microbatch flows DOWN the mesh
# through chunk 0 (device 0 -> N-1), transitions chunks ON device N-1 (no
# hop), flows back UP through chunk 1 (N-1 -> 0), and the loss lands on
# device 0 — the "V".  Backward retraces it: B1 hops 0 -> N-1, transitions
# on N-1, B0 hops N-1 -> 0.  What the V buys over ZB-H1:
#
#   * device 0 owns both the FIRST and LAST stages, so the loss is computed
#     where the input lives and the warmup/cool-down bubbles shrink to the
#     distance of HALF the mesh;
#   * in-flight activation memory is BALANCED: chunk-0 lifetime falls with
#     d while chunk-1 lifetime grows with d, so every device holds ~2N
#     microbatch activations (the 1F1B bound) instead of ZB-H1's N-d skew.
#
# The schedule is greedy (B1/B0 critical path > F1/F0 bounded by per-chunk
# in-flight caps > deferred W fills bubbles), audited by
# validate_zbv_schedule, and realized by ONE lax.scan whose tick hops four
# ring streams (act0/grad1 downward, act1/grad0 upward) and switches over
# {F0, F1, B1, B0, W1, W0, idle}.

ZV_IDLE, ZV_F0, ZV_F1, ZV_B1, ZV_B0, ZV_W1, ZV_W0 = 0, 1, 2, 3, 4, 5, 6


def zbv_schedule(n_stages: int, n_micro: int) -> np.ndarray:
    """Greedy ZB-V list schedule -> (n_stages, T) int32 op table."""
    n, m = n_stages, n_micro
    done = {k: [[-1] * m for _ in range(n)] for k in "f0 f1 b1 b0".split()}
    cnt = {k: [0] * n for k in "f0 f1 b1 b0 w1 w0".split()}
    cols: list[list[int]] = []
    t = 0
    while not all(cnt["w0"][d] == m and cnt["w1"][d] == m for d in range(n)):
        assert t < 8 * (m + n) * n + 64, "zbv schedule failed to converge"
        col = []
        for d in range(n):
            i_f0, i_f1 = cnt["f0"][d], cnt["f1"][d]
            i_b1, i_b0 = cnt["b1"][d], cnt["b0"][d]
            i_w1, i_w0 = cnt["w1"][d], cnt["w0"][d]
            # in-flight caps keep per-device activation memory ~2N while
            # letting the long-lived chunk (0 near the top, 1 near the
            # bottom) run far enough ahead to hide the V's round trip
            cap0 = min(m, 2 * n - 1 - d)
            cap1 = min(m, d + 2)
            b1_ok = (i_b1 < m and 0 <= done["f1"][d][i_b1] < t
                     and (d == 0 or 0 <= done["b1"][d - 1][i_b1] < t))
            b0_ok = (i_b0 < m and 0 <= done["f0"][d][i_b0] < t
                     and (0 <= (done["b1"][d][i_b0] if d == n - 1
                                else done["b0"][d + 1][i_b0]) < t))
            f1_ok = (i_f1 < m and (i_f1 - i_b1) < cap1
                     and (0 <= (done["f0"][d][i_f1] if d == n - 1
                                else done["f1"][d + 1][i_f1]) < t))
            f0_ok = (i_f0 < m and (i_f0 - i_b0) < cap0
                     and (d == 0 or 0 <= done["f0"][d - 1][i_f0] < t))
            if b1_ok:
                op = ZV_B1
                done["b1"][d][i_b1] = t
                cnt["b1"][d] += 1
            elif b0_ok:
                op = ZV_B0
                done["b0"][d][i_b0] = t
                cnt["b0"][d] += 1
            elif f1_ok:
                op = ZV_F1
                done["f1"][d][i_f1] = t
                cnt["f1"][d] += 1
            elif f0_ok:
                op = ZV_F0
                done["f0"][d][i_f0] = t
                cnt["f0"][d] += 1
            elif i_w1 < m and 0 <= done["b1"][d][i_w1] < t:
                op = ZV_W1
                cnt["w1"][d] += 1
            elif i_w0 < m and 0 <= done["b0"][d][i_w0] < t:
                op = ZV_W0
                cnt["w0"][d] += 1
            else:
                op = ZV_IDLE
            col.append(op)
        cols.append(col)
        t += 1
    return np.asarray(cols, np.int32).T


def validate_zbv_schedule(sched: np.ndarray, n_micro: int) -> None:
    """Host-side dependency audit of a ZB-V op table (raises AssertionError)."""
    n, T = sched.shape
    m = n_micro
    done = {k: np.full((n, m), -1) for k in ("f0", "f1", "b1", "b0")}
    cnt = np.zeros((n, 6), int)
    kinds = {ZV_F0: 0, ZV_F1: 1, ZV_B1: 2, ZV_B0: 3, ZV_W1: 4, ZV_W0: 5}
    for t in range(T):
        for d in range(n):
            op = sched[d, t]
            if op == ZV_IDLE:
                continue
            k = kinds[op]
            i = cnt[d, k]
            assert i < m, (d, t, op, "too many ops")
            if op == ZV_F0:
                if d > 0:
                    assert 0 <= done["f0"][d - 1, i] < t, (d, t, i, "F0 needs up F0")
                done["f0"][d, i] = t
            elif op == ZV_F1:
                prev = done["f0"][d, i] if d == n - 1 else done["f1"][d + 1, i]
                assert 0 <= prev < t, (d, t, i, "F1 needs F0@last / down F1")
                done["f1"][d, i] = t
            elif op == ZV_B1:
                assert 0 <= done["f1"][d, i] < t, (d, t, i, "B1 needs local F1")
                if d > 0:
                    assert 0 <= done["b1"][d - 1, i] < t, (d, t, i, "B1 needs up B1")
                done["b1"][d, i] = t
            elif op == ZV_B0:
                assert 0 <= done["f0"][d, i] < t, (d, t, i, "B0 needs local F0")
                prev = done["b1"][d, i] if d == n - 1 else done["b0"][d + 1, i]
                assert 0 <= prev < t, (d, t, i, "B0 needs B1@last / down B0")
                done["b0"][d, i] = t
            elif op == ZV_W1:
                assert 0 <= done["b1"][d, i] < t, (d, t, i, "W1 needs local B1")
            else:
                assert 0 <= done["b0"][d, i] < t, (d, t, i, "W0 needs local B0")
            cnt[d, k] += 1
    assert (cnt == m).all(), f"incomplete zbv schedule: {cnt.tolist()}"


def zbv_schedule_cost(n_stages: int, n_micro: int) -> dict:
    """Realized tick counts: 6 ops per (device, microbatch); busy_frac is
    the zero-bubble figure of merit (1.0 = no idle ticks)."""
    T = zbv_schedule(n_stages, n_micro).shape[1]
    return {"zbv_ticks": int(T), "min_ticks": 6 * n_micro,
            "zbv_busy_frac": 6 * n_micro / T}


def stack_stages_v(block_params: list, n_stages: int):
    """2 * n_stages stage trees in the ZB-V (n_stages, 2, ...) layout:
    device d's chunk 0 is stage d, its chunk 1 stage 2 * n_stages - 1 - d.
    Axis 0 is split over pp."""
    if len(block_params) != 2 * n_stages:
        raise ValueError(f"{len(block_params)} stages for 2 x {n_stages}")
    rows = [tree_map(lambda a, b: torch.stack([a, b]), block_params[d],
                     block_params[2 * n_stages - 1 - d])
            for d in range(n_stages)]
    return _stack(rows)


# -- the runtime -----------------------------------------------------------------


def _forward(stage_fn, theta, x):
    """F: the stage's output, no graph kept."""
    with torch.no_grad():
        return stage_fn(theta, x)


def _input_grad(stage_fn, theta, x, dy=None, loss=None):
    """B: (loss, dy, dx) of the stage re-run on x with the params detached;
    loss(y) given (the last stage), dy is its gradient, else dy is given."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y = stage_fn(theta, x)
        if loss is None:
            (dx,) = torch.autograd.grad(y, [x], dy)
            return None, dy, dx
        ll = loss(y).float()
        dy, dx = torch.autograd.grad(ll, [y, x])
    return ll.detach(), dy, dx


def _param_grad(stage_fn, theta, x, dy, dw) -> None:
    """W: the params' gradient of the stage re-run on the detached x, added
    into the fp32 list dw (theta's leaves in order)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(theta)]
    with torch.enable_grad():
        y = stage_fn(tree_unflatten(theta, leaves), x.detach())
        gs = torch.autograd.grad(y, leaves, dy, allow_unused=True)
    for acc, g in zip(dw, gs):
        if g is not None:
            acc.add_(g.float())


def _hop(mesh, axis, sends, offset, arrives, bufs, rx, idx, t):
    """One direction's hop at tick t, if anything arrives anywhere: each
    rank whose table entry says so files what it received in its buffer."""
    if not arrives[:, t].any():
        return
    got = mesh.collective("shift", sends, axis, offset=offset, cyclic=False)
    for i, d in enumerate(idx):
        if arrives[d, t]:
            bufs[i][rx[i]] = got[i]
            rx[i] += 1


def _step_setup(mesh, axis, stacked, x_mb, n_micro):
    trees = rank_trees(stacked)
    xs = rank_inputs(mesh, x_mb)
    if xs[0].shape[0] != n_micro:
        raise ValueError(f"{xs[0].shape[0]} microbatches for a schedule of "
                         f"{n_micro}")
    idx = [mesh.index(r, axis) for r in mesh.ranks]
    zero = torch.zeros_like(xs[0][0])
    return trees, xs, idx, zero


def _finish(mesh, axis, losses, dws, thetas):
    """The loss summed over pp (each rank's part; the last stage holds it)
    and each rank's gradients in its params' dtypes with the leading 1."""
    loss = mesh.collective("sum", losses, axis)[0]
    grads = [tree_unflatten(th, [g.to(p.dtype)[None] for g, p in
                                 zip(dw, tree_leaves(th))])
             for dw, th in zip(dws, thetas)]
    return loss, grads


def _zeros_like_leaves(theta) -> list:
    return [torch.zeros_like(p, dtype=torch.float32)
            for p in tree_leaves(theta)]


def make_zb_train_step(stage_fn, loss_fn, mesh, *, pp_axis: str = "pp",
                       n_micro: int | None = None):
    """A zero-bubble (ZB-H1) pipelined loss and gradient:

        fn(stacked_params, x_microbatches) -> (total_loss, stage_grads)

    stacked_params: a ShardedParams of pipeline.stage_shards over the
    (n_stages, ...) stacked tree, or the list of the held ranks' trees
    (leading axis 1); x_microbatches (M, mb, ...), a tensor every held
    rank sees or the list of their copies (stage 0 consumes them).
    loss_fn(y, i): the scalar loss of the last stage's output y for
    microbatch i.  total_loss is the sum over microbatches; stage_grads,
    each held rank's gradients shaped like its params, are sums over
    microbatches too."""
    mesh = as_mesh(mesh)
    n = mesh.size(pp_axis)
    if n_micro is None:
        raise ValueError("pass n_micro (the leading axis of x_microbatches)")
    sched = zb_schedule(n, n_micro)
    validate_schedule(sched, n_micro)
    m, T = n_micro, sched.shape[1]
    # a real activation lands on d at t iff d - 1 ran F at t - 1; a real
    # gradient iff d + 1 ran B at t - 1
    act = np.zeros((n, T), bool)
    grad = np.zeros((n, T), bool)
    act[1:, 1:] = sched[:-1, :-1] == OP_F
    grad[:-1, 1:] = sched[1:, :-1] == OP_B

    def fn(stacked, x_mb):
        trees, xs, idx, zero = _step_setup(mesh, pp_axis, stacked, x_mb, m)
        thetas = [tree_map(lambda p: p[0].detach(), t) for t in trees]
        x_buf = [[x[j] if d == 0 else None for j in range(m)]
                 for x, d in zip(xs, idx)]
        dy_buf = [[None] * m for _ in trees]
        dws = [_zeros_like_leaves(th) for th in thetas]
        send_act, send_grad = [zero] * len(trees), [zero] * len(trees)
        act_rx, grad_rx = [0] * len(trees), [0] * len(trees)
        cnt = [[0, 0, 0] for _ in trees]  # F, B, W done
        losses = [torch.zeros((), device=mesh.device) for _ in trees]
        for t in range(T):
            _hop(mesh, pp_axis, send_act, 1, act, x_buf, act_rx, idx, t)
            _hop(mesh, pp_axis, send_grad, -1, grad, dy_buf, grad_rx, idx,
                 t)
            for i, d in enumerate(idx):
                op, c, th = sched[d, t], cnt[i], thetas[i]
                if op == OP_F:
                    send_act[i] = _forward(stage_fn, th, x_buf[i][c[0]])
                    c[0] += 1
                elif op == OP_B:
                    j = c[1]
                    loss = ((lambda y, j=j: loss_fn(y, j)) if d == n - 1
                            else None)
                    ll, dy, dx = _input_grad(stage_fn, th, x_buf[i][j],
                                             dy_buf[i][j], loss)
                    dy_buf[i][j], send_grad[i] = dy, dx
                    if ll is not None:
                        losses[i] = losses[i] + ll
                    c[1] += 1
                elif op == OP_W:
                    j = c[2]
                    _param_grad(stage_fn, th, x_buf[i][j], dy_buf[i][j],
                                dws[i])
                    x_buf[i][j] = dy_buf[i][j] = None  # done with j
                    c[2] += 1
        return _finish(mesh, pp_axis, losses, dws, thetas)

    return fn


def make_zbv_train_step(stage_fn, loss_fn, mesh, *, pp_axis: str = "pp",
                        n_micro: int | None = None):
    """A ZB-V pipelined loss and gradient, as make_zb_train_step's: params
    stacked with stack_stages_v (leading (n_stages, 2) axes: device d holds
    stages d and 2 n_stages - 1 - d); device 0 consumes the microbatches
    and computes the loss (the V's two ends).  Gradients are sums over
    microbatches, shaped like each rank's params."""
    mesh = as_mesh(mesh)
    n = mesh.size(pp_axis)
    if n_micro is None:
        raise ValueError("pass n_micro (the leading axis of x_microbatches)")
    sched = zbv_schedule(n, n_micro)
    validate_zbv_schedule(sched, n_micro)
    m, T = n_micro, sched.shape[1]
    # arrival tables, one a stream: act0 and grad1 ride down (from d - 1),
    # act1 and grad0 up (from d + 1)
    masks = np.zeros((4, n, T), bool)
    masks[0, 1:, 1:] = sched[:-1, :-1] == ZV_F0
    masks[1, :-1, 1:] = sched[1:, :-1] == ZV_F1
    masks[2, 1:, 1:] = sched[:-1, :-1] == ZV_B1
    masks[3, :-1, 1:] = sched[1:, :-1] == ZV_B0
    offsets = (1, -1, 1, -1)

    def fn(stacked, x_mb):
        trees, xs, idx, zero = _step_setup(mesh, pp_axis, stacked, x_mb, m)
        th0 = [tree_map(lambda p: p[0, 0].detach(), t) for t in trees]
        th1 = [tree_map(lambda p: p[0, 1].detach(), t) for t in trees]
        R = len(trees)
        # buffers of x0, x1, dy1, dy0; what each rank sends on each stream
        bufs = [[[x[j] if d == 0 else None for j in range(m)]
                 for x, d in zip(xs, idx)]] + [
            [[None] * m for _ in range(R)] for _ in range(3)]
        x0, x1, dy1, dy0 = bufs
        sends = [[zero] * R for _ in range(4)]
        rx = [[0] * R for _ in range(4)]
        dw0 = [_zeros_like_leaves(th) for th in th0]
        dw1 = [_zeros_like_leaves(th) for th in th1]
        cnt = [[0] * 6 for _ in range(R)]  # F0 F1 B1 B0 W1 W0 done
        losses = [torch.zeros((), device=mesh.device) for _ in range(R)]
        for t in range(T):
            for k in range(4):
                _hop(mesh, pp_axis, sends[k], offsets[k], masks[k], bufs[k],
                     rx[k], idx, t)
            for i, d in enumerate(idx):
                op, c = sched[d, t], cnt[i]
                if op == ZV_F0:
                    j = c[0]
                    y = _forward(stage_fn, th0[i], x0[i][j])
                    if d == n - 1:  # the V turns on device n - 1
                        x1[i][j] = y
                    sends[0][i] = y
                elif op == ZV_F1:
                    sends[1][i] = _forward(stage_fn, th1[i], x1[i][c[1]])
                elif op == ZV_B1:
                    j = c[2]
                    loss = ((lambda y, j=j: loss_fn(y, j)) if d == 0
                            else None)
                    ll, dy, dx = _input_grad(stage_fn, th1[i], x1[i][j],
                                             dy1[i][j], loss)
                    dy1[i][j], sends[2][i] = dy, dx
                    if d == n - 1:
                        dy0[i][j] = dx
                    if ll is not None:
                        losses[i] = losses[i] + ll
                elif op == ZV_B0:
                    j = c[3]
                    _, _, dx = _input_grad(stage_fn, th0[i], x0[i][j],
                                           dy0[i][j])
                    sends[3][i] = dx
                elif op == ZV_W1:
                    j = c[4]
                    _param_grad(stage_fn, th1[i], x1[i][j], dy1[i][j],
                                dw1[i])
                    x1[i][j] = dy1[i][j] = None
                elif op == ZV_W0:
                    j = c[5]
                    _param_grad(stage_fn, th0[i], x0[i][j], dy0[i][j],
                                dw0[i])
                    x0[i][j] = dy0[i][j] = None
                if op != ZV_IDLE:
                    c[op - 1] += 1
        loss = mesh.collective("sum", losses, pp_axis)[0]
        grads = [tree_unflatten(a, [torch.stack([g0.to(p.dtype),
                                                 g1.to(p.dtype)])[None]
                                    for g0, g1, p in zip(w0, w1,
                                                         tree_leaves(a))])
                 for w0, w1, a in zip(dw0, dw1, th0)]
        return loss, grads

    return fn
