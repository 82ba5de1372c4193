"""The Mamba selective scan, forward and backward (K11).

Counterpart of kfunca_tpu/ops/pallas_kernels/ssm_scan.py (`ssm_scan_fwd`,
`ssm_scan_bwd`, `ssm_scan`).  On CUDA tensors the wrappers launch the
hand-written Hopper kernels in csrc/ssm_scan.cu; on CPU tensors they run the
plain PyTorch versions below.  There is no fallback between the two: a CUDA
call that cannot launch its kernel raises.

Contract (both routes, the TPU kernels'): dt, u (B, L, di), bm, c (B, L, N)
and a_t = A transposed (N, di), all fp32.  With dA_t = exp(dt_t * A),
h_t = dA_t o h_{t-1} + u_t * B_t from h_0 = 0 and y_t = C_t . h_t;
`ssm_scan_fwd` returns (y (B, L, di), h_bound (B, ceil(L / lb), N, di)),
h_bound[:, k] the state entering block k of lb steps.  `ssm_scan_bwd`
returns (ddt, du, dbm, dc, da_t) for a cotangent dy of y: ddt is the dA
path only (u is an independent input; u = dt * hidden composes in the
caller, models/mamba.ssm_apply), dbm and dc are summed over di and da_t
over the batch.  `ssm_scan` is the differentiable form.

Differences from the TPU kernels, by design: any L and di (the TPU kernel
asserts L % lb == 0 and di % dib == 0; the card's kernels mask the ragged
edges), so there is no `dib` argument; `lb` is 8, 16 or 32 on the card (the
forward's ring holds stages of `STAGE_STEPS` = 32 steps, so every h_bound
point falls inside a stage; the backward's segments of L start at h_bound
entries: 16 steps, or 32 at lb 32), any positive value in the plain
version.  Any N: the card's kernels walk the states in groups of 16
(`STATE_GROUP`), adding each group's share of y, ddt and du to the earlier
groups' in a fixed order.  A block of the card's kernels owns
`CHANNELS_PER_BLOCK` = 32 adjacent channels of one batch row: in the
forward `LANES_PER_CHANNEL` = 2 lanes a channel (two consumer warps) fed by
a producer warp, one 128-byte row of dt or u a step; in the backward one
lane a channel.
Only fp32 is taken, as the TPU kernels compute in fp32: the recurrence
compounds rounding multiplicatively.

The plain version is the chunked scan of the JAX package's XLA engine
(models/mamba.py:212-239): per chunk of lb steps a log-depth Kogge-Stone
scan of the (dA, u * B) pairs, the carried state folded in, under
torch.utils.checkpoint so that reverse mode keeps O(B * lb * di * N), not
O(B * L * di * N), in memory.  Its backward is autograd's.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ...runtime import _kernels

LB = 16  # the state is written out every LB steps
KERNEL_LBS = (8, 16, 32)
STATE_GROUP = 16  # states the kernels stage together in one walk over L
CHANNELS_PER_BLOCK = 32  # adjacent channels a block (128 bytes of a row)
STAGE_STEPS = 32  # steps a stage of the forward's ring (a multiple of lb)
LANES_PER_CHANNEL = 2  # the forward's lanes a channel, splitting its states


def _ks_scan(a, b, dim):
    """Inclusive Kogge-Stone scan of h = a * h_prev + b along `dim`, from
    h = 0: returns the composed (a_cum, b_cum), so that the state after
    step t from a carried h0 is a_cum[t] * h0 + b_cum[t].  Any length: the
    shifted-in steps are the identity (1, 0)."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_s = torch.cat([torch.ones_like(a.narrow(dim, 0, d)),
                         a.narrow(dim, 0, n - d)], dim)
        b_s = torch.cat([torch.zeros_like(b.narrow(dim, 0, d)),
                         b.narrow(dim, 0, n - d)], dim)
        a, b = a_s * a, a * b_s + b
        d *= 2
    return a, b


def _chunk(h0, dt, u, bm, c, a):
    """One chunk: h0 (B, di, N), dt/u (B, l, di), bm/c (B, l, N), a = A
    (di, N) -> (state after the chunk, y (B, l, di))."""
    dA = torch.exp(dt[..., None] * a)  # (B, l, di, N)
    dBu = u[..., None] * bm[:, :, None, :]
    a_cum, b_cum = _ks_scan(dA, dBu, 1)
    h = a_cum * h0[:, None] + b_cum
    return h[:, -1], torch.einsum("blin,bln->bli", h, c)


def chunked_scan(dt, u, bm, c, a, chunk):
    """y (B, L, di) and the states entering each chunk (B, nchunks, di, N)
    of the selective scan with A = a (di, N), chunk by chunk; each chunk
    is recomputed in the backward pass rather than saved."""
    b, L, di = dt.shape
    h = torch.zeros((b, di, a.shape[-1]), dtype=torch.float32,
                    device=dt.device)
    ys, bounds = [], []
    for t0 in range(0, L, chunk):
        bounds.append(h)
        sl = slice(t0, t0 + chunk)
        args = (h, dt[:, sl], u[:, sl], bm[:, sl], c[:, sl], a)
        if torch.is_grad_enabled():
            h, y = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            h, y = _chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), torch.stack(bounds, dim=1)


def ssm_scan_plain(dt, u, bm, c, a_t, lb=LB):
    """Plain PyTorch version of the forward (same contract): (y, h_bound).
    Differentiable; its autograd gradient is the plain backward."""
    _check(dt, u, bm, c, a_t, lb)
    y, bounds = chunked_scan(dt, u, bm, c, a_t.t(), lb)
    return y, bounds.transpose(-1, -2)


def ssm_scan_bwd_plain(dt, u, bm, c, a_t, dy, lb=LB):
    """Plain PyTorch version of the backward: autograd through
    `ssm_scan_plain` (which recomputes the states chunk by chunk)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (dt, u, bm, c, a_t)]
        y, _ = ssm_scan_plain(*leaves, lb=lb)
        return torch.autograd.grad(y, leaves, dy)


def _check(dt, u, bm, c, a_t, lb):
    if dt.ndim != 3 or u.shape != dt.shape:
        raise ValueError(f"expected dt and u of one (B, L, di) shape; got "
                         f"{tuple(dt.shape)} and {tuple(u.shape)}")
    b, L, di = dt.shape
    if bm.ndim != 3 or bm.shape[:2] != (b, L) or c.shape != bm.shape:
        raise ValueError(f"expected bm and c of one (B, L, N) shape for dt "
                         f"{tuple(dt.shape)}; got {tuple(bm.shape)} and "
                         f"{tuple(c.shape)}")
    if a_t.shape != (bm.shape[2], di):
        raise ValueError(f"expected a_t (N, di) = ({bm.shape[2]}, {di}); got "
                         f"{tuple(a_t.shape)}")
    for t in (dt, u, bm, c, a_t):
        if t.dtype != torch.float32:
            raise TypeError(f"the selective scan takes float32 only, got "
                            f"{t.dtype}")
    if len({t.device for t in (dt, u, bm, c, a_t)}) != 1:
        raise ValueError("the scan's inputs are on different devices")
    if lb <= 0:
        raise ValueError(f"lb must be positive, got {lb}")


def _check_cuda(dt, bm, lb):
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    if lb not in KERNEL_LBS:
        raise ValueError(f"the kernels take lb in {KERNEL_LBS}, got {lb}")
    if min(dt.shape) == 0 or bm.shape[2] == 0:
        raise ValueError(f"the kernels need non-empty inputs, got dt "
                         f"{tuple(dt.shape)}, N {bm.shape[2]}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ssm_scan_fwd(dt, u, bm, c, a_t, lb=LB):
    """(y, h_bound) of the selective scan.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `ssm_scan_fwd.launches`) or raise."""
    _check(dt, u, bm, c, a_t, lb)
    if dt.device.type == "cpu":
        return ssm_scan_plain(dt, u, bm, c, a_t, lb)
    _check_cuda(dt, bm, lb)
    b, L, di = dt.shape
    n = bm.shape[2]
    dt, u, bm, c, a_t = (t.contiguous() for t in (dt, u, bm, c, a_t))
    y = torch.empty_like(dt)
    h_bound = torch.empty((b, -(-L // lb), n, di), dtype=torch.float32,
                          device=dt.device)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("ssm_scan", "kf_ssm_scan_fwd",
                           (vp,) * 7 + (i32,) * 5 + (vp,))
    err = fn(dt.data_ptr(), u.data_ptr(), bm.data_ptr(), c.data_ptr(),
             a_t.data_ptr(), y.data_ptr(), h_bound.data_ptr(), b, L, di, n,
             lb, _stream(dt))
    if err:
        raise RuntimeError(f"selective scan forward launch failed: CUDA "
                           f"error {err}")
    ssm_scan_fwd.launches += 1
    return y, h_bound


ssm_scan_fwd.launches = 0


def ssm_scan_bwd(dt, u, bm, c, a_t, h_bound, dy, lb=LB):
    """(ddt, du, dbm, dc, da_t) for the cotangent dy of ssm_scan_fwd's y,
    from the forward's h_bound.

    CPU tensors run the plain version (which recomputes the states and
    ignores h_bound); CUDA tensors launch the kernels (one count in
    `ssm_scan_bwd.launches` per call: the reverse scan and the sums of its
    partials) or raise."""
    _check(dt, u, bm, c, a_t, lb)
    if dy.shape != dt.shape or dy.dtype != torch.float32:
        raise ValueError(f"dy must be float32 of dt's shape "
                         f"{tuple(dt.shape)}; got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dt.device.type == "cpu":
        return ssm_scan_bwd_plain(dt, u, bm, c, a_t, dy, lb)
    _check_cuda(dt, bm, lb)
    b, L, di = dt.shape
    n = bm.shape[2]
    if h_bound.shape != (b, -(-L // lb), n, di) or h_bound.dtype != torch.float32:
        raise ValueError(f"h_bound must be float32 (B, ceil(L / lb), N, di) = "
                         f"{(b, -(-L // lb), n, di)}; got {h_bound.dtype} "
                         f"{tuple(h_bound.shape)}")
    if len({t.device for t in (dt, h_bound, dy)}) != 1:
        raise ValueError("dt, h_bound and dy are on different devices")
    dt, u, bm, c, a_t, h_bound, dy = (
        t.contiguous() for t in (dt, u, bm, c, a_t, h_bound, dy))
    f32 = dict(dtype=torch.float32, device=dt.device)
    ncb = -(-di // CHANNELS_PER_BLOCK)
    ddt, du = torch.empty_like(dt), torch.empty_like(dt)
    dbm, dc = torch.empty((b, L, n), **f32), torch.empty((b, L, n), **f32)
    da_t = torch.empty((n, di), **f32)
    dbp = torch.empty((b, ncb, L, n), **f32)
    dcp = torch.empty((b, ncb, L, n), **f32)
    datp = torch.empty((b, n, di), **f32)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("ssm_scan", "kf_ssm_scan_bwd",
                           (vp,) * 15 + (i32,) * 5 + (vp,))
    err = fn(dt.data_ptr(), u.data_ptr(), bm.data_ptr(), c.data_ptr(),
             a_t.data_ptr(), h_bound.data_ptr(), dy.data_ptr(),
             ddt.data_ptr(), du.data_ptr(), dbm.data_ptr(), dc.data_ptr(),
             da_t.data_ptr(), dbp.data_ptr(), dcp.data_ptr(),
             datp.data_ptr(), b, L, di, n, lb, _stream(dt))
    if err:
        raise RuntimeError(f"selective scan backward launch failed: CUDA "
                           f"error {err}")
    ssm_scan_bwd.launches += 1
    return ddt, du, dbm, dc, da_t


ssm_scan_bwd.launches = 0


class _SsmScan(torch.autograd.Function):
    """forward: ssm_scan_fwd, saving h_bound; backward: ssm_scan_bwd."""

    @staticmethod
    def forward(ctx, dt, u, bm, c, a_t, lb):
        y, h_bound = ssm_scan_fwd(dt, u, bm, c, a_t, lb)
        ctx.save_for_backward(dt, u, bm, c, a_t, h_bound)
        ctx.lb = lb
        return y

    @staticmethod
    def backward(ctx, dy):
        dt, u, bm, c, a_t, h_bound = ctx.saved_tensors
        grads = ssm_scan_bwd(dt, u, bm, c, a_t, h_bound, dy.contiguous(),
                             ctx.lb)
        return (*grads, None)


def ssm_scan(dt, u, bm, c, a_t, lb=LB):
    """Differentiable y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} +
    u_t B_t: both passes as the kernels on CUDA tensors, as their plain
    versions on CPU tensors.  a_t is A TRANSPOSED (N, di)."""
    return _SsmScan.apply(dt, u, bm, c, a_t, lb)
