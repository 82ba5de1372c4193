"""Port parity: the selective scan K11 (forward and backward).

The plain PyTorch version is held against the JAX package's Pallas kernels
in interpret mode (lb=4, dib=128, as tests/test_pallas_kernels.py runs
them) on shared numpy inputs: y, h_bound and the five gradients, with a
di spanning two tiles.  A pure-torch emulation of the CUDA kernels' tiling
(csrc/ssm_scan.cu: the forward's blocks of 32 channels with two lanes a
channel walking L in 32-step stages of its ring, h_bound written inside
the stages, the lanes' sums and the groups' shares of y in a fixed order;
the backward's segments of L from their h_bound entries, per-block partial
sums over channels in a fixed order, then the sums of the partials) is
held against the JAX kernels and against the plain version at ragged
shapes, L = 1, L ending inside a stage, lb 8 / 16 / 32 below the stage,
an underflowing dA and state widths past one group of 16 (N = 32 and a
ragged N = 20).  fp32 throughout: the forward to 1e-5 and the gradients
to 1e-4 (other summation orders).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kfunca_tpu.ops.pallas_kernels import ssm_scan as jscan
from kfunca_tpu_torch.ops.pallas_kernels import ssm_scan as tscan

NAMES = ("ddt", "du", "dbm", "dc", "da_t")


def _inputs(b=2, L=16, di=128, n=8, seed=0, dt_hi=0.1):
    rng = np.random.RandomState(seed)
    dt = rng.uniform(0.001, dt_hi, (b, L, di)).astype(np.float32)
    u = rng.normal(size=(b, L, di)).astype(np.float32)
    bm = rng.normal(size=(b, L, n)).astype(np.float32)
    c = rng.normal(size=(b, L, n)).astype(np.float32)
    a_t = (-rng.uniform(0.5, 2.0, (n, di))).astype(np.float32)
    dy = rng.normal(size=(b, L, di)).astype(np.float32)
    return dt, u, bm, c, a_t, dy


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.fixture(scope="module")
def jax_case():
    """The interpret-mode JAX kernels' outputs on three shapes (one and two
    di tiles; 160 steps, two chunks of the CUDA backward)."""
    out = {}
    for key, shape in (("one_tile", dict(b=2, L=16, di=128, n=8, seed=0)),
                       ("two_tiles", dict(b=1, L=8, di=256, n=8, seed=3)),
                       ("chunks", dict(b=1, L=160, di=128, n=8, seed=5))):
        dt, u, bm, c, a_t, dy = _inputs(**shape)
        j = [jnp.asarray(x) for x in (dt, u, bm, c, a_t)]
        y, hb = jscan.ssm_scan_fwd(*j, lb=4, dib=128, interpret=True)
        grads = jscan.ssm_scan_bwd(*j, hb, jnp.asarray(dy), lb=4, dib=128,
                                   interpret=True)
        out[key] = ((dt, u, bm, c, a_t, dy), np.asarray(y), np.asarray(hb),
                    [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("key", ["one_tile", "two_tiles"])
def test_plain_forward_matches_the_jax_kernel(jax_case, key):
    (dt, u, bm, c, a_t, _), y, hb, _ = jax_case[key]
    got_y, got_hb = tscan.ssm_scan_fwd(*_t(dt, u, bm, c, a_t), lb=4)
    np.testing.assert_allclose(got_y.numpy(), y, rtol=1e-5, atol=1e-5)
    assert got_hb.shape == hb.shape
    np.testing.assert_allclose(got_hb.numpy(), hb, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["one_tile", "two_tiles"])
def test_plain_backward_matches_the_jax_kernel(jax_case, key):
    (dt, u, bm, c, a_t, dy), _, _, grads = jax_case[key]
    x = _t(dt, u, bm, c, a_t)
    _, hb = tscan.ssm_scan_fwd(*x, lb=4)
    got = tscan.ssm_scan_bwd(*x, hb, torch.from_numpy(dy), lb=4)
    for g, want, name in zip(got, grads, NAMES):
        assert g.shape == want.shape, name
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_differentiable_scan_matches_the_jax_kernel_vjp(jax_case):
    """ssm_scan (the autograd.Function) routes its backward through
    ssm_scan_bwd: autograd's gradients are the JAX kernel's."""
    (dt, u, bm, c, a_t, dy), y, _, grads = jax_case["one_tile"]
    leaves = [t.requires_grad_(True) for t in _t(dt, u, bm, c, a_t)]
    out = tscan.ssm_scan(*leaves, lb=4)
    np.testing.assert_allclose(out.detach().numpy(), y, rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    for g, want, name in zip(got, grads, NAMES):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# -- the CUDA kernels' tiling, emulated -----------------------------------------

CH = tscan.CHANNELS_PER_BLOCK
G = tscan.LANES_PER_CHANNEL  # lane g holds states g * S .. g * S + S - 1
NG = tscan.STATE_GROUP  # states a walk over L
S = NG // G
T = tscan.STAGE_STEPS  # steps a stage of the forward's ring
LOG2E = np.float32(1.4426950408889634)


def _lane_sums(terms):
    """y's share of one group of states as the forward takes it: terms
    (NG, channels) in state order (zeros past N); lane g adds its S states
    in order, then step_sums adds the channel's two lanes (0 + 1)."""
    assert G == 2, G
    lanes = []
    for g in range(G):
        acc = torch.zeros_like(terms[0])
        for s in range(g * S, g * S + S):
            acc = acc + terms[s]
        lanes.append(acc)
    return lanes[0] + lanes[1]


def emulate_fwd(dt, u, bm, c, a_t, lb):
    """ssm_fwd_ring_kernel: a block of CH channels of one batch row walks
    L once per group of NG states, in stages of T steps read from the ring
    (zeros past L, di and N: dA = 1 and nothing added); at every lb-th step
    (T % lb == 0, so inside a stage) the state entering it goes to h_bound;
    per step each state's decay 2^(dt * a log2 e), its multiply-adds and
    the lanes' sums; from the second group on y adds to the earlier
    groups' share, in group order."""
    assert T % lb == 0, lb
    b, L, di = dt.shape
    n = bm.shape[2]
    nst = -(-L // T)
    ngrp = -(-n // NG)
    Lp, dip, npad = nst * T, -(-di // CH) * CH, ngrp * NG

    def pad(x, steps, width):
        out = torch.zeros((x.shape[0], steps, width))
        out[:, :x.shape[1], :x.shape[2]] = x
        return out

    dtp, up = pad(dt, Lp, dip), pad(u, Lp, dip)
    bmp, cp = pad(bm, Lp, npad), pad(c, Lp, npad)
    a2 = torch.zeros((npad, dip))
    a2[:n, :di] = a_t * torch.tensor(LOG2E)
    nblk = -(-L // lb)
    y = torch.zeros((b, Lp, dip))
    hb = torch.zeros((b, nblk, npad, dip))
    for ib in range(b):
        for c0 in range(0, dip, CH):
            ch = slice(c0, c0 + CH)
            for n0 in range(0, npad, NG):
                st = slice(n0, n0 + NG)
                h = torch.zeros((NG, CH))
                for k in range(nst):
                    for i in range(T):
                        t = k * T + i
                        if i % lb == 0 and t < L:
                            hb[ib, t // lb, st, ch] = h
                        dA = torch.exp2(dtp[ib, t, ch] * a2[st, ch])
                        h = dA * h + up[ib, t, ch] * bmp[ib, t, st, None]
                        part = _lane_sums(cp[ib, t, st, None] * h)
                        y[ib, t, ch] = part if n0 == 0 else y[ib, t, ch] + part
    return y[:, :L, :di], hb[:, :, :n, :di]


def _ordered_sum(x, dim):
    """Sum over `dim` one slice after another (the kernels' fixed order)."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


W = 8  # segments of L a backward block, one a warp (kBwdWarps)


def _fold(v, seg):
    """fold_lanes: the sum over a warp's 32 channels (v[..., channel]) as
    the kernel takes it: with 16-step segments each half of 16 channels as
    four sums (channels j % 4 == 0..3 of the half, each in order) added
    (0 + 1) + (2 + 3), then the halves added; with 32-step ones all 32
    channels the same way."""
    def fours(x):
        acc = [torch.zeros_like(x[..., 0]) for _ in range(4)]
        for j in range(x.shape[-1]):
            acc[j % 4] = acc[j % 4] + x[..., j]
        return (acc[0] + acc[1]) + (acc[2] + acc[3])

    if seg == 32:
        return fours(v)
    return fours(v[..., :16]) + fours(v[..., 16:])


def emulate_bwd(dt, u, bm, c, a_t, hb, dy, lb):
    """ssm_bwd_kernel + sum_parts_kernel: a block is CH channels (lanes) by
    W segments of seg = max(16, lb) steps (warps), each segment starting
    from its h_bound entry; per state the segments' reverse maps (P, Q)
    compose right to left onto the chunk's carry, chunks run from the last
    to the first; sums over the block's channels in fold_lanes' order,
    per-(channel block) partials of dbm and dc, per-batch partials of da_t
    summed over the segments in order; then the partials summed in order.
    Steps past L are the identity (zeros, dA = 1)."""
    b, L, di = dt.shape
    n = bm.shape[2]
    seg = max(16, lb)
    R = W * seg
    nchunk = -(-L // R)
    ncb = -(-di // CH)
    Lp, dip = nchunk * R, ncb * CH

    def pad(x, steps, chans):
        out = torch.zeros((x.shape[0], steps, chans))
        out[:, :x.shape[1], :x.shape[2]] = x
        return out

    dtp, up, dyp = (pad(x, Lp, dip) for x in (dt, u, dy))
    bmp, cp = pad(bm, Lp, n), pad(c, Lp, n)
    ap = torch.zeros((n, dip))
    ap[:, :di] = a_t
    ddt, du = torch.zeros((b, Lp, dip)), torch.zeros((b, Lp, dip))
    dbp = torch.zeros((b, ncb, L, n))
    dcp = torch.zeros((b, ncb, L, n))
    datp = torch.zeros((b, n, dip))
    for ib in range(b):
        for cb in range(ncb):
            ch = slice(cb * CH, cb * CH + CH)
            for n0 in range(0, n, NG):
                ng = min(NG, n - n0)
                carry = torch.zeros((ng, CH))
                sda = torch.zeros((ng, W, CH))
                for q in range(nchunk):
                    c0 = (nchunk - 1 - q) * R
                    rows = slice(c0, c0 + R)
                    xdt, xu, xdy = (x[ib, rows, ch].reshape(W, seg, CH)
                                    for x in (dtp, up, dyp))
                    gdt = torch.zeros((W, seg, CH))
                    gdu = torch.zeros((W, seg, CH))
                    tb, tc = torch.zeros((R, ng)), torch.zeros((R, ng))
                    for s in range(ng):
                        a = ap[n0 + s, ch]
                        h = torch.zeros((W, CH))
                        for w in range(W):
                            t0 = c0 + w * seg
                            if t0 < L:
                                h[w, :min(CH, di - cb * CH)] = \
                                    hb[ib, t0 // lb, n0 + s, ch]
                        B = bmp[ib, rows, n0 + s].reshape(W, seg, 1)
                        C = cp[ib, rows, n0 + s].reshape(W, seg, 1)
                        dA = torch.exp(xdt * a)
                        hp, v = torch.zeros_like(dA), torch.zeros_like(dA)
                        for i in range(seg):
                            hp[:, i] = h
                            h = dA[:, i] * h + xu[:, i] * B[:, i]
                            v[:, i] = h * xdy[:, i]
                        P, Q = torch.ones((W, CH)), torch.zeros((W, CH))
                        for i in range(seg - 1, -1, -1):
                            Q = dA[:, i] * (Q + C[:, i] * xdy[:, i])
                            P = P * dA[:, i]
                        tc[:, s] = _fold(v, seg).reshape(R)
                        g_in, g = torch.zeros((W, CH)), carry[s]
                        for w in range(W - 1, -1, -1):
                            g_in[w] = g
                            g = P[w] * g + Q[w]
                        carry[s] = g
                        g, da = g_in, torch.zeros((W, CH))
                        for i in range(seg - 1, -1, -1):
                            delta = g + C[:, i] * xdy[:, i]
                            dda = delta * hp[:, i] * dA[:, i]
                            gdt[:, i] += dda * a
                            da = da + dda * xdt[:, i]
                            gdu[:, i] += delta * B[:, i]
                            v[:, i] = delta * xu[:, i]
                            g = dA[:, i] * delta
                        sda[s] += da
                        tb[:, s] = _fold(v, seg).reshape(R)
                    ddt[ib, rows, ch] += gdt.reshape(R, CH)
                    du[ib, rows, ch] += gdu.reshape(R, CH)
                    live = min(R, L - c0)
                    dbp[ib, cb, c0:c0 + live, n0:n0 + ng] = tb[:live]
                    dcp[ib, cb, c0:c0 + live, n0:n0 + ng] = tc[:live]
                datp[ib, n0:n0 + ng, ch] = _ordered_sum(sda, 1)
    return (ddt[:, :L, :di], du[:, :L, :di], _ordered_sum(dbp, 1),
            _ordered_sum(dcp, 1), _ordered_sum(datp, 0)[:, :di])


EDGES = {
    # ragged L-block and a ragged channel block
    "ragged": dict(b=2, L=37, di=45, n=5, lb=8),
    "one_step": dict(b=1, L=1, di=33, n=3, lb=16),
    "many_blocks": dict(b=1, L=50, di=32, n=4, lb=8),
    # dt * A so negative that dA underflows to exactly 0
    "underflow": dict(b=1, L=19, di=40, n=4, lb=16, dt_hi=80.0),
    # two full groups of states, and a ragged second group
    "two_groups": dict(b=1, L=11, di=36, n=32, lb=8),
    "ragged_groups": dict(b=2, L=9, di=33, n=20, lb=8),
    # several chunks of the backward (W segments of 16 steps: 128), the
    # last one ragged; 32-step segments (lb 32: chunks of 256); two groups
    # of states over several chunks
    "chunks": dict(b=1, L=300, di=40, n=4, lb=16),
    "chunks_lb32": dict(b=1, L=300, di=33, n=3, lb=32),
    "chunks_two_groups": dict(b=1, L=150, di=33, n=32, lb=8),
}


@pytest.mark.parametrize("key", ["one_tile", "two_tiles", "chunks"])
def test_backward_emulation_matches_the_jax_kernel(jax_case, key):
    """The CUDA backward's decomposition, emulated, against the JAX kernel
    in interpret mode, from the JAX forward's own h_bound (lb 4: the
    16-step segments start at every fourth entry); 1e-4 x max(1, max |ref|)
    (other summation orders)."""
    (dt, u, bm, c, a_t, dy), _, hb, grads = jax_case[key]
    got = emulate_bwd(*_t(dt, u, bm, c, a_t, np.array(hb), dy), lb=4)
    for g, want, name in zip(got, grads, NAMES):
        assert g.shape == want.shape, name
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("key", ["one_tile", "two_tiles", "chunks"])
def test_forward_emulation_matches_the_jax_kernel(jax_case, key):
    """The CUDA forward's ring of stages, emulated, against the JAX kernel
    in interpret mode (lb 4: eight h_bound points a 32-step stage; the
    160-step case ends inside its fifth stage)."""
    (dt, u, bm, c, a_t, _), y, hb, _ = jax_case[key]
    got_y, got_hb = emulate_fwd(*_t(dt, u, bm, c, a_t), lb=4)
    np.testing.assert_allclose(got_y.numpy(), y, rtol=1e-5, atol=1e-5)
    assert got_hb.shape == hb.shape
    np.testing.assert_allclose(got_hb.numpy(), hb, rtol=1e-5, atol=1e-5)


STAGES = {
    # L ending inside a stage, at each lb below the stage's 32 steps
    "inside_lb8": dict(b=2, L=45, di=40, n=4, lb=8),
    "inside_lb16": dict(b=1, L=50, di=33, n=16, lb=16),
    "inside_lb32": dict(b=1, L=100, di=32, n=3, lb=32),
    # L a whole number of stages; one step; h_bound at every 8th step
    "whole_stages": dict(b=1, L=64, di=36, n=5, lb=32),
    "one_step": dict(b=1, L=1, di=8, n=16, lb=8),
    "lb8_many": dict(b=1, L=97, di=16, n=4, lb=8),
    # two full groups and a ragged second group across several stages
    "two_groups": dict(b=1, L=70, di=33, n=32, lb=16),
    "ragged_groups": dict(b=2, L=75, di=20, n=20, lb=8),
}


@pytest.mark.parametrize("case", sorted(STAGES))
def test_forward_stage_emulation_matches_plain(case):
    """The forward's stages against the plain chunked scan: y, and h_bound
    at every lb-th step (inside the stages)."""
    kw = dict(STAGES[case])
    lb = kw.pop("lb")
    dt, u, bm, c, a_t, _ = _t(*_inputs(seed=11, **kw))
    y, hb = emulate_fwd(dt, u, bm, c, a_t, lb)
    ref_y, ref_hb = tscan.ssm_scan_plain(dt, u, bm, c, a_t, lb)
    assert hb.shape == ref_hb.shape == (kw["b"], -(-kw["L"] // lb), kw["n"],
                                        kw["di"])
    torch.testing.assert_close(y, ref_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hb, ref_hb, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(EDGES))
def test_kernel_tiling_emulation_matches_plain(case):
    kw = dict(EDGES[case])
    lb = kw.pop("lb")
    dt, u, bm, c, a_t, dy = _t(*_inputs(seed=7, **kw))
    if case == "underflow":
        a_t = a_t * 20.0
        assert float(torch.exp(dt[..., None] * a_t.t()).min()) == 0.0
    y, hb = emulate_fwd(dt, u, bm, c, a_t, lb)
    ref_y, ref_hb = tscan.ssm_scan_plain(dt, u, bm, c, a_t, lb)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, ref_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hb, ref_hb, rtol=1e-5, atol=1e-5)
    got = emulate_bwd(dt, u, bm, c, a_t, hb, dy, lb)
    want = tscan.ssm_scan_bwd_plain(dt, u, bm, c, a_t, dy, lb)
    for g, r, name in zip(got, want, NAMES):
        assert g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
        tol = 1e-4 * max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, rtol=1e-4, atol=tol, msg=name)


@pytest.mark.parametrize("lb", [1, 4, 16, 64])
def test_plain_block_length_changes_only_h_bound(lb):
    """y and the gradients do not depend on lb (the chunking); h_bound
    holds the state entering every lb-th step."""
    dt, u, bm, c, a_t, dy = _t(*_inputs(b=1, L=23, di=16, n=4, seed=2))
    y, hb = tscan.ssm_scan_plain(dt, u, bm, c, a_t, lb)
    y1, hb1 = tscan.ssm_scan_plain(dt, u, bm, c, a_t, 1)
    torch.testing.assert_close(y, y1, rtol=1e-5, atol=1e-5)
    assert hb.shape == (1, math.ceil(23 / lb), 4, 16)
    torch.testing.assert_close(hb, hb1[:, ::lb], rtol=1e-5, atol=1e-5)
    g = tscan.ssm_scan_bwd_plain(dt, u, bm, c, a_t, dy, lb)
    g1 = tscan.ssm_scan_bwd_plain(dt, u, bm, c, a_t, dy, 1)
    for a, b_, name in zip(g, g1, NAMES):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-4, msg=name)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    dt, u, bm, c, a_t, dy = _t(*_inputs(b=1, L=4, di=8, n=2))
    with pytest.raises(TypeError, match="float32 only"):
        tscan.ssm_scan_fwd(dt.half(), u, bm, c, a_t)
    with pytest.raises(ValueError, match="a_t"):
        tscan.ssm_scan_fwd(dt, u, bm, c, a_t.t())
    with pytest.raises(ValueError, match="dy"):
        tscan.ssm_scan_bwd(dt, u, bm, c, a_t, None, dy[:, :2])
    meta = [t.to("meta") for t in (dt, u, bm, c, a_t)]
    with pytest.raises(ValueError, match="unsupported device"):
        tscan.ssm_scan_fwd(*meta)
    assert tscan.ssm_scan_fwd.launches == 0
    assert tscan.ssm_scan_bwd.launches == 0
