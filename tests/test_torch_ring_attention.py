"""Port parity: ring attention and its hop kernel (K12).

The same numpy inputs, made from a seed, go through the JAX package and the
port:
- the port's plain hops (which its wrappers run for CPU tensors, and which
  the CUDA kernels are held against on the card: tests/test_torch_cuda.py,
  chip_smoke.py) against the JAX package's Pallas hop kernels, called
  directly in interpret mode as tests/test_ring_attention.py calls them;
- the whole ring through `LocalRing(n)` and through a 4-rank gloo
  `ProcessGroupRing` against JAX's `make_ring_attention` on a `cp` mesh of
  the conftest's virtual CPU devices (its einsum ring, `jax.grad`);
- plain-torch emulations of the CUDA kernels' tilings at tiny shapes: the
  fp32 tile's against the plain hops, and the bf16 wgmma body's (which
  rounds p and ds to bf16, as the JAX kernel does) against the plain hops
  and the JAX hop kernels in interpret mode, at the bf16 bound below.
Tolerances: fp32 2e-5 for a hop and 1e-5 for the ring (the same fp32 sums
in another order).  bf16: both sides take the same bf16 inputs and sum in
fp32, but the JAX kernel rounds p and ds to bf16 before the second product
and the port keeps them fp32, so an accumulated sum sum_j x_j y_j may move
by 2^-9 sum_j |x_j| |y_j|: the bound below is 2^-8 of that sum of absolute
terms, computed from the inputs.
"""

import math
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from kfunca_tpu.ops.pallas_kernels import ring_hop as jhop
from kfunca_tpu.parallel import ring_attention as jring
from kfunca_tpu_torch.ops import attention as tattn
from kfunca_tpu_torch.ops.pallas_kernels import ring_hop as thop
from kfunca_tpu_torch.parallel import ring_attention as tring

import torch_ring_ranks

# (name, sq, skv, d, hops): each hop (q_off, kv_off) applied in turn to one
# carry; the second hop is the case's kind; the hd-256 instances (Gemma's
# head width, and 200 padded to 256 on the card) past a diagonal
HOP_CASES = {
    "diagonal": (128, 128, 128, [(0, 0), (128, 128)]),
    "past": (128, 128, 128, [(128, 128), (128, 0)]),
    "future": (128, 128, 128, [(0, 0), (0, 128)]),
    "ragged": (200, 200, 64, [(200, 200), (200, 0)]),
    "hd256_past": (128, 128, 256, [(128, 128), (128, 0)]),
    "hd200_ragged_past": (100, 100, 200, [(100, 100), (100, 0)]),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, H = 1, 2


def _uniform(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _hop_inputs(sq, skv, d, seed):
    """q (already scaled by 1/sqrt(d)), two (k, v) shards and g."""
    rng = np.random.default_rng(seed)
    q = _uniform(rng, B, H, sq, d) * np.float32(1 / math.sqrt(d)) * 4
    kvs = [(_uniform(rng, B, H, skv, d), _uniform(rng, B, H, skv, d))
           for _ in range(2)]
    return q, kvs, _uniform(rng, B, H, sq, d)


def _bf16(x):
    """x rounded to bf16 and back to fp32 (both sides start from it)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _jax_fwd(q, kvs, hops, d, jdt):
    """[(m, l, acc) after each hop] from the Pallas hop in interpret mode,
    cut to the port's layout."""
    b, h, sq, _ = q.shape
    m, l, acc = jhop.hop_carry_init(b, h, sq, d)
    out = []
    for (qo, ko), (k, v) in zip(hops, kvs):
        m, l, acc = jhop.flash_attention_hop(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            m, l, acc, jnp.int32(qo), jnp.int32(ko), interpret=True)
        out.append((np.asarray(m[:, :sq, 0]), np.asarray(l[:, :sq, 0]),
                    np.asarray(acc[:, :sq, :d])))
    return out


def _torch_fwd(q, kvs, hops, d, tdt):
    b, h, sq, _ = q.shape
    carry = thop.hop_carry_init(b, h, sq, d, device="cpu")
    out = []
    for (qo, ko), (k, v) in zip(hops, kvs):
        thop.flash_attention_hop(
            *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), *carry, qo, ko)
        out.append(tuple(t.clone().numpy() for t in carry))
    return out


@pytest.fixture(scope="module")
def fwd_hops():
    """{(case, dtype): (JAX carries, port carries, inputs)}."""
    res = {}
    for name, (sq, skv, d, hops) in HOP_CASES.items():
        q, kvs, _ = _hop_inputs(sq, skv, d, seed=len(res))
        for dname, (jdt, tdt) in DTYPES.items():
            res[name, dname] = (_jax_fwd(q, kvs, hops, d, jdt),
                                _torch_fwd(q, kvs, hops, d, tdt), (q, kvs))
    return res


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(HOP_CASES))
def test_plain_hop_matches_the_jax_kernel(fwd_hops, case, dtype):
    want, got, (q, kvs) = fwd_hops[case, dtype]
    for (wm, wl, wacc), (gm, gl, gacc) in zip(want, got):
        np.testing.assert_allclose(gm, wm, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(gl, wl, atol=2e-5, rtol=2e-5)
        if dtype == "float32":
            np.testing.assert_allclose(gacc, wacc, atol=2e-5, rtol=2e-5)
        else:
            # sum_j p_j |v_j| <= l max |v|, p rounded to bf16 on the JAX side
            vmax = max(np.abs(_bf16(v)).max() for _, v in kvs)
            bound = 2.0 ** -8 * gl[..., None] * vmax + 2e-5
            assert (np.abs(gacc - wacc) <= bound).all(), np.abs(
                gacc - wacc).max()


def test_a_future_hop_keeps_the_carry_bit_for_bit(fwd_hops):
    for dtype in DTYPES:
        want, got, _ = fwd_hops["future", dtype]
        for before, after in zip(got[0], got[1]):
            assert np.array_equal(before, after)
        for before, after in zip(want[0], want[1]):
            assert np.array_equal(before, after)


def _bwd_setup(sq, skv, d, hops, seed):
    """Inputs of the backward hops: a global lse and delta from the forward
    carry after both hops, as the ring computes them."""
    q, kvs, g = _hop_inputs(sq, skv, d, seed)
    carry = thop.hop_carry_init(B, H, sq, d, device="cpu")
    for (qo, ko), (k, v) in zip(hops, kvs):
        thop.flash_attention_hop_plain(
            *(torch.from_numpy(x) for x in (q, k, v)), *carry, qo, ko)
    m, l, acc = carry
    lse = thop.hop_lse(m, l).numpy()
    out = thop.hop_finalize(l, acc, B, H, sq, d, torch.float32)
    delta = (torch.from_numpy(g) * out).sum(-1).reshape(B * H, sq).numpy()
    return q, kvs, g, lse, delta


def _jax_bwd(q, kvs, g, lse, delta, hops, d, jdt):
    b, h, sq, _ = q.shape
    skv = kvs[0][0].shape[2]
    sqp = jhop.hop_carry_init(b, h, sq, d)[0].shape[1]
    rep = lambda x: jhop.lane_replicate_rows(
        jnp.asarray(x).reshape(b, h, sq), b, h, sq, sqp)
    dq, dk, dv = jhop.bwd_carry_init(b, h, sq, skv, d)
    out = []
    for (qo, ko), (k, v) in zip(hops, kvs):
        dq, dk, dv = jhop.flash_attention_bwd_hop(
            *(jnp.asarray(x, jdt) for x in (q, k, v, g)), rep(lse), rep(delta),
            dq, dk, dv, jnp.int32(qo), jnp.int32(ko), interpret=True)
        out.append((np.asarray(dq[:, :sq, :d]), np.asarray(dk[:, :skv, :d]),
                    np.asarray(dv[:, :skv, :d])))
    return out


def _torch_bwd(q, kvs, g, lse, delta, hops, d, tdt):
    skv = kvs[0][0].shape[2]
    accs = thop.bwd_carry_init(B, H, q.shape[2], skv, d, device="cpu")
    out = []
    for (qo, ko), (k, v) in zip(hops, kvs):
        thop.flash_attention_bwd_hop(
            *(torch.from_numpy(x).to(tdt) for x in (q, k, v, g)),
            torch.from_numpy(lse), torch.from_numpy(delta), *accs, qo, ko)
        out.append(tuple(t.clone().numpy() for t in accs))
    return out


def _bwd_abs_terms(q, kvs, g, lse, delta, hops):
    """Elementwise sums of |terms| of each accumulator after each hop:
    |ds| |k|, |ds|^T |q|, p^T |g|, from the bf16-rounded inputs."""
    qf, gf = torch.from_numpy(_bf16(q))[0], torch.from_numpy(_bf16(g))[0]
    totals, out = None, []
    for (qo, ko), (k, v) in zip(hops, kvs):
        kf, vf = torch.from_numpy(_bf16(k))[0], torch.from_numpy(_bf16(v))[0]
        ok = thop._hop_mask(qf.shape[1], kf.shape[1], qo, ko, "cpu")
        p = torch.where(ok, torch.exp(qf @ kf.transpose(1, 2)
                                      - torch.from_numpy(lse)[..., None]), 0.0)
        ds = (p * (gf @ vf.transpose(1, 2)
                   - torch.from_numpy(delta)[..., None])).abs()
        terms = (ds @ kf.abs(), ds.transpose(1, 2) @ qf.abs(),
                 p.transpose(1, 2) @ gf.abs())
        totals = terms if totals is None else tuple(
            a + t for a, t in zip(totals, terms))
        out.append(tuple(t.numpy() for t in totals))
    return out


@pytest.fixture(scope="module")
def bwd_hops():
    res = {}
    for name, (sq, skv, d, hops) in HOP_CASES.items():
        args = _bwd_setup(sq, skv, d, hops, seed=10 + len(res))
        for dname, (jdt, tdt) in DTYPES.items():
            res[name, dname] = (_jax_bwd(*args, hops, d, jdt),
                                _torch_bwd(*args, hops, d, tdt),
                                _bwd_abs_terms(*args, hops))
    return res


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(HOP_CASES))
def test_plain_bwd_hop_matches_the_jax_kernel(bwd_hops, case, dtype):
    want, got, abs_terms = bwd_hops[case, dtype]
    for w_hop, g_hop, a_hop in zip(want, got, abs_terms):
        for w, g, a in zip(w_hop, g_hop, a_hop):
            assert g.shape == w.shape
            if dtype == "float32":
                np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)
            else:
                bound = 2.0 ** -8 * a + 2e-5 * (1 + np.abs(w))
                assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()


def test_a_future_bwd_hop_leaves_the_accumulators_bit_for_bit(bwd_hops):
    for dtype in DTYPES:
        for res in bwd_hops["future", dtype][:2]:
            for before, after in zip(res[0], res[1]):
                assert np.array_equal(before, after)


# -- the whole ring -----------------------------------------------------------

RING_CASES = {  # name: (n, (B, H, S, D), seed)
    "n4": (4, (1, 2, 128, 32), 0),
    "n8": (8, (1, 2, 128, 32), 1),
    "dryrun": (4, (1, 2, 4 * 32, 64), 7),
}


def _ring_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_rings():
    """{case: (out, (dq, dk, dv) of sum(sin(ring)))} from JAX's
    make_ring_attention on a `cp` mesh (the einsum ring on the CPU)."""
    res = {}
    for name, (n, shape, seed) in RING_CASES.items():
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("cp",))
        ring = jring.make_ring_attention(mesh)
        q, k, v = map(jnp.asarray, _ring_inputs(shape, seed))
        loss = lambda q, k, v: jnp.sum(jnp.sin(ring(q, k, v)))
        with mesh:
            out = jax.jit(ring)(q, k, v)
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
        res[name] = (np.asarray(out), tuple(np.asarray(x) for x in grads))
    return res


def _torch_ring(ring, arrays, use_kernel, fn=None):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    if fn is None:
        out = tring.ring_attention_spmd(*leaves, ring=ring,
                                        use_kernel=use_kernel)
    else:
        out = fn(*leaves)
    grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
    return out.detach().numpy(), tuple(x.numpy() for x in grads)


@pytest.mark.parametrize("use_kernel", [None, True, False])
@pytest.mark.parametrize("case", list(RING_CASES))
def test_local_ring_matches_the_jax_ring(jax_rings, case, use_kernel):
    n, shape, seed = RING_CASES[case]
    want_out, want_grads = jax_rings[case]
    out, grads = _torch_ring(tring.LocalRing(n), _ring_inputs(shape, seed),
                             use_kernel)
    np.testing.assert_allclose(out, want_out, atol=1e-5, rtol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_make_ring_attention_over_a_local_ring(jax_rings):
    """The dryrun's ring phase: forward within 2e-5 of the causal oracle,
    finite gradients of sum(sin(ring)), equal to JAX's."""
    n, shape, seed = RING_CASES["dryrun"]
    arrays = _ring_inputs(shape, seed)
    fn = tring.make_ring_attention(tring.LocalRing(n))
    out, grads = _torch_ring(None, arrays, None, fn)
    oracle = tattn._sdpa_xla(*map(torch.from_numpy, arrays)).numpy()
    assert np.abs(out - oracle).max() < 2e-5
    assert all(np.isfinite(g).all() for g in grads)
    for g, w in zip(grads, jax_rings["dryrun"][1]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["n4", "n8"])
def test_einsum_oracle_matches_the_jax_ring(jax_rings, case):
    n, shape, seed = RING_CASES[case]
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in _ring_inputs(shape, seed)]
    out = tring._ring_einsum(*leaves, tring.LocalRing(n))
    grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
    want_out, want_grads = jax_rings[case]
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5,
                               rtol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def gloo_ring(tmp_path_factory):
    """The "n4" case over a 4-rank gloo group (one spawn for the module;
    the file:// store under a temporary directory, so that test workers
    never collide on a port): (out, grads) joined over the ranks."""
    n, shape, seed = RING_CASES["n4"]
    tmp = tmp_path_factory.mktemp("gloo_ring")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **dict(zip("qkv", _ring_inputs(shape, seed))))
    ctx = torch.multiprocessing.start_processes(
        torch_ring_ranks.run_rank,
        args=(n, str(tmp / "store"), str(inputs), str(tmp)), nprocs=n,
        join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish in 240 s")
    ranks = [np.load(tmp / f"rank{r}.npz") for r in range(n)]
    join = lambda key: np.concatenate([r[key] for r in ranks], axis=2)
    return join("out"), tuple(join(key) for key in ("dq", "dk", "dv"))


def test_process_group_ring_matches_the_jax_ring(gloo_ring, jax_rings):
    out, grads = gloo_ring
    want_out, want_grads = jax_rings["n4"]
    np.testing.assert_allclose(out, want_out, atol=1e-5, rtol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_process_group_ring_equals_the_local_ring_bitwise(gloo_ring):
    """The same hops on the same shards in the same order: the gloo ranks
    (one thread each) and LocalRing(4) give the same bits."""
    n, shape, seed = RING_CASES["n4"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, grads = _torch_ring(tring.LocalRing(n),
                                 _ring_inputs(shape, seed), None)
    finally:
        torch.set_num_threads(threads)
    assert np.array_equal(out, gloo_ring[0])
    for g, w in zip(grads, gloo_ring[1]):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_a_pass_calls_each_hop_n_squared_times(monkeypatch, n):
    """With the kernels (use_kernel=True) a LocalRing(n) forward calls the
    forward hop n^2 times and its backward the backward hop n^2 times."""
    calls = {"fwd": 0, "bwd": 0}

    def spy(fn, key):
        def counted(*args):
            calls[key] += 1
            return fn(*args)
        return counted

    fwd, bwd = thop.flash_attention_hop, thop.flash_attention_bwd_hop
    monkeypatch.setattr(thop, "flash_attention_hop", spy(fwd, "fwd"))
    monkeypatch.setattr(thop, "flash_attention_bwd_hop", spy(bwd, "bwd"))
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _ring_inputs((1, 2, 12 * n, 16), n))
    out = tring.ring_attention_spmd(q, k, v, ring=tring.LocalRing(n),
                                    use_kernel=True)
    assert calls == {"fwd": n * n, "bwd": 0}
    torch.autograd.grad(out.sum(), (q, k, v))
    assert calls == {"fwd": n * n, "bwd": n * n}
    # on the CPU the wrappers run the plain hops and count no launch
    assert fwd.launches == 0 and bwd.launches == 0


def test_fp16_runs_the_kernel_route_widened(monkeypatch):
    """K12 takes fp32 and bf16: on the kernel route an fp16 ring hands the
    hops fp32 shards, n^2 a pass, and returns the fp32 ring's results
    rounded to fp16."""
    n, seen = 4, []
    fwd = thop.flash_attention_hop

    def spy(q, *args):
        seen.append(q.dtype)
        return fwd(q, *args)

    monkeypatch.setattr(thop, "flash_attention_hop", spy)
    arrays = _ring_inputs((1, 2, 12 * n, 16), 3)
    leaves = [torch.from_numpy(x).half().requires_grad_(True) for x in arrays]
    out = tring.ring_attention_spmd(*leaves, ring=tring.LocalRing(n),
                                    use_kernel=True)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert seen == [torch.float32] * (n * n)
    wide = [torch.from_numpy(x).half().float().requires_grad_(True)
            for x in arrays]
    want = tring.ring_attention_spmd(*wide, ring=tring.LocalRing(n),
                                     use_kernel=True)
    want_grads = torch.autograd.grad(want.sum(), wide)
    for a, w in zip((out, *grads), (want, *want_grads)):
        assert a.dtype == torch.float16
        assert torch.equal(a, w.detach().half())


# -- an emulation of the CUDA tiling --------------------------------------------

TILE = 64


def _attends(sq, skv, q_off, kv_off, row0, col0):
    row = torch.arange(row0, row0 + TILE)[:, None]
    col = torch.arange(col0, col0 + TILE)[None, :]
    return (row < sq) & (col < skv) & (kv_off + col <= q_off + row)


def _tile(x, r0):
    """Rows [r0, r0 + 64) of (S, D), zero past the end."""
    out = torch.zeros((TILE, x.shape[1]))
    part = x[r0:r0 + TILE]
    out[:part.shape[0]] = part
    return out


def _last_col(row0, sq, skv, q_off, kv_off):
    return min(q_off + min(row0 + TILE - 1, sq - 1) - kv_off, skv - 1)


def _emulate_fwd(q, k, v, m, l, acc, q_off, kv_off, visited):
    """hop_fwd_kernel for one (b, h): q tiles, then the kv tiles up to the
    last live one, the online-softmax update a tile at a time."""
    sq, skv = q.shape[0], k.shape[0]
    for row0 in range(0, sq, TILE):
        last = _last_col(row0, sq, skv, q_off, kv_off)
        if last < 0:
            continue  # the block returns before it reads the carry
        rows = slice(row0, min(row0 + TILE, sq))
        n = rows.stop - rows.start
        m_r, l_r = m[rows].clone(), l[rows].clone()
        a_r = acc[rows].clone()
        for col0 in range(0, last // TILE * TILE + 1, TILE):
            visited.add((row0, col0))
            ok = _attends(sq, skv, q_off, kv_off, row0, col0)[:n]
            s = torch.where(ok, _tile(q, row0)[:n] @ _tile(k, col0).T, -1e30)
            m_new = torch.maximum(m_r, s.amax(-1))
            alpha = torch.exp(m_r - m_new)
            p = torch.where(ok, torch.exp(s - m_new[:, None]), 0.0)
            l_r = l_r * alpha + p.sum(-1)
            a_r = a_r * alpha[:, None] + p @ _tile(v, col0)
            m_r = m_new
        m[rows], l[rows], acc[rows] = m_r, l_r, a_r


def _emulate_bwd(q, k, v, g, lse, delta, dq, dk, dv, q_off, kv_off):
    """hop_bwd_dq_kernel (per q tile) and hop_bwd_dkv_kernel (per kv tile,
    from the first q tile that reads it) for one (b, h)."""
    sq, skv = q.shape[0], k.shape[0]

    def p_ds(row0, col0):
        ok = _attends(sq, skv, q_off, kv_off, row0, col0)
        lse_t = torch.zeros(TILE)
        delta_t = torch.zeros(TILE)
        n = min(TILE, sq - row0)
        lse_t[:n], delta_t[:n] = lse[row0:row0 + n], delta[row0:row0 + n]
        s = _tile(q, row0) @ _tile(k, col0).T
        p = torch.where(ok, torch.exp(s - lse_t[:, None]), 0.0)
        return p, p * (_tile(g, row0) @ _tile(v, col0).T - delta_t[:, None])

    for row0 in range(0, sq, TILE):
        last = _last_col(row0, sq, skv, q_off, kv_off)
        if last < 0:
            continue
        part = torch.zeros((TILE, q.shape[1]))
        for col0 in range(0, last // TILE * TILE + 1, TILE):
            part += p_ds(row0, col0)[1] @ _tile(k, col0)
        n = min(TILE, sq - row0)
        dq[row0:row0 + n] += part[:n]
    for col0 in range(0, skv, TILE):
        row_first = max(kv_off + col0 - q_off, 0)
        if row_first >= sq:
            continue
        pk, pv = torch.zeros((TILE, q.shape[1])), torch.zeros((TILE, q.shape[1]))
        for row0 in range(row_first // TILE * TILE, sq, TILE):
            p, ds = p_ds(row0, col0)
            pv += p.T @ _tile(g, row0)
            pk += ds.T @ _tile(q, row0)
        n = min(TILE, skv - col0)
        dk[col0:col0 + n] += pk[:n]
        dv[col0:col0 + n] += pv[:n]


# (sq, skv, q_off, kv_off): diagonal, past, future, ragged and unaligned
EMULATION_CASES = [(128, 128, 128, 128), (130, 100, 260, 0),
                   (100, 100, 0, 100), (130, 100, 37, 50), (70, 150, 90, 20)]


@pytest.mark.parametrize("case", EMULATION_CASES, ids=str)
def test_kernel_tiling_emulation_matches_plain(case):
    sq, skv, q_off, kv_off = case
    rng = np.random.default_rng(sum(case))
    d = 16
    q, g = (torch.from_numpy(_uniform(rng, sq, d)) for _ in range(2))
    k, v = (torch.from_numpy(_uniform(rng, skv, d)) for _ in range(2))
    # a carry from an earlier (past) hop, so that no row starts empty
    m0 = torch.from_numpy(_uniform(rng, sq))
    l0 = torch.from_numpy(_uniform(rng, sq)) + 2
    a0 = torch.from_numpy(_uniform(rng, sq, d))
    want = [t.clone()[None] for t in (m0, l0, a0)]
    thop.flash_attention_hop_plain(q[None, None], k[None, None],
                                   v[None, None], *want, q_off, kv_off)
    got = [t.clone() for t in (m0, l0, a0)]
    visited = set()
    _emulate_fwd(q, k, v, *got, q_off, kv_off, visited)
    for w, t in zip(want, got):
        torch.testing.assert_close(t, w[0], atol=1e-5, rtol=1e-5)
    # every tile visited holds a live pair, and every live pair is visited
    live = {(r0, c0) for r0 in range(0, sq, TILE) for c0 in range(0, skv, TILE)
            if _attends(sq, skv, q_off, kv_off, r0, c0).any()}
    assert visited == live
    # rows that see no column keep their carry bit for bit
    dead = torch.arange(sq) + q_off < kv_off
    for t, t0 in zip(got, (m0, l0, a0)):
        assert torch.equal(t[dead], t0[dead])

    lse = torch.from_numpy(_uniform(rng, sq)) + 1
    delta = torch.from_numpy(_uniform(rng, sq))
    start = [torch.from_numpy(_uniform(rng, *s)) for s in
             ((sq, d), (skv, d), (skv, d))]
    want = [t.clone()[None] for t in start]
    thop.flash_attention_bwd_hop_plain(
        q[None, None], k[None, None], v[None, None], g[None, None],
        lse[None], delta[None], *want, q_off, kv_off)
    got = [t.clone() for t in start]
    _emulate_bwd(q, k, v, g, lse, delta, *got, q_off, kv_off)
    for w, t in zip(want, got):
        torch.testing.assert_close(t, w[0], atol=1e-5, rtol=1e-5)


# -- an emulation of the bf16 body (csrc/attention_wgmma.cuh, kHop) -----------
#
# The forward and dq blocks own 128 q rows (two consumers of 64) and stream
# the 64-row k / v tiles of the block's live range; a forward consumer skips
# a tile that holds no pair of its own rows (dead), and every body tests
# each pair only on a tile that crosses the shifted diagonal or a length's
# end (edge).  The forward loads the carry into its accumulators, keeps m in
# the exp2 domain (m log2 e), counts the carry's l once over the quad's
# four partial sums (lane t holds columns 8j + 2t and 8j + 2t + 1 of a
# tile), rounds P to bf16 before P.V and writes the carry's own m back where
# the max did not move.  The dk/dv block owns 64 kv rows and walks the
# 64-row q tiles from the first that reads it; P, P^T and dS^T are rounded
# to bf16 before the second products; every block adds its sums to the
# fp32 accumulators once, and a block with no attended pair touches
# nothing.

WG_BLOCK, WG_ROWS, WG_TILE = 128, 64, 64  # block, consumer and tile rows
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _wg_kv_tiles(row0, sq, skv, shift):
    """The 64-row kv tiles a forward or dq block at q row row0 streams
    (none: the block returns before it initializes a barrier)."""
    col_hi = min(min(row0 + WG_BLOCK - 1, sq - 1) + shift, skv - 1)
    return range(col_hi // WG_TILE + 1) if col_hi >= 0 else range(0)


def _wg_q_tiles(col0, sq, shift):
    """The 64-row q tiles the dk/dv block at kv row col0 walks, from the
    first that reads it."""
    row_first = max(col0 - shift, 0)
    if row_first >= sq:
        return range(0)
    return range(row_first // WG_TILE, (sq - 1) // WG_TILE + 1)


def _wg_dead(q_lo, c0, sq, shift):
    """A forward consumer at q row q_lo skips the kv tile at column c0."""
    return q_lo >= sq or c0 > q_lo + WG_ROWS - 1 + shift


def _wg_edge(r0, c0, sq, skv, shift):
    """The 64 x 64 tile of q rows from r0 and kv columns from c0 tests each
    pair."""
    return not (c0 + WG_TILE - 1 <= r0 + shift and c0 + WG_TILE - 1 < skv
                and r0 + WG_ROWS - 1 < sq)


def _wg_attends(rows, cols, sq, skv, shift):
    return ((cols[None, :] <= rows[:, None] + shift) & (cols[None, :] < skv)
            & (rows[:, None] < sq))


def _padded(x):
    """x with zero rows up to a multiple of 128 (the TMA's fill past an
    end, and the wrapper's zero-padded lse and delta)."""
    n = -(-x.shape[0] // WG_BLOCK) * WG_BLOCK
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def _wg_emulate_fwd(q, k, v, m, l, acc, q_off, kv_off):
    """The bf16 forward for one (b, h), on fp32 copies of bf16 inputs: the
    carry (m, l, acc) updated in place."""
    sq, skv = q.shape[0], k.shape[0]
    shift = q_off - kv_off
    kp, vp = _padded(k), _padded(v)
    lane = (torch.arange(WG_TILE) % 8) // 2
    for row0 in range(0, sq, WG_BLOCK):
        tiles = _wg_kv_tiles(row0, sq, skv, shift)
        if not tiles:
            continue  # the block returns before it reads the carry
        for q_lo in range(row0, min(row0 + WG_BLOCK, sq), WG_ROWS):
            rows = torch.arange(q_lo, min(q_lo + WG_ROWS, sq))
            m_in = m[rows].clone()
            m2 = m_in * LOG2E
            part = torch.zeros((len(rows), 4))
            part[:, 0] = l[rows]
            o = acc[rows].clone()
            for kt in tiles:
                c0 = kt * WG_TILE
                if _wg_dead(q_lo, c0, sq, shift):
                    continue
                cols = torch.arange(c0, c0 + WG_TILE)
                s = q[rows] @ kp[cols].T
                if _wg_edge(q_lo, c0, sq, skv, shift):
                    s = torch.where(_wg_attends(rows, cols, sq, skv, shift),
                                    s, -torch.inf)
                m_new = torch.maximum(m2, s.amax(1) * LOG2E)
                alpha = torch.exp2(m2 - m_new)
                p = torch.exp2(s * LOG2E - m_new[:, None])
                part = part * alpha[:, None] + torch.zeros_like(
                    part).index_add_(1, lane, p)
                o = o * alpha[:, None] + _bf16_t(p) @ vp[cols]
                m2 = m_new
            m[rows] = torch.where(m2 == m_in * LOG2E, m_in, m2 * LN2)
            l[rows] = (part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])
            acc[rows] = o


def _wg_emulate_bwd(q, k, v, g, lse, delta, dq, dk, dv, q_off, kv_off):
    """The bf16 dq and dk/dv kernels for one (b, h): the fp32 accumulators
    updated in place."""
    sq, skv = q.shape[0], k.shape[0]
    shift = q_off - kv_off
    qp, kp, vp, gp = (_padded(t) for t in (q, k, v, g))
    lse_p, delta_p = _padded(lse), _padded(delta)

    def p_ds(r0, rows, cols):
        s = qp[rows] @ kp[cols].T
        p = torch.exp2(s * LOG2E - lse_p[rows, None] * LOG2E)
        if _wg_edge(r0, cols[0].item(), sq, skv, shift):
            p = torch.where(_wg_attends(rows, cols, sq, skv, shift), p, 0.0)
        return p, p * (gp[rows] @ vp[cols].T - delta_p[rows, None])

    for row0 in range(0, sq, WG_BLOCK):
        tiles = _wg_kv_tiles(row0, sq, skv, shift)
        if not tiles:
            continue
        for q_lo in range(row0, row0 + WG_BLOCK, WG_ROWS):
            rows = torch.arange(q_lo, q_lo + WG_ROWS)
            part = torch.zeros((WG_ROWS, q.shape[1]))
            for kt in tiles:
                cols = torch.arange(kt * WG_TILE, (kt + 1) * WG_TILE)
                part += _bf16_t(p_ds(q_lo, rows, cols)[1]) @ kp[cols]
            n = max(min(WG_ROWS, sq - q_lo), 0)
            dq[q_lo:q_lo + n] += part[:n]
    for col0 in range(0, skv, WG_TILE):
        cols = torch.arange(col0, col0 + WG_TILE)
        pk, pv = (torch.zeros((WG_TILE, q.shape[1])) for _ in range(2))
        tiles = _wg_q_tiles(col0, sq, shift)
        for qt in tiles:
            rows = torch.arange(qt * WG_TILE, (qt + 1) * WG_TILE)
            p, ds = p_ds(qt * WG_TILE, rows, cols)
            pv += _bf16_t(p.T) @ gp[rows]
            pk += _bf16_t(ds.T) @ qp[rows]
        if tiles:
            n = min(WG_TILE, skv - col0)
            dk[col0:col0 + n] += pk[:n]
            dv[col0:col0 + n] += pv[:n]


def _bf16_t(x):
    return x.bfloat16().float()


def _pairs(sq, skv, shift):
    row = torch.arange(-(-sq // WG_BLOCK) * WG_BLOCK)
    col = torch.arange(-(-skv // WG_TILE) * WG_TILE)
    return _wg_attends(row, col, sq, skv, shift)


@pytest.mark.parametrize("sq,skv,q_off,kv_off", [
    (128, 128, 128, 128), (130, 100, 37, 50), (200, 200, 400, 200),
    (200, 200, 400, 400), (96, 96, 96, 96), (128, 128, 0, 64),
    (256, 256, 0, 256), (70, 150, 90, 20), (300, 130, 5, 260)])
def test_wgmma_hop_tiles_are_exactly_the_live_ones(sq, skv, q_off, kv_off):
    """The bf16 body's blocks visit a tile if and only if it holds an
    attended pair of the block's rows; a forward consumer skips a tile if
    and only if it holds no pair of its own rows; a tile tests each pair if
    and only if not all its pairs are attended; the dk/dv block walks
    exactly the q tiles that read its kv tile."""
    shift = q_off - kv_off
    ok = _pairs(sq, skv, shift)
    for row0 in range(0, sq, WG_BLOCK):
        tiles = list(_wg_kv_tiles(row0, sq, skv, shift))
        live = {kt for kt in range(ok.shape[1] // WG_TILE)
                if ok[row0:row0 + WG_BLOCK,
                      kt * WG_TILE:(kt + 1) * WG_TILE].any()}
        assert set(tiles) == live
        for q_lo in (row0, row0 + WG_ROWS):
            for kt in tiles:
                tile = ok[q_lo:q_lo + WG_ROWS, kt * WG_TILE:(kt + 1) * WG_TILE]
                assert _wg_dead(q_lo, kt * WG_TILE, sq, shift) == (
                    not tile.any())
                assert _wg_edge(q_lo, kt * WG_TILE, sq, skv, shift) == (
                    not tile.all())
    for col0 in range(0, skv, WG_TILE):
        live = {qt for qt in range(ok.shape[0] // WG_TILE)
                if ok[qt * WG_TILE:(qt + 1) * WG_TILE,
                      col0:col0 + WG_TILE].any()}
        assert set(_wg_q_tiles(col0, sq, shift)) == live


def test_wgmma_hop_tests_no_pair_on_a_past_hop_at_the_ring_shape():
    """At the ring's shard (s_local = 8192), a past hop (q_off 8192, kv_off
    0) has no edge tile in any body; a diagonal hop has them only on the
    diagonal, as K1's and K2's do."""
    s = 8192
    for shift, edges in ((s, 0), (0, s // WG_TILE)):
        seen = 0
        for row0 in range(0, s, WG_BLOCK):
            for q_lo in (row0, row0 + WG_ROWS):
                for kt in _wg_kv_tiles(row0, s, s, shift):
                    c0 = kt * WG_TILE
                    if not _wg_dead(q_lo, c0, s, shift):
                        seen += _wg_edge(q_lo, c0, s, s, shift)
        assert seen == edges
        assert sum(_wg_edge(qt * WG_TILE, col0, s, s, shift)
                   for col0 in range(0, s, WG_TILE)
                   for qt in _wg_q_tiles(col0, s, shift)) == edges


# name: (sq, skv, d, hops); each hop (q_off, kv_off) in turn on one carry,
# the last the case's kind: a diagonal at hd 128 over a q shard of 1.5
# blocks, a past hop over ragged shards at hd 64, unaligned offsets with q
# rows 0..12 left without a column inside a live tile, a fresh carry whose
# first consumer sees no column, and a wholly-future hop
WG_CASES = {
    "diagonal_hd128": (192, 192, 128, [(192, 0), (192, 192)]),
    "past_ragged_hd64": (200, 200, 64, [(200, 200), (200, 0)]),
    "unaligned_hd128": (130, 100, 128, [(37, 0), (37, 50)]),
    "fresh_padding_hd64": (128, 128, 64, [(0, 64)]),
    "future_hd64": (128, 128, 64, [(0, 0), (0, 128)]),
}


def _idle_rows(sq, q_off, kv_off):
    return np.arange(sq) + q_off < kv_off


@pytest.fixture(scope="module")
def wg_hops():
    """{case: (JAX, plain, emulated) carries after each hop, the kv shards,
    and (JAX, plain, emulated) accumulators after each backward hop with
    their sums of absolute terms}, all from the same bf16 inputs."""
    res = {}
    for name, (sq, skv, d, hops) in WG_CASES.items():
        seed = 40 + len(res)
        q, kvs, _ = _hop_inputs(sq, skv, d, seed)
        jfwd = _jax_fwd(q, kvs, hops, d, jnp.bfloat16)
        pfwd = _torch_fwd(q, kvs, hops, d, torch.bfloat16)
        carry = thop.hop_carry_init(B, H, sq, d, device="cpu")
        efwd = []
        qf = torch.from_numpy(_bf16(q)).reshape(B * H, sq, d)
        for (qo, ko), (k, v) in zip(hops, kvs):
            kf, vf = (torch.from_numpy(_bf16(x)).reshape(B * H, skv, d)
                      for x in (k, v))
            for bh in range(B * H):
                _wg_emulate_fwd(qf[bh], kf[bh], vf[bh],
                                *(t[bh] for t in carry), qo, ko)
            efwd.append(tuple(t.clone().numpy() for t in carry))
        args = _bwd_setup(sq, skv, d, hops, seed)
        jbwd = _jax_bwd(*args, hops, d, jnp.bfloat16)
        pbwd = _torch_bwd(*args, hops, d, torch.bfloat16)
        q, kvs, g, lse, delta = args
        accs = thop.bwd_carry_init(B, H, sq, skv, d, device="cpu")
        ebwd = []
        qf, gf = (torch.from_numpy(_bf16(x)).reshape(B * H, sq, d)
                  for x in (q, g))
        for (qo, ko), (k, v) in zip(hops, kvs):
            kf, vf = (torch.from_numpy(_bf16(x)).reshape(B * H, skv, d)
                      for x in (k, v))
            for bh in range(B * H):
                _wg_emulate_bwd(qf[bh], kf[bh], vf[bh], gf[bh],
                                torch.from_numpy(lse[bh]),
                                torch.from_numpy(delta[bh]),
                                *(t[bh] for t in accs), qo, ko)
            ebwd.append(tuple(t.clone().numpy() for t in accs))
        res[name] = ((jfwd, pfwd, efwd), kvs,
                     (jbwd, pbwd, ebwd, _bwd_abs_terms(*args, hops)))
    return res


@pytest.mark.parametrize("case", list(WG_CASES))
def test_wgmma_hop_emulation_matches_plain_and_jax(wg_hops, case):
    """The emulated bf16 body against the plain hops (fp32 p and ds) and
    against the JAX hop kernels in interpret mode on the same bf16 inputs,
    after every hop, at the bounds stated at the top of this file; q rows
    that see no column of a hop keep their carry and dq bit for bit, and kv
    rows that no q row reads keep dk and dv."""
    sq, skv, _, hops = WG_CASES[case]
    (jfwd, pfwd, efwd), kvs, (jbwd, pbwd, ebwd, terms) = wg_hops[case]
    vmax = max(np.abs(_bf16(v)).max() for _, v in kvs)
    for want_side in (jfwd, pfwd):
        for (wm, wl, wacc), (gm, gl, gacc) in zip(want_side, efwd):
            np.testing.assert_allclose(gm, wm, atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(gl, wl, atol=2e-5, rtol=2e-5)
            bound = 2.0 ** -8 * gl[..., None] * vmax + 2e-5
            assert (np.abs(gacc - wacc) <= bound).all(), np.abs(
                gacc - wacc).max()
    for want_side in (jbwd, pbwd):
        for w_hop, g_hop, a_hop in zip(want_side, ebwd, terms):
            for w, g, a in zip(w_hop, g_hop, a_hop):
                bound = 2.0 ** -8 * a + 2e-5 * (1 + np.abs(w))
                assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()
    d = WG_CASES[case][2]
    before = [tuple(t.numpy() for t in thop.hop_carry_init(
        B, H, sq, d, device="cpu"))] + efwd[:-1]
    zeros = tuple(t.numpy() for t in thop.bwd_carry_init(
        B, H, sq, skv, d, device="cpu"))
    before_b = [zeros] + ebwd[:-1]
    for (qo, ko), b_f, a_f, b_b, a_b in zip(hops, before, efwd, before_b,
                                            ebwd):
        idle = _idle_rows(sq, qo, ko)
        for x, y in zip(b_f, a_f):
            assert np.array_equal(x[:, idle], y[:, idle])
        assert np.array_equal(b_b[0][:, idle], a_b[0][:, idle])
        unread = np.arange(skv) + ko > qo + sq - 1
        for x, y in zip(b_b[1:], a_b[1:]):
            assert np.array_equal(x[:, unread], y[:, unread])


# -- helpers and checks ---------------------------------------------------------


def test_hop_lse_and_finalize_on_a_padding_row():
    """A row that saw no column (m = NEG_INF, l = 0) gets lse = 0 and
    out = 0, and the JAX helpers agree on the rest."""
    m = torch.tensor([[thop.NEG_INF, 0.5, -2.0]])
    l = torch.tensor([[0.0, 3.0, 0.25]])
    acc = torch.tensor([[[0.0, 0.0], [3.0, 6.0], [1.0, -1.0]]])
    lse = thop.hop_lse(m, l)
    assert lse[0, 0] == 0.0
    jm = jnp.asarray(np.repeat(m.numpy()[..., None], 128, -1))
    jl = jnp.asarray(np.repeat(l.numpy()[..., None], 128, -1))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jhop.hop_lse(jm, jl))[..., 0],
                               rtol=1e-6)
    out = thop.hop_finalize(l, acc, 1, 1, 3, 2, torch.float32)
    assert out.shape == (1, 1, 3, 2) and not out[0, 0, 0].any()
    np.testing.assert_allclose(out.numpy()[0, 0, 1:], [[1.0, 2.0], [4.0, -4.0]])
    rows = torch.arange(6.0).reshape(1, 2, 3)
    assert thop.flat_rows(rows).shape == (2, 3)


def test_wrappers_check_their_arguments():
    q = torch.zeros((1, 2, 8, 16))
    m, l, acc = thop.hop_carry_init(1, 2, 8, 16, device="cpu")
    with pytest.raises(ValueError, match="same batch, heads"):
        thop.flash_attention_hop(q, q[:, :1], q[:, :1], m, l, acc, 0, 0)
    with pytest.raises(TypeError, match="one dtype"):
        thop.flash_attention_hop(q, q.double(), q, m, l, acc, 0, 0)
    with pytest.raises(ValueError, match="float32"):
        thop.flash_attention_hop(q, q, q, m[:, :4], l, acc, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros((2, 8, 32))[..., :16]
        thop.flash_attention_hop(q, q, q, m, l, strided, 0, 0)
    dq, dk, dv = thop.bwd_carry_init(1, 2, 8, 8, 16, device="cpu")
    with pytest.raises(ValueError, match="g must have"):
        thop.flash_attention_bwd_hop(q, q, q, q[..., :8], m, l, dq, dk, dv, 0, 0)
    with pytest.raises(ValueError, match="equal shards"):
        tring.ring_attention_spmd(q, q, q, ring=tring.LocalRing(3))
    with pytest.raises(ValueError, match="one shape"):
        tring.ring_attention_spmd(q, q[:, :1], q, ring=tring.LocalRing(2))
    with pytest.raises(ValueError, match="at least one rank"):
        tring.LocalRing(0)
