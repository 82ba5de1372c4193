"""Port parity: parallel/mesh.py and parallel/collectives.py.

factor_mesh, param_specs and the forward over a mesh against the JAX
package; shard -> gather bit for bit; the sequence-parallel constraint's
round trip; and every collective, raw and differentiable, the same over
LocalMesh(2, 2) and over a 4-process gloo DeviceMesh
(tests/torch_mesh_ranks.py, one spawn for the module).
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import serve as jserve
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.parallel import mesh as jmesh
from kfunca_tpu_torch.models import serve as tserve
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax
from kfunca_tpu_torch.parallel import collectives as cc
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.utils.tree import tree_leaves

import torch_mesh_ranks

LAYOUTS = {
    "llama": dict(n_heads=4, n_kv_heads=2),
    "gpt2": dict(n_heads=4, norm="layernorm", pos="learned",
                 mlp_type="gelu", proj_bias=True),
    "qwen3": dict(n_heads=4, n_kv_heads=2, qk_norm=True),
    "biased_mqa": dict(n_heads=4, n_kv_heads=1, proj_bias=True),
}


def _cfg_kw(layout, **extra):
    return {**dict(vocab_size=128, d_model=64, n_layers=2, d_ff=96,
                   max_seq_len=32, dtype="float32"), **LAYOUTS[layout],
            **extra}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _as_tuples(specs):
    """A JAX spec tree with each PartitionSpec as its plain tuple."""
    return jax.tree_util.tree_map(
        tuple, specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _plain(specs):
    if isinstance(specs, dict):
        return {k: _plain(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_plain(v) for v in specs]
    if isinstance(specs, tmesh.P):
        return tuple(specs)
    return tuple(_plain(v) for v in specs)


def test_factor_mesh_matches_jax():
    for n in range(1, 65):
        assert tmesh.factor_mesh(n) == jmesh.factor_mesh(n), n


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_param_specs_match_jax(layout, fsdp):
    kw = _cfg_kw(layout)
    jp = jtf.init_params(jax.random.PRNGKey(0), jtf.TransformerConfig(**kw))
    want = _as_tuples(jmesh.param_specs(jp, fsdp=fsdp))
    assert _plain(tmesh.param_specs(jp, fsdp=fsdp)) == want


@pytest.mark.parametrize("quant", [None, 8, 4])
def test_decode_param_specs_match_jax(quant):
    kw = _cfg_kw("gpt2", d_model=128, d_ff=256)
    jc = jtf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jp, ttf.TransformerConfig(**kw), device="cpu")
    if quant:
        jp = jserve.quantize_decode_params(jp, bits=quant)
        tp = tserve.quantize_decode_params(tp, bits=quant)
    want = _as_tuples(jserve.decode_param_specs(jp))
    assert _plain(tserve.decode_param_specs(tp)) == want


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)])
def test_shard_then_gather_is_bit_exact(layout, mesh):
    tc = ttf.TransformerConfig(**_cfg_kw(layout))
    params = ttf.init_params(0, tc, device="cpu")
    m = tmesh.LocalMesh(*mesh, "cpu")
    for fsdp in (False, True):
        sp = tmesh.shard_params(params, m, fsdp, cfg=tc)
        back = tmesh.gather_params(sp)
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_rank_holds_whole_heads_of_the_fused_qkv():
    """tp 2 over 4 q heads and 2 kv heads of 16: rank t holds q heads
    2t, 2t+1, then kv head t of k, then of v, and no other column."""
    tc = ttf.TransformerConfig(**_cfg_kw("llama"))
    params = ttf.init_params(0, tc, device="cpu")
    sp = tmesh.shard_params(params, tmesh.LocalMesh(1, 2, "cpu"), cfg=tc)
    w = params["blocks"][0]["wqkv"]
    hd = 16
    for t in range(2):
        want = torch.cat([w[:, 2 * t * hd:(2 * t + 2) * hd],
                          w[:, (4 + t) * hd:(5 + t) * hd],
                          w[:, (6 + t) * hd:(7 + t) * hd]], dim=1)
        assert torch.equal(sp.local[t]["blocks"][0]["wqkv"], want)
    mqa = ttf.TransformerConfig(**_cfg_kw("biased_mqa"))
    sp = tmesh.shard_params(ttf.init_params(0, mqa, device="cpu"),
                            tmesh.LocalMesh(1, 2, "cpu"), cfg=mqa)
    assert not sp.attn_split  # one kv head: attention replicated over tp
    assert sp.local[1]["blocks"][0]["bqkv"].shape == (96,)
    assert sp.local[1]["blocks"][0]["w_gate"].shape == (64, 48)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_forward_over_a_mesh_matches_jax(layout):
    """forward(shard_params(...)) over (2, 2) and (1, 4) against the JAX
    forward on shard_params over its mesh: logits within 1e-5."""
    kw = _cfg_kw(layout)
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(1), jc)
    tokens = np.random.default_rng(0).integers(0, 128, (4, 16)).astype(
        np.int32)
    jm = jmesh.make_mesh(4, dp=2, tp=2)
    with jm:
        want = np.asarray(jtf.forward(jmesh.shard_params(jp, jm),
                                      jnp.asarray(tokens), jc))
    params = params_from_jax(jp, tc, device="cpu")
    for shape in ((2, 2), (1, 4)):
        sp = tmesh.shard_params(params, tmesh.LocalMesh(*shape, "cpu"),
                                cfg=tc)
        got = ttf.forward(sp, torch.from_numpy(tokens), tc).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_constrain_seq_parallel_round_trips():
    mesh = tmesh.LocalMesh(2, 2, "cpu")
    x = torch.randn(2, 8, 6, requires_grad=True)
    xs = [x * (r + 1) for r in range(2)]  # one per dp rank ...
    xs = [xs[mesh.coord(r)[0]] for r in mesh.ranks]  # ... replicated over tp
    parts = tmesh.constrain_seq_parallel(xs, mesh)
    assert [p.shape for p in parts] == [(2, 4, 6)] * 4
    assert torch.equal(parts[1], xs[1][:, 4:])
    back = tmesh.gather_seq_parallel(parts, mesh)
    for b, w in zip(back, xs):
        assert torch.equal(b, w)
    # partial sums reduce-scatter along S
    parts = tmesh.constrain_seq_parallel(xs, mesh, partial=True)
    assert torch.equal(parts[0], 2 * xs[0][:, :4])
    (g,) = torch.autograd.grad(sum(p.sum() for p in back), [x])
    # each rank passes its whole copy's gradient back: 1 + 1 + 2 + 2
    assert torch.equal(g, torch.full_like(x, 6.0))
    assert tmesh.activation_spec() == ("dp", "tp", None)
    assert tmesh.batch_spec() == ("dp", None)


def test_make_mesh_without_a_process_group_is_a_local_mesh():
    m = tmesh.make_mesh(8, device="cpu")
    assert isinstance(m, tmesh.LocalMesh)
    assert (m.dp, m.tp) == jmesh.factor_mesh(8)
    m = tmesh.make_mesh(dp=1, tp=4, device="cpu")
    assert m.shape == {"dp": 1, "tp": 4} and len(m.ranks) == 4
    with pytest.raises(ValueError):
        tmesh.make_mesh(6, dp=4, tp=2, device="cpu")
    with pytest.raises(ValueError, match="split into 3"):
        tc = ttf.TransformerConfig(**_cfg_kw("llama"))
        tmesh.shard_params(ttf.init_params(0, tc, device="cpu"),
                           tmesh.LocalMesh(1, 3, "cpu"), cfg=tc)


def _local_collectives():
    """collectives_task's arrays for every rank, over LocalMesh(2, 2)."""
    mesh = tmesh.LocalMesh(2, 2, "cpu")
    xs = [torch_mesh_ranks.rank_input(r) for r in mesh.ranks]
    out = [dict() for _ in mesh.ranks]
    for axis in tmesh.AXES:
        for kind, dim in torch_mesh_ranks.COLLECTIVE_DIMS.items():
            for r, y in enumerate(mesh.collective(kind, xs, axis, dim)):
                out[r][f"{kind}_{axis}"] = y.numpy()
        for name in ("copy", "reduce", "gather", "scatter", "all_gather",
                     "reduce_scatter"):
            xr = [x.clone().requires_grad_(True) for x in xs]
            ys = getattr(cc, name)(xr, mesh, axis, *(() if name in (
                "copy", "reduce") else (1,)))
            ws = [torch_mesh_ranks.rank_input(r, y.shape, seed=29)
                  for r, y in enumerate(ys)]
            gs = torch.autograd.grad(sum((y * w).sum()
                                         for y, w in zip(ys, ws)), xr)
            for r in mesh.ranks:
                out[r][f"d_{name}_{axis}"] = ys[r].detach().numpy()
                out[r][f"d_{name}_{axis}_grad"] = gs[r].numpy()
    return out


@pytest.fixture(scope="module")
def gloo_collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_mesh")
    ctx = torch.multiprocessing.start_processes(
        torch_mesh_ranks.run_rank,
        args=(4, str(tmp / "store"), "collectives", None, str(tmp)),
        nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish in 240 s")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


def test_each_collective_is_the_same_over_gloo_and_the_local_mesh(
        gloo_collectives):
    """Forward and backward of every collective over both axes: exactly
    equal (sums of two terms, in one order either way)."""
    local = _local_collectives()
    for r in range(4):
        assert sorted(gloo_collectives[r]) == sorted(local[r])
        for key, want in local[r].items():
            np.testing.assert_array_equal(gloo_collectives[r][key], want,
                                          err_msg=f"rank {r} {key}")


def test_local_collectives_follow_megatron():
    """copy sums the ranks' gradients, reduce passes its own through,
    gather takes its chunk back, all_gather reduce-scatters."""
    local = _local_collectives()
    xs = [torch_mesh_ranks.rank_input(r).numpy() for r in range(4)]
    ws = lambda shape: [torch_mesh_ranks.rank_input(r, shape, seed=29)
                        .numpy() for r in range(4)]
    w = ws((4, 6))
    np.testing.assert_allclose(local[0]["d_reduce_tp"], xs[0] + xs[1])
    np.testing.assert_array_equal(local[0]["d_reduce_tp_grad"], w[0])
    np.testing.assert_allclose(local[0]["d_copy_dp_grad"], w[0] + w[2])
    wg = ws((4, 12))
    np.testing.assert_array_equal(local[3]["d_gather_tp_grad"],
                                  wg[3][:, 6:])
    np.testing.assert_allclose(local[3]["d_all_gather_tp_grad"],
                               (wg[2] + wg[3])[:, 6:])
