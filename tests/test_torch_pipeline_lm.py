"""Port parity: models/pipeline_lm.py.

param_specs against the JAX package's; block_fn, the unpipelined loss and
one SGD step of make_train_step over LocalMesh meshes of (dp, pp, tp)
against JAX's make_train_step over the same mesh shape on its virtual CPU
devices, on the same numpy weights and batch, fp32: the loss within 1e-5,
every updated param within 1e-4 of its leaf's largest entry; every
rank's loss gradient within 1e-4 of its leaf's largest entry (the
router's is zero in exact arithmetic under top-1, whose one kept gate
renormalizes to 1: it holds rounding noise only, below 2^-16 of the
largest gradient entry on both sides); shard -> gather bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from kfunca_tpu.models import pipeline_lm as jpl
from kfunca_tpu_torch.models import pipeline_lm as tpl
from kfunca_tpu_torch.models.weights import pipeline_lm_params_from_jax
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.utils.tree import tree_leaves

KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, n_experts=4,
          d_ff=48, n_stages=2, n_microbatches=2, dtype="float32")
AXES = ("dp", "pp", "tp")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed, rows=4, s=8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (rows, s)).astype(np.int32),
            rng.integers(0, 64, (rows, s)).astype(np.int32))


@pytest.fixture(scope="module")
def reference():
    """JAX's params, and its step's loss and updated params and its loss
    gradients over (1, 2, 2), (2, 2, 1) and (2, 2, 2) meshes (lr 0.1,
    4 x 8 tokens)."""
    jc = jpl.PipelineMoEConfig(**KW)
    jp = jpl.init_params(jax.random.PRNGKey(1), jc)
    tok, tgt = _batch(0)
    out = {"params": jp}
    for shape in ((1, 2, 2), (2, 2, 1), (2, 2, 2)):
        n = int(np.prod(shape))
        jm = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), AXES)
        with jm:
            new, loss = jpl.make_train_step(jc, jm, lr=0.1)(
                jp, jnp.asarray(tok), jnp.asarray(tgt))
        out[shape] = (float(loss), [np.asarray(x) for x in
                                    jax.tree_util.tree_leaves(new)])
        with jm:
            grads = jax.jit(jax.grad(jpl.make_loss_fn(jc, jm)))(
                jp, jnp.asarray(tok), jnp.asarray(tgt))
        out["grads", shape] = [np.asarray(x) for x in
                               jax.tree_util.tree_leaves(grads)]
    out["loss"] = float(jax.jit(jpl.make_loss_fn(
        jc, Mesh(np.asarray(jax.devices()[:4]).reshape(1, 2, 2), AXES)))(
        jp, jnp.asarray(tok), jnp.asarray(tgt)))
    return out


def test_param_specs_match_jax():
    want = jax.tree_util.tree_map(
        tuple, jpl.param_specs(jpl.PipelineMoEConfig(**KW)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))

    def plain(s):
        return ({k: plain(v) for k, v in s.items()} if isinstance(s, dict)
                else tuple(s))

    assert plain(tpl.param_specs(tpl.PipelineMoEConfig(**KW))) == want


def test_block_and_unpipelined_loss_match_jax(reference):
    jc, tc = jpl.PipelineMoEConfig(**KW), tpl.PipelineMoEConfig(**KW)
    jp = reference["params"]
    params = pipeline_lm_params_from_jax(jp, tc, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 8, 32)).astype(
        np.float32)
    layer = jax.tree_util.tree_map(lambda a: a[1, 0], jp["stages"])
    want = jax.jit(lambda p, xx: jpl.block_fn(jc, p, xx))(layer,
                                                          jnp.asarray(x))
    got = tpl.block_fn(tc, {k: v for k, v in _layer(params, 1, 0).items()},
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    tok, tgt = _batch(0)
    loss = tpl.sequential_loss_fn(params, tok, tgt, tc)
    assert abs(float(loss) - reference["loss"]) <= 1e-5


def _layer(params, stage, j):
    from kfunca_tpu_torch.utils.tree import tree_map

    return tree_map(lambda a: a[stage, j], params["stages"])


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 1), (2, 2, 2)])
def test_train_step_matches_jax(reference, shape):
    tc = tpl.PipelineMoEConfig(**KW)
    params = pipeline_lm_params_from_jax(reference["params"], tc,
                                         device="cpu")
    mesh = tmesh.LocalMesh(axes=dict(zip(AXES, shape)), device="cpu")
    sp = tpl.shard_params(params, mesh, tc)
    tok, tgt = _batch(0)
    sp, loss = tpl.make_train_step(tc, mesh, lr=0.1)(sp, tok, tgt)
    want_loss, want = reference[shape]
    assert abs(float(loss) - want_loss) <= 1e-5
    for got, w in zip(tree_leaves(tmesh.gather_params(sp)), want):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 1), (2, 2, 2)])
def test_every_ranks_gradient_matches_jax(reference, shape):
    """The gradients themselves, as the step adds them over dp: an update
    of lr x g beside the param hides a wrong gradient of a leaf whose
    gradients are small."""
    from kfunca_tpu_torch.parallel import collectives as cc
    from kfunca_tpu_torch.utils.tree import tree_map

    tc = tpl.PipelineMoEConfig(**KW)
    params = pipeline_lm_params_from_jax(reference["params"], tc,
                                         device="cpu")
    mesh = tmesh.LocalMesh(axes=dict(zip(AXES, shape)), device="cpu")
    sp = tpl.shard_params(params, mesh, tc)
    views = [tree_map(lambda p: p.detach().requires_grad_(True), t)
             for t in sp.local]
    vp = tmesh.ShardedParams(mesh, views, sp.shards, sp.specs, sp.cfg)
    tok, tgt = _batch(0)
    flat = [v for t in views for v in tree_leaves(t)]
    grads = torch.autograd.grad(sum(tpl.make_loss_fn(tc, mesh)(vp, tok, tgt)),
                                flat)
    want = reference["grads", shape]
    n = len(want)
    noise = 2.0 ** -16 * max(np.abs(w).max() for w in want)
    marks = tree_map(lambda _: False, sp.shards)
    marks["stages"]["moe"]["router"] = True
    router = tree_leaves(marks).index(True)
    assert tc.moe.top_k == 1
    for i, (shard, _) in enumerate(sp.leaves()):
        parts = cc.all_reduce([grads[j * n + i] for j in range(len(views))],
                              mesh, "dp")
        for got in tmesh.gather_leaf(mesh, shard, parts):
            assert got.shape == want[i].shape
            if i == router:
                assert max(got.abs().max(), np.abs(want[i]).max()) <= noise
            else:
                np.testing.assert_allclose(
                    got.numpy(), want[i], rtol=0,
                    atol=1e-4 * np.abs(want[i]).max())


def test_a_rank_holds_its_stage_heads_and_experts():
    tc = tpl.PipelineMoEConfig(**KW)
    params = tpl.init_params(0, tc, device="cpu")
    mesh = tmesh.LocalMesh(axes={"dp": 1, "pp": 2, "tp": 2}, device="cpu")
    sp = tpl.shard_params(params, mesh, tc)
    hd = tc.head_dim
    # rank (0, 1, 1): stage 1, head 1 of q, k and v, experts 2 and 3
    mine = sp.local[3]["stages"]
    w = params["stages"]["wqkv"][1:]
    want = torch.cat([w[..., hd:2 * hd], w[..., 3 * hd:4 * hd],
                      w[..., 5 * hd:6 * hd]], dim=-1)
    assert torch.equal(mine["wqkv"], want)
    assert torch.equal(mine["moe"]["w_in"],
                       params["stages"]["moe"]["w_in"][1:, :, 2:])
    assert torch.equal(sp.local[3]["embed"], params["embed"][:, 16:])
    back = tmesh.gather_params(sp)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)


def test_dp_rows_take_a_share_of_every_microbatch():
    mesh = tmesh.LocalMesh(axes={"dp": 2, "pp": 1, "tp": 1}, device="cpu")
    batch = torch.arange(8)[:, None].expand(8, 3)
    rows = tpl.dp_rows(mesh, batch, 2)
    assert rows[0][:, 0].tolist() == [0, 1, 4, 5]
    assert rows[1][:, 0].tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="microbatches"):
        tpl.dp_rows(mesh, batch[:6], 2)
