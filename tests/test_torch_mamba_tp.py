"""Port parity: the tensor-parallel Mamba (models/mamba.py).

mamba_param_specs against the JAX package's; shard_mamba_params -> gather
bit for bit, and a rank's columns of each half of in_proj; the forward over
LocalMesh meshes against JAX's forward on shard_mamba_params over its
virtual CPU devices (fp32 logits within 1e-5); one step of
make_sharded_mamba_train_step against JAX's make_mamba_train_step on the
sharded params (fp32: the loss within 1e-5, every updated param within
1e-4 of its leaf's largest entry), with SGD and AdamW; every rank's loss
gradient against JAX's within 1e-4 of each leaf's largest entry; and the
sharded step against the port's unsharded make_mamba_train_step with
gradient accumulation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import mamba as jmb
from kfunca_tpu.models import train as jtr
from kfunca_tpu.parallel import mesh as jmesh
from kfunca_tpu_torch.models import mamba as tmb
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models.weights import mamba_params_from_jax
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.utils.tree import tree_leaves

KW = dict(vocab_size=64, d_model=32, n_layers=2, d_state=4, dtype="float32")
MESHES = [(2, 2), (1, 4), (1, 2)]
OPTS = {"sgd": dict(algo="sgd", lr=1e-2), "adamw": dict(lr=1e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 64, (4, 16)).astype(np.int32)
    tgt = rng.integers(0, 64, (4, 16)).astype(np.int32)
    tgt[0, :3] = tmb.IGNORE  # masked positions count nothing
    return tok, tgt


@pytest.fixture(scope="module")
def reference():
    jc = jmb.MambaConfig(**KW)
    jp = jmb.init_mamba_params(jax.random.PRNGKey(0), jc)
    tok, tgt = _batch(0)
    jm = jmesh.make_mesh(4, dp=2, tp=2)
    out = {"params": jp}
    with jm:
        sharded = jmb.shard_mamba_params(jp, jm)
        out["logits"] = np.asarray(jax.jit(lambda p, t: jmb.forward(
            p, t, jc))(sharded, jnp.asarray(tok)))
        for name, oc in OPTS.items():
            oc = jtr.OptConfig(**oc)
            new, _, loss = jax.jit(jmb.make_mamba_train_step(jc, oc))(
                sharded, jtr.init_opt_state(sharded, oc), jnp.asarray(tok),
                jnp.asarray(tgt))
            out[name] = (float(loss), [np.asarray(x) for x in
                                       jax.tree_util.tree_leaves(new)])
        grads = jax.jit(jax.grad(lambda p: jmb.loss_fn(
            p, jnp.asarray(tok), jnp.asarray(tgt), jc)))(sharded)
        out["grads"] = [np.asarray(x) for x in
                        jax.tree_util.tree_leaves(grads)]
    return out


def _params(reference):
    return mamba_params_from_jax(reference["params"], tmb.MambaConfig(**KW),
                                 device="cpu")


def test_specs_match_jax(reference):
    want = jax.tree_util.tree_map(
        tuple, jmb.mamba_param_specs(reference["params"]),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = tmb.mamba_param_specs(_params(reference))
    got = {"embed": tuple(got["embed"]), "final_norm": tuple(
        got["final_norm"]), "layers": [{k: tuple(v) for k, v in lay.items()}
                                       for lay in got["layers"]]}
    assert got == want


@pytest.mark.parametrize("shape", MESHES)
def test_shard_then_gather_is_bit_exact(reference, shape):
    params = _params(reference)
    sp = tmb.shard_mamba_params(params, tmesh.LocalMesh(*shape, "cpu"))
    for a, b in zip(tree_leaves(tmesh.gather_params(sp)),
                    tree_leaves(params)):
        assert torch.equal(a, b)


def test_a_rank_holds_its_channels_of_each_half_of_in_proj(reference):
    params = _params(reference)
    sp = tmb.shard_mamba_params(params, tmesh.LocalMesh(1, 2, "cpu"))
    w = params["layers"][0]["in_proj"]  # (32, 2 x 64): [hidden | gate]
    for t in range(2):
        want = torch.cat([w[:, 32 * t:32 * (t + 1)],
                          w[:, 64 + 32 * t:64 + 32 * (t + 1)]], dim=1)
        assert torch.equal(sp.local[t]["layers"][0]["in_proj"], want)
        assert torch.equal(sp.local[t]["layers"][0]["A_log"],
                           params["layers"][0]["A_log"][32 * t:32 * (t + 1)])
    with pytest.raises(ValueError, match="split into"):
        tmb.shard_mamba_params(params, tmesh.LocalMesh(1, 3, "cpu"))


def test_halves_come_from_the_spec_not_the_leaf_name():
    """A Halves spec splits each half over tp whatever the leaf is called;
    a plain spec splits contiguously, in_proj or not."""
    w = torch.arange(16.0).reshape(2, 8)
    mesh = tmesh.LocalMesh(1, 2, "cpu")
    plain = tmesh.shard_tree({"in_proj": w}, {"in_proj": tmesh.P(None, "tp")},
                             mesh)
    halves = tmesh.shard_tree({"w": w}, {"w": tmesh.Halves(None, "tp")}, mesh)
    assert tmesh.Halves(None, "tp") == tmesh.P(None, "tp") == (None, "tp")
    for t in range(2):
        assert torch.equal(plain.local[t]["in_proj"], w[:, 4 * t:4 * (t + 1)])
        assert torch.equal(halves.local[t]["w"], torch.cat(
            [w[:, 2 * t:2 * (t + 1)], w[:, 4 + 2 * t:4 + 2 * (t + 1)]], 1))
    for sp in (plain, halves):
        assert torch.equal(next(iter(tmesh.gather_params(sp).values())), w)


@pytest.mark.parametrize("shape", MESHES)
def test_forward_over_a_mesh_matches_jax(reference, shape):
    sp = tmb.shard_mamba_params(_params(reference),
                                tmesh.LocalMesh(*shape, "cpu"))
    tok, _ = _batch(0)
    got = tmb.forward(sp, torch.from_numpy(tok), tmb.MambaConfig(**KW))
    np.testing.assert_allclose(got.numpy(), reference["logits"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_step_matches_jax(reference, shape, opt):
    tc = tmb.MambaConfig(**KW)
    mesh = tmesh.LocalMesh(*shape, "cpu")
    oc = ttr.OptConfig(**OPTS[opt])
    sp = tmb.shard_mamba_params(_params(reference), mesh)
    step = tmb.make_sharded_mamba_train_step(tc, mesh, oc)
    tok, tgt = _batch(0)
    sp, _, loss = step(sp, ttr.init_opt_state(sp, oc), tok, tgt)
    want_loss, want = reference[opt]
    assert abs(float(loss) - want_loss) <= 1e-5
    for got, w in zip(tree_leaves(tmesh.gather_params(sp)), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("shape", MESHES)
def test_every_ranks_gradient_matches_jax(reference, shape):
    """The gradients themselves (an update of lr x g beside the param
    hides a wrong gradient of a leaf whose gradients are small): each
    rank's share of the masked mean NLL, the shares' gradients added over
    dp as the step adds them, within 1e-4 of each leaf's largest entry."""
    from kfunca_tpu_torch.models.transformer import rank_batches
    from kfunca_tpu_torch.parallel import collectives as cc
    from kfunca_tpu_torch.utils.tree import tree_map

    tc = tmb.MambaConfig(**KW)
    mesh = tmesh.LocalMesh(*shape, "cpu")
    sp = tmb.shard_mamba_params(_params(reference), mesh)
    views = [tree_map(lambda p: p.detach().requires_grad_(True), t)
             for t in sp.local]
    vp = tmesh.ShardedParams(mesh, views, sp.shards, sp.specs, sp.cfg)
    tok, tgt = _batch(0)
    count = int((tgt != tmb.IGNORE).sum())
    tgts = rank_batches(mesh, tgt)
    nlls = tmb.tp_token_nll(vp, rank_batches(mesh, tok), tgts, tc)
    shares = [(n * (t.reshape(-1) != tmb.IGNORE)).sum() / count
              for n, t in zip(nlls, tgts)]
    flat = [v for t in views for v in tree_leaves(t)]
    grads = torch.autograd.grad(sum(shares), flat)
    want = reference["grads"]
    n = len(want)
    for i, (shard, _) in enumerate(sp.leaves()):
        parts = cc.all_reduce([grads[j * n + i] for j in range(len(views))],
                              mesh, "dp")
        for got in tmesh.gather_leaf(mesh, shard, parts):
            np.testing.assert_allclose(got.numpy(), want[i], rtol=0,
                                       atol=1e-4 * np.abs(want[i]).max())


def test_sharded_step_with_accumulation_matches_the_unsharded_step(
        reference):
    tc = tmb.MambaConfig(**KW)
    oc = ttr.OptConfig(algo="sgd", lr=1e-2)
    tok, tgt = _batch(1)
    ref = _params(reference)
    ref, _, want = ttr.make_loss_train_step(
        lambda p, t, y: tmb.loss_fn(p, t, y, tc), oc, "cpu")(
        ref, ttr.init_opt_state(ref, oc, device="cpu"),
        torch.from_numpy(tok[:2]), torch.from_numpy(tgt[:2]))
    ref2 = _params(reference)
    ref2, _, want2 = ttr.make_loss_train_step(
        lambda p, t, y: tmb.loss_fn(p, t, y, tc), oc, "cpu")(
        ref2, ttr.init_opt_state(ref2, oc, device="cpu"),
        torch.from_numpy(tok[2:]), torch.from_numpy(tgt[2:]))
    mesh = tmesh.LocalMesh(2, 2, "cpu")
    sp = tmb.shard_mamba_params(_params(reference), mesh)
    step = tmb.make_sharded_mamba_train_step(tc, mesh, oc, grad_accum=2,
                                             with_metrics=True)
    sp, _, metrics = step(sp, ttr.init_opt_state(sp, oc), tok, tgt)
    assert abs(float(metrics["loss"]) - (float(want) + float(want2)) / 2) \
        <= 1e-5
    # one SGD step on the mean of the two microbatches' gradients is the
    # mean of the two single-microbatch updates
    for got, a, b in zip(tree_leaves(tmesh.gather_params(sp)),
                         tree_leaves(ref), tree_leaves(ref2)):
        want_p = (a + b) / 2
        tol = 1e-4 * float(want_p.abs().max())
        torch.testing.assert_close(got, want_p, rtol=0, atol=tol)
