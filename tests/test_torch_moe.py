"""Port parity: models/moe.py.

_topk_dispatch's dispatch / combine tables, moe_ffn (top-1, top-2, a
capacity that drops tokens, rescue ranks) and expert_choice_ffn against
the JAX package on the same numpy weights and inputs (forward within 1e-5,
gradients within 1e-4 of each leaf's largest entry); make_moe_ffn_ep over
LocalMesh(ep = 4) against JAX's make_moe_ffn_ep on its virtual CPU
devices, and against each rank's moe_ffn over its own tokens; the
tensor-parallel expert split (moe_ffn_experts) against moe_ffn.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from kfunca_tpu.models import moe as jmoe
from kfunca_tpu_torch.models import moe as tmoe
from kfunca_tpu_torch.models.weights import moe_params_from_jax
from kfunca_tpu_torch.parallel import mesh as tmesh

CASES = {"top1": dict(top_k=1), "top2": dict(top_k=2),
         "top2_drops": dict(top_k=2, capacity_factor=0.6),
         "rescue": dict(top_k=1, rescue_ranks=1, capacity_factor=0.5)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    kw = {**dict(n_experts=4, d_model=16, d_ff=24), **kw}
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _params(jc, tc, seed=0):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), jc)
    return jp, moe_params_from_jax(jp, tc, device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_tables_match_jax(case):
    jc, _ = _cfgs(**CASES[case])
    probs = jax.nn.softmax(jnp.asarray(_x((32, 4), seed=3)) * 2.0)
    cap = max(1, int(jc.capacity_factor * jc.top_k * 32 / 4))
    want = jmoe._topk_dispatch(probs, 4, cap, jc.top_k, jc.rescue_ranks)
    got = tmoe._topk_dispatch(torch.from_numpy(np.array(probs)), 4, cap,
                              jc.top_k, jc.rescue_ranks)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[1].numpy(), want[1], 1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case):
    """Output, aux loss and the gradients of sum(out * w) + aux."""
    jc, tc = _cfgs(**CASES[case])
    jp, tp = _params(jc, tc)
    x, w = _x((2, 8, 16), 1), _x((2, 8, 16), 2)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(xx, p, jc)
        return jnp.sum(out * w) + aux

    jout, jaux = jax.jit(lambda p, xx: jmoe.moe_ffn(xx, p, jc))(
        jp, jnp.asarray(x))
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_ffn(xt, leaves, tc)
    _close(out.detach().numpy(), jout)
    _close(aux.detach().numpy(), jaux)
    keys = ("router", "w_in", "w_out")
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [leaves[k] for k in keys] + [xt])
    for g, want in zip(grads, [jg[0][k] for k in keys] + [jg[1]]):
        _close(g.numpy(), want, 1e-4)


def test_expert_choice_ffn_matches_jax():
    jc, tc = _cfgs(capacity_factor=1.0)
    jp, tp = _params(jc, tc, seed=3)
    x, w = _x((2, 8, 16), 4), _x((2, 8, 16), 5)
    jout, jaux = jax.jit(lambda p: jmoe.expert_choice_ffn(
        jnp.asarray(x), p, jc))(jp)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jmoe.expert_choice_ffn(
        jnp.asarray(x), p, jc)[0] * w)))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out, aux = tmoe.expert_choice_ffn(torch.from_numpy(x), leaves, tc)
    _close(out.detach().numpy(), jout)
    assert float(aux) == float(jaux) == 0.0
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [leaves[k] for k in ("router", "w_in",
                                                     "w_out")])
    for g, k in zip(grads, ("router", "w_in", "w_out")):
        _close(g.numpy(), jg[k], 1e-4)


@pytest.fixture(scope="module")
def ep_reference():
    """JAX's make_moe_ffn_ep over ep = 4 (8 experts, top-2), capacity 8
    (nothing drops) and 1 (tokens drop): outputs and the gradients of
    sum(out ** 2)."""
    out = {}
    for cf in (8.0, 1.0):
        kw = dict(n_experts=8, d_model=16, d_ff=32, capacity_factor=cf,
                  top_k=2)
        jc = jmoe.MoEConfig(**kw)
        jp = jmoe.init_moe_params(jax.random.PRNGKey(8), jc)
        ex = np.asarray(jax.random.normal(jax.random.PRNGKey(9),
                                          (8, 4, 16), jnp.float32))
        jm = Mesh(np.asarray(jax.devices()[:4]), ("ep",))
        fn = jmoe.make_moe_ffn_ep(jm, jc)
        with jm:
            jo, _ = jax.jit(fn)(jnp.asarray(ex), jp)
            jg = jax.jit(jax.grad(lambda p: jnp.sum(
                fn(jnp.asarray(ex), p)[0] ** 2)))(jp)
        out[cf] = (kw, jp, ex, np.asarray(jo),
                   jax.tree_util.tree_map(np.asarray, jg))
    return out


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_expert_parallel_matches_jax(ep_reference, cf):
    kw, jp, ex, jo, jg = ep_reference[cf]
    tc = tmoe.MoEConfig(**kw)
    mesh = tmesh.LocalMesh(axes={"ep": 4}, device="cpu")
    params = moe_params_from_jax(jp, tc, device="cpu")
    sp = tmoe.shard_moe_params(params, mesh)
    assert sp.local[1]["w_in"].shape == (2, 16, 32)
    trees = [{k: v.clone().requires_grad_(True) for k, v in t.items()}
             for t in sp.local]
    outs, auxes = tmoe.make_moe_ffn_ep(mesh, tc)(torch.from_numpy(ex), trees)
    _close(torch.cat(outs).detach().numpy(), jo)
    grads = torch.autograd.grad(sum((o ** 2).sum() for o in outs),
                                [t[k] for t in trees
                                 for k in ("router", "w_in", "w_out")])
    for i in range(4):  # the router's whole gradient on every rank
        _close(grads[3 * i].numpy(), jg["router"], 1e-4)
    for j, key in ((1, "w_in"), (2, "w_out")):
        _close(torch.cat([grads[3 * i + j] for i in range(4)]).numpy(),
               jg[key], 1e-4)
    # routing and capacity are each sender's: each rank's moe_ffn over its
    # own tokens with all the experts, drops included
    for i in range(4):
        want, aux = tmoe.moe_ffn(torch.from_numpy(ex[2 * i:2 * i + 2]),
                                 params, tc)
        _close(outs[i].detach().numpy(), want.numpy())
        _close(auxes[i].detach().numpy(), aux.numpy())
    if cf == 8.0:  # nothing drops: the replicated moe_ffn over all tokens
        want, _ = jmoe.moe_ffn(jnp.asarray(ex), jp, jmoe.MoEConfig(**kw))
        _close(torch.cat(outs).detach().numpy(), want, 2e-5)


def test_expert_split_over_ranks_sums_to_moe_ffn():
    """moe_ffn_experts: the parts of two expert halves add up to moe_ffn;
    the tokens of one batch over two dp ranks (with the global capacity
    and seating order) give moe_ffn over the whole batch, drops and all."""
    _, tc = _cfgs(top_k=2, capacity_factor=0.75)
    params = tmoe.init_moe_params(5, tc, device="cpu")
    x = torch.from_numpy(_x((4, 8, 16), 6))
    want, _ = tmoe.moe_ffn(x, params, tc)
    halves = [params["w_in"][:2], params["w_in"][2:]]
    outs = [params["w_out"][:2], params["w_out"][2:]]
    parts = tmoe.moe_ffn_experts([x, x], [params["router"]] * 2, halves,
                                 outs, [0, 2], tc)
    torch.testing.assert_close(parts[0] + parts[1], want, rtol=0, atol=1e-5)
    mesh = tmesh.LocalMesh(axes={"dp": 2}, device="cpu")
    rows = tmoe.moe_ffn_experts(list(x.chunk(2)), [params["router"]] * 2,
                                [params["w_in"]] * 2, [params["w_out"]] * 2,
                                [0, 0], tc, mesh, "dp")
    torch.testing.assert_close(torch.cat(rows), want, rtol=0, atol=1e-5)
    alone = tmoe.moe_ffn(x[:2], params, tc)[0]
    assert not torch.allclose(alone, want[:2])  # the capacity is global


def test_init_moe_params_has_the_jax_shapes_and_laws():
    tc = tmoe.MoEConfig(n_experts=4, d_model=64, d_ff=256)
    p = tmoe.init_moe_params(0, tc, device="cpu")
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), jmoe.MoEConfig(
        n_experts=4, d_model=64, d_ff=256))
    for k in ("router", "w_in", "w_out"):
        assert tuple(p[k].shape) == jp[k].shape
        bound = float(np.abs(np.asarray(jp[k])).max())
        assert float(p[k].abs().max()) <= 1.0 / np.sqrt(
            64 if k != "w_out" else 256) and bound > 0
    with pytest.raises(ValueError, match="does not match"):
        moe_params_from_jax({**jp, "w_in": np.zeros((4, 64, 8))}, tc,
                            device="cpu")
