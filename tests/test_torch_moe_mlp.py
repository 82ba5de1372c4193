"""Port parity: the flagship's routed MoE MLP (models/transformer.py).

The same numpy inputs and the same weights (the JAX init_params carried
across by models/weights.params_from_jax, router biases drawn from a seed)
go through the JAX package's `mlp` and the port's in fp32 on the CPU, in
the routing forms of Mixtral (softmax, top-2), Qwen3-MoE (no
renormalisation), DeepSeek-V3 (sigmoid scores, a selection bias,
group-limited selection, a routed scale, a shared expert, a dense first
layer), a zero router (every score tied: lax.top_k picks experts 0..k-1)
and a negative bias that ranks masked experts (scores 0.0) above kept ones.

The JAX function runs every expert over every token and scales unrouted
ones by an exact 0; the port runs each expert over its routed rows only.
The sums are the same, so outputs and gradients agree to a few fp32 ulps
of the values involved: 1e-5 of max(1, max |ref|) a tensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import serve as jserve
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import (
    decode_params_from_jax, params_from_jax,
)
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.utils.tree import tree_leaves

BASE = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=96, max_seq_len=64, dtype="float32")
FORMS = {
    "mixtral": dict(n_experts=4, moe_top_k=2),
    "qwen3_moe": dict(n_experts=8, moe_top_k=2, moe_norm_topk=False,
                      moe_d_ff=32, qk_norm=True),
    "deepseek": dict(n_experts=8, moe_top_k=2, moe_score="sigmoid",
                     moe_score_bias=True, moe_n_group=4, moe_topk_group=2,
                     moe_routed_scale=2.5, n_shared_experts=1, moe_d_ff=32,
                     moe_first_dense=1),
    "tie": dict(n_experts=4, moe_top_k=2),
    "masked": dict(n_experts=8, moe_top_k=2, moe_score="sigmoid",
                   moe_score_bias=True, moe_n_group=2, moe_topk_group=1),
}
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _weights(form, seed=0):
    """(jax config, jax params, port config, port params) of a form."""
    kw = {**BASE, **FORMS[form]}
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed + 1)
    for blk in jp["blocks"]:
        if form == "tie" and "router" in blk:
            blk["router"] = jnp.zeros_like(blk["router"])
        if "router_bias" in blk:
            bias = rng.standard_normal(blk["router_bias"].shape) * 0.05
            if form == "masked":  # every kept choice below the masked 0.0
                bias = bias - 2.0
            blk["router_bias"] = jnp.asarray(bias, jnp.float32)
    return jc, jp, tc, params_from_jax(jp, tc, device="cpu")


_CACHE = {}


def _shared(form):
    if form not in _CACHE:
        _CACHE[form] = _weights(form)
    return _CACHE[form]


def _moe_block(jp):
    return next(i for i, b in enumerate(jp["blocks"]) if "experts" in b)


def _y(seed=3, shape=(2, 7, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("form", list(FORMS))
def test_routing_picks_the_jax_experts(form):
    """The chosen experts (in lax.top_k's order) and their weights."""
    jc, jp, tc, tp = _shared(form)
    i = _moe_block(jp)
    y = _y()
    topi, topv = ttf.moe_routing(torch.from_numpy(y), tp["blocks"][i], tc)
    # the JAX routing, recomputed from its own weights: w = onehot . topv
    jb = jp["blocks"][i]
    ey = jnp.asarray(y)
    logits = jnp.dot(ey, jb["router"])
    scores = (jax.nn.sigmoid(logits) if jc.moe_score == "sigmoid"
              else jax.nn.softmax(logits, axis=-1))
    choice = scores + jb["router_bias"] if "router_bias" in jb else scores
    if jc.moe_n_group > 1:
        epg = jc.n_experts // jc.moe_n_group
        gs = choice.reshape(*choice.shape[:-1], jc.moe_n_group, epg)
        gsum = jnp.sum(jax.lax.top_k(gs, 2)[0], axis=-1)
        gmask = jnp.sum(jax.nn.one_hot(jax.lax.top_k(
            gsum, jc.moe_topk_group)[1], jc.moe_n_group), axis=-2)
        choice = jnp.where(jnp.repeat(gmask, epg, axis=-1) > 0, choice, 0.0)
    want = np.asarray(jax.lax.top_k(choice, jc.moe_top_k)[1])
    np.testing.assert_array_equal(topi.numpy(), want)
    if form == "tie":  # every score equal: experts 0..k-1, lowest first
        assert (topi.numpy() == np.arange(jc.moe_top_k)).all()
    if form == "masked":  # the picks lie in masked groups (choice 0.0)
        kept = np.asarray(gmask).argmax(-1)
        assert (topi.numpy() // (jc.n_experts // jc.moe_n_group)
                != kept[..., None]).all()
    assert topv.dtype == torch.float32


@pytest.mark.parametrize("form", list(FORMS))
def test_moe_mlp_output_and_gradients_match_jax(form):
    """mlp's output, and its input and weight gradients under one random
    cotangent."""
    jc, jp, tc, tp = _shared(form)
    i = _moe_block(jp)
    y = _y()
    g = np.random.default_rng(4).standard_normal(y.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda yy, pp: jtf.mlp(yy, pp, jc), jnp.asarray(y),
                         jp["blocks"][i])
    dy_j, dp_j = vjp(jnp.asarray(g))
    blk = {k: v for k, v in tp["blocks"][i].items()}
    leaves = tree_leaves(blk)
    for leaf in leaves:
        leaf.requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    out = ttf.mlp(yt, blk, tc)
    grads = torch.autograd.grad(out, [yt] + leaves, torch.from_numpy(g),
                                allow_unused=True, materialize_grads=True)
    _close(out, out_j, what="out")
    _close(grads[0], dy_j, what="dy")
    for got, want in zip(grads[1:], jax.tree_util.tree_leaves(dp_j)):
        _close(got, want, what="dw")
    for leaf in leaves:
        leaf.requires_grad_(False)


@pytest.mark.parametrize("form", ["mixtral", "qwen3_moe", "deepseek"])
def test_forward_and_chunked_loss_match_jax(form):
    jc, jp, tc, tp = _shared(form)
    toks = np.random.default_rng(5).integers(0, 96, (2, 12))
    want = jtf.forward(jp, jnp.asarray(toks, jnp.int32), jc)
    _close(ttf.forward(tp, torch.from_numpy(toks), tc), want)
    want_l = jtf.loss_fn_chunked(jp, jnp.asarray(toks[:, :-1], jnp.int32),
                                 jnp.asarray(toks[:, 1:], jnp.int32), jc,
                                 vocab_chunk=32)
    got_l = ttf.loss_fn_chunked(tp, torch.from_numpy(toks[:, :-1]),
                                torch.from_numpy(toks[:, 1:]), tc,
                                vocab_chunk=32)
    assert abs(float(got_l) - float(want_l)) <= 1e-5


@pytest.mark.parametrize("form", ["mixtral", "deepseek"])
def test_train_step_loss_and_gradients_match_jax(form):
    """make_train_step's loss and every gradient (its with_metrics norm and
    one SGD step's params) against jax.value_and_grad of loss_fn.  The
    router bias only chooses: its gradient is 0 on both sides."""
    jc, jp, tc, _ = _shared(form)
    w = np.random.default_rng(6).integers(0, 96, (2, 13))
    tok, tgt = w[:, :-1], w[:, 1:]
    loss_j, g_j = jax.value_and_grad(jtf.loss_fn)(
        jp, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32), jc)
    tp = params_from_jax(jp, tc, device="cpu")
    lr = 0.5
    oc = ttr.OptConfig(algo="sgd", lr=lr, weight_decay=0.0)
    step = ttr.make_train_step(tc, oc, with_metrics=True, device="cpu")
    tp, _, m = step(tp, ttr.init_opt_state(tp, oc, device="cpu"), tok, tgt)
    assert abs(float(m["loss"]) - float(loss_j)) <= 1e-5
    norm_j = float(jnp.sqrt(sum(jnp.sum(x * x) for x in
                                jax.tree_util.tree_leaves(g_j))))
    assert abs(float(m["grad_norm"]) - norm_j) <= 1e-5 * max(1.0, norm_j)
    if "router_bias" in jp["blocks"][-1]:
        assert float(jnp.abs(g_j["blocks"][-1]["router_bias"]).max()) == 0.0
    lr_0 = float(ttr.schedule_lr(oc, torch.tensor(1)))
    for got, p0, gj in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                           jax.tree_util.tree_leaves(g_j)):
        implied = (np.asarray(p0) - got.numpy()) / lr_0
        _close(implied, gj, tol=1e-4)


@pytest.mark.parametrize("form", ["mixtral", "deepseek"])
def test_init_params_has_the_jax_layout(form):
    """The same keys, shapes and dtypes, leaf for leaf."""
    jc, jp, tc, _ = _shared(form)
    got = ttf.init_params(0, tc, device="cpu")
    a = jax.tree_util.tree_flatten_with_path(jp)[0]
    b = tree_leaves(got)
    assert len(a) == len(b)
    assert [tuple(x.shape) for x in b] == [tuple(np.shape(x)) for _, x in a]
    ex = got["blocks"][-1]["experts"]
    assert len(ex) == tc.n_experts and sorted(ex[0]) == [
        "w_down", "w_gate", "w_up"]
    if form == "deepseek":
        assert "w_gate" in got["blocks"][0]  # moe_first_dense = 1
        assert float(got["blocks"][1]["router_bias"].abs().max()) == 0.0
        assert got["blocks"][1]["shared"]["w_down"].shape == (32, 64)


def test_bf16_moe_mlp_matches_jax_within_a_bf16_step():
    """bf16 activations: the routing in fp32 on both sides, each expert's
    products summed in fp32 and their activations rounded to bf16; the
    outputs stand within 2^-7 of max |ref| (one bf16 rounding apart)."""
    jc, jp, tc, tp = _shared("deepseek")
    jc = dataclasses.replace(jc, dtype="bfloat16")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    y = _y(7)
    want = jtf.mlp(jnp.asarray(y, jnp.bfloat16), jp["blocks"][1], jc)
    got = ttf.mlp(torch.from_numpy(y).to(torch.bfloat16), tp["blocks"][1], tc)
    assert got.dtype == torch.float32
    _close(got, want, tol=2.0 ** -7)


def _widen_int4(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.int8) if x.dtype == jnp.int4 else x, tree)


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_params_from_jax_takes_quantized_experts(bits):
    """The JAX quantize_decode_params tree of a DeepSeek-routed MoE (lists
    of (intN, scale) pairs for the experts, the router, its bias and the
    shared expert in fp32) crosses as it is, and equals the port's own
    quantization leaf for leaf."""
    jc, jp, tc, tp = _shared("deepseek")
    want = decode_params_from_jax(
        _widen_int4(jserve.quantize_decode_params(jp, bits=bits)),
        device="cpu")
    blk = want["blocks"][1]
    assert all(isinstance(w, tuple) for ex in blk["experts"]
               for w in ex.values())
    assert not isinstance(blk["router"], tuple)
    assert not isinstance(blk["shared"]["w_gate"], tuple)
    from kfunca_tpu_torch.models import serve as tserve

    got = tserve.quantize_decode_params(tp, bits=bits)
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_params_from_jax_checks_an_mla_block_by_its_own_keys():
    kw = {**BASE, **FORMS["deepseek"], "attention": "mla", "kv_lora_rank": 16,
          "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "n_kv_heads": None}
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    assert "wqkv" not in jp["blocks"][0]
    params_from_jax(jp, tc, device="cpu")
    bad = dataclasses.replace(tc, kv_lora_rank=32)
    with pytest.raises(ValueError, match="w_dkv"):
        params_from_jax(jp, bad, device="cpu")
    with pytest.raises(ValueError, match="w_dq"):
        params_from_jax(jp, dataclasses.replace(tc, q_lora_rank=8),
                        device="cpu")


# -- tensor parallelism ---------------------------------------------------------


def _step_pair(form, fsdp, grad_accum):
    """The port's unsharded SGD step and its sharded step over
    LocalMesh(2, 2) from the same weights and batch: (loss, params) each,
    the sharded params gathered to the global layout."""
    jc, jp, tc, _ = _shared(form)
    w = np.random.default_rng(8).integers(0, 96, (4, 13))
    tok, tgt = w[:, :-1], w[:, 1:]
    oc = ttr.OptConfig(algo="sgd", lr=1e-2)
    ref = params_from_jax(jp, tc, device="cpu")
    step = ttr.make_train_step(tc, oc, grad_accum=grad_accum, device="cpu")
    ref, _, loss = step(ref, ttr.init_opt_state(ref, oc, device="cpu"), tok,
                        tgt)
    mesh = tmesh.LocalMesh(2, 2, "cpu")
    sp = tmesh.shard_params(params_from_jax(jp, tc, device="cpu"), mesh,
                            fsdp=fsdp, cfg=tc)
    sstep = ttr.make_sharded_train_step(tc, mesh, oc, fsdp=fsdp,
                                        grad_accum=grad_accum)
    sp, _, sloss = sstep(sp, [ttr.init_opt_state(t, oc, device="cpu")
                              for t in sp.local], tok, tgt)
    return loss, ref, sloss, tmesh.gather_params(sp)


@pytest.mark.parametrize("form,fsdp,accum", [
    ("mixtral", False, 1), ("mixtral", True, 2), ("deepseek", False, 1),
    ("deepseek", True, 2)])
def test_sharded_step_matches_the_unsharded_step(form, fsdp, accum):
    """dp 2 x tp 2 (and fsdp with accumulation): every expert split over
    tp, one all-reduce a block; the loss to 1e-5 and the params after one
    SGD step to 1e-5 of each leaf's largest entry."""
    loss, ref, sloss, got = _step_pair(form, fsdp, accum)
    assert abs(float(loss) - float(sloss)) <= 1e-5
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        _close(a, b.numpy())


def test_tp_moe_runs_one_all_reduce_a_block():
    """The forward over tp = 2 sums each MoE block's experts in one "sum"
    collective (with the attention's, two a block; one more for the tied
    head's row-parallel product)."""
    jc, jp, tc, tp = _shared("mixtral")
    mesh = tmesh.LocalMesh(1, 2, "cpu")
    sp = tmesh.shard_params(tp, mesh, cfg=tc)
    counts = {}
    inner = mesh.collective

    def counting(kind, *a, **kw):
        counts[kind] = counts.get(kind, 0) + 1
        return inner(kind, *a, **kw)

    mesh.collective = counting
    toks = np.random.default_rng(9).integers(0, 96, (1, 8))
    with torch.no_grad():
        got = ttf.forward(sp, torch.from_numpy(toks), tc)
    assert counts.get("sum") == 2 * tc.n_layers + 1
    _close(got, ttf.forward(tp, torch.from_numpy(toks), tc).numpy())


@pytest.mark.parametrize("form", ["dense", "mixtral", "deepseek"])
def test_a_train_step_leaves_no_tensor_in_a_reference_cycle(form):
    """The step's gradients die when it returns: nothing of it waits in a
    reference cycle for the collector (tree_leaves' recursive closure once
    held every leaf it walked that way, a model's worth of gradients on
    the card between steps)."""
    import gc

    tc = (ttf.TransformerConfig(**BASE) if form == "dense"
          else _shared(form)[2])
    params = ttf.init_params(0, tc, device="cpu")
    oc = ttr.OptConfig(clip_norm=1.0)
    step = ttr.make_train_step(tc, oc, with_metrics=True, device="cpu")
    opt = ttr.init_opt_state(params, oc, device="cpu")
    tok = np.random.default_rng(12).integers(0, 96, (2, 9))
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        step(params, opt, tok, tok)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
        gc.enable()
    assert held == []
