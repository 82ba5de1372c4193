"""Port parity: multi-head latent attention (models/mla.py) and its caches.

The same numpy inputs and the same weights (the JAX init_params carried
across by models/weights.params_from_jax) go through kfunca_tpu's
models/mla.py and the port's in fp32 on the CPU: the expanded form with a
direct and a low-rank query, both rope conventions, equal head dims (the
flash path: the kernels' plain version here) and unequal ones (the einsum
oracle); the absorbed cached form (prefill against the full forward,
incremental against prefill), the per-slot form, generate, and the
tensor-parallel step.  fp32 sums run in other orders on the two sides:
1e-5 of max(1, max |ref|) a tensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import generate as jgen
from kfunca_tpu.models import mla as jmla
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import generate as tgen
from kfunca_tpu_torch.models import mla as tmla
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.utils.tree import tree_leaves

BASE = dict(vocab_size=96, d_model=64, n_heads=4, n_layers=2, d_ff=96,
            max_seq_len=64, dtype="float32", attention="mla", kv_lora_rank=16)
# (q_lora_rank, rope_interleave, equal head dims)
GEOMETRIES = {
    "direct_q_half_equal": (0, False, True),
    "direct_q_interleave_equal": (0, True, True),
    "lowrank_q_half_equal": (24, False, True),
    "lowrank_q_interleave_equal": (24, True, True),
    "direct_q_half_unequal": (0, False, False),
    "direct_q_interleave_unequal": (0, True, False),
    "lowrank_q_half_unequal": (24, False, False),
    "lowrank_q_interleave_unequal": (24, True, False),
}
DEEPSEEK_MOE = dict(n_experts=8, moe_top_k=2, moe_score="sigmoid",
                    moe_score_bias=True, moe_n_group=4, moe_topk_group=2,
                    moe_routed_scale=2.5, n_shared_experts=1, moe_d_ff=32,
                    moe_first_dense=1)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _kw(name, **more):
    q_rank, inter, equal = GEOMETRIES[name]
    heads = (dict(qk_nope_head_dim=8, qk_rope_head_dim=8) if equal else
             dict(qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16))
    return {**BASE, "q_lora_rank": q_rank, "rope_interleave": inter, **heads,
            **more}


_CACHE = {}


def _shared(name, **more):
    key = (name, tuple(sorted(more.items())))
    if key not in _CACHE:
        kw = _kw(name, **more)
        jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
        jp = jtf.init_params(jax.random.PRNGKey(len(_CACHE)), jc)
        rng = np.random.default_rng(1)
        for blk in jp["blocks"]:  # random gains, a live selection bias
            for k in ("q_norm", "kv_norm", "router_bias"):
                if k in blk:
                    blk[k] = jnp.asarray(rng.uniform(
                        -0.1 if k == "router_bias" else 0.5, 0.1
                        if k == "router_bias" else 1.5, blk[k].shape),
                        jnp.float32)
        _CACHE[key] = (jc, jp, tc, params_from_jax(jp, tc, device="cpu"))
    return _CACHE[key]


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _y(seed=3, shape=(2, 9, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_mla_attention_and_gradients_match_jax(name):
    """mla_attention's output and its input and weight gradients under a
    random cotangent; equal head dims take causal_attention_fn (K1/K2's
    plain version here), unequal ones _sdpa_xla."""
    jc, jp, tc, tp = _shared(name)
    blk_j = {k: v for k, v in jp["blocks"][0].items()
             if k not in ("w_gate", "w_up", "w_down", "attn_norm",
                          "mlp_norm")}
    blk_t = {k: tp["blocks"][0][k] for k in blk_j}
    y = _y()
    g = np.random.default_rng(4).standard_normal(y.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda yy, pp: jmla.mla_attention(yy, pp, jc),
                         jnp.asarray(y), blk_j)
    dy_j, dp_j = vjp(jnp.asarray(g))
    leaves = tree_leaves(blk_t)
    for leaf in leaves:
        leaf.requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    out = tmla.mla_attention(yt, blk_t, tc)
    grads = torch.autograd.grad(out, [yt] + leaves, torch.from_numpy(g))
    for leaf in leaves:
        leaf.requires_grad_(False)
    _close(out, out_j, what="out")
    _close(grads[0], dy_j, what="dy")
    for got, want in zip(grads[1:], jax.tree_util.tree_leaves(dp_j)):
        _close(got, want, what="dw")


def test_equal_head_dims_take_the_flash_path(monkeypatch):
    """causal_attention_fn runs exactly where qk == v (the kernels' contract),
    the oracle elsewhere."""
    calls = []
    real = tmla.causal_attention_fn
    monkeypatch.setattr(tmla, "causal_attention_fn",
                        lambda *a: calls.append(1) or real(*a))
    y = torch.from_numpy(_y())
    for name, want in (("lowrank_q_half_equal", 1),
                       ("lowrank_q_half_unequal", 0)):
        _, _, tc, tp = _shared(name)
        calls.clear()
        tmla.mla_attention(y, tp["blocks"][0], tc)
        assert len(calls) == want, name


@pytest.mark.parametrize("interleave", [False, True])
def test_pe_rope_matches_jax(interleave):
    cfg_kw = dict(_kw("direct_q_half_equal"), rope_interleave=interleave,
                  rope_theta=500.0)
    jc, tc = jtf.TransformerConfig(**cfg_kw), ttf.TransformerConfig(**cfg_kw)
    x = _y(5, (2, 3, 6, 8))
    pos = np.array([3, 7, 1, 0, 11, 5])
    _close(tmla._pe_rope(torch.from_numpy(x), tc),
           jmla._pe_rope(jnp.asarray(x), jc))
    _close(tmla._pe_rope(torch.from_numpy(x), tc, torch.from_numpy(pos)),
           jmla._pe_rope(jnp.asarray(x), jc, jnp.asarray(pos)))


@pytest.mark.parametrize("name,moe", [("lowrank_q_interleave_unequal", True),
                                      ("direct_q_half_equal", False)])
def test_prefill_and_incremental_decode_match_jax(name, moe):
    """forward_with_cache: the prefill's logits against JAX's and against
    the full forward, then two single-token steps against JAX's and against
    the full forward at their positions; the latent caches equal JAX's."""
    jc, jp, tc, tp = _shared(name, **(DEEPSEEK_MOE if moe else {}))
    toks = np.random.default_rng(6).integers(0, 96, (2, 11))
    full_j = np.asarray(jtf.forward(jp, jnp.asarray(toks, jnp.int32), jc))
    _close(ttf.forward(tp, torch.from_numpy(toks), tc), full_j)
    jcache = jgen.init_kv_cache(jc, 2, 16)
    tcache = tgen.init_kv_cache(tc, 2, 16, device="cpu")
    assert sorted(tcache[0]) == ["ckv", "kpe"]
    jl, jcache = jgen.forward_with_cache(
        jp, jnp.asarray(toks[:, :9], jnp.int32), jcache, jnp.int32(0), jc)
    tl, tcache = tgen.forward_with_cache(tp, torch.from_numpy(toks[:, :9]),
                                         tcache, 0, tc)
    _close(tl, jl)
    _close(tl, full_j[:, :9])
    for pos in (9, 10):
        jl, jcache = jgen.forward_with_cache(
            jp, jnp.asarray(toks[:, pos:pos + 1], jnp.int32), jcache,
            jnp.int32(pos), jc)
        tl, tcache = tgen.forward_with_cache(
            tp, torch.from_numpy(toks[:, pos:pos + 1]), tcache, pos, tc)
        _close(tl, jl)
        _close(tl[:, 0], full_j[:, pos])
    for a, b in zip(tcache, jcache):
        for k in ("ckv", "kpe"):
            _close(a[k], b[k])


@pytest.mark.parametrize("name", ["lowrank_q_interleave_unequal",
                                  "direct_q_half_equal"])
def test_perslot_decode_matches_jax(name):
    """mla_attend_cached_perslot over filled caches at per-slot positions,
    one of them past the cache (clamped to max_len - 1)."""
    jc, jp, tc, tp = _shared(name)
    rng = np.random.default_rng(7)
    ckv = rng.standard_normal((3, 12, 16)).astype(np.float32)
    kpe = rng.standard_normal((3, 12, 8)).astype(np.float32)
    pos = np.array([4, 11, 20])
    y = _y(8, (3, 1, 64))
    blk_j = jp["blocks"][0]
    oj, cj = jmla.mla_attend_cached_perslot(
        jnp.asarray(y), blk_j, {"ckv": jnp.asarray(ckv),
                                "kpe": jnp.asarray(kpe)},
        jnp.asarray(pos, jnp.int32), jc)
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "kpe": torch.from_numpy(kpe.copy())}
    ot, ct = tmla.mla_attend_cached_perslot(
        torch.from_numpy(y), tp["blocks"][0], cache, torch.from_numpy(pos),
        tc)
    _close(ot, oj)
    assert ct is cache
    for k in ("ckv", "kpe"):
        _close(ct[k], cj[k])


@pytest.mark.parametrize("name,moe", [("lowrank_q_interleave_unequal", True),
                                      ("direct_q_interleave_equal", False)])
def test_generate_matches_jax_greedy(name, moe):
    jc, jp, tc, tp = _shared(name, **(DEEPSEEK_MOE if moe else {}))
    tp = dict(tp, embed=tp["embed"] * 40)  # logits wide apart: no near ties
    jp = dict(jp, embed=jp["embed"] * 40)
    prompt = np.random.default_rng(9).integers(0, 96, (2, 5))
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt, jnp.int32), jc,
                                    max_new=6))
    got = tgen.generate(tp, torch.from_numpy(prompt), tc, max_new=6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got.numpy().ravel().tolist())) > 1  # not one token


def test_bf16_cache_is_stored_in_the_activation_dtype():
    _, _, tc, _ = _shared("lowrank_q_half_unequal")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    cache = tmla.init_mla_cache(tc, 3, 10, device="cpu")
    assert len(cache) == tc.n_layers
    assert cache[0]["ckv"].shape == (3, 10, 16)
    assert cache[0]["kpe"].shape == (3, 10, 8)
    assert cache[0]["ckv"].dtype == torch.bfloat16


def test_cache_overrun_raises():
    _, _, tc, tp = _shared("direct_q_half_equal")
    cache = tgen.init_kv_cache(tc, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="overrun"):
        tgen.forward_with_cache(tp, torch.zeros((1, 5), dtype=torch.long),
                                cache, 0, tc)


def test_mla_train_step_loss_and_gradients_match_jax():
    """make_train_step over an MLA + DeepSeek-MoE stack: the loss and every
    gradient (one SGD step's params) against jax.value_and_grad."""
    jc, jp, tc, _ = _shared("lowrank_q_interleave_unequal", **DEEPSEEK_MOE)
    w = np.random.default_rng(10).integers(0, 96, (2, 13))
    tok, tgt = w[:, :-1], w[:, 1:]
    loss_j, g_j = jax.value_and_grad(jtf.loss_fn)(
        jp, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32), jc)
    tp = params_from_jax(jp, tc, device="cpu")
    oc = ttr.OptConfig(algo="sgd", lr=0.5, weight_decay=0.0)
    step = ttr.make_train_step(tc, oc, device="cpu")
    tp, _, loss = step(tp, ttr.init_opt_state(tp, oc, device="cpu"), tok, tgt)
    assert abs(float(loss) - float(loss_j)) <= 1e-5
    for got, p0, gj in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                           jax.tree_util.tree_leaves(g_j)):
        _close((np.asarray(p0) - got.numpy()) / 0.5, gj, tol=1e-4)


@pytest.mark.parametrize("name,fsdp,accum", [
    ("lowrank_q_interleave_unequal", False, 1),
    ("lowrank_q_interleave_unequal", True, 2),
    ("direct_q_half_equal", False, 1)])
def test_sharded_mla_step_matches_the_unsharded_step(name, fsdp, accum):
    """dp 2 x tp 2: the latent on every rank, each rank's two heads (w_q /
    w_uq, w_uk, w_uv by whole heads), wo row-parallel; the loss to 1e-5
    and the params after one SGD step to 1e-5 of each leaf's largest
    entry."""
    jc, jp, tc, _ = _shared(name, **DEEPSEEK_MOE)
    w = np.random.default_rng(11).integers(0, 96, (4, 13))
    tok, tgt = w[:, :-1], w[:, 1:]
    oc = ttr.OptConfig(algo="sgd", lr=1e-2)
    ref = params_from_jax(jp, tc, device="cpu")
    step = ttr.make_train_step(tc, oc, grad_accum=accum, device="cpu")
    ref, _, loss = step(ref, ttr.init_opt_state(ref, oc, device="cpu"), tok,
                        tgt)
    mesh = tmesh.LocalMesh(2, 2, "cpu")
    sp = tmesh.shard_params(params_from_jax(jp, tc, device="cpu"), mesh,
                            fsdp=fsdp, cfg=tc)
    assert sp.attn_split
    sstep = ttr.make_sharded_train_step(tc, mesh, oc, fsdp=fsdp,
                                        grad_accum=accum)
    sp, _, sloss = sstep(sp, [ttr.init_opt_state(t, oc, device="cpu")
                              for t in sp.local], tok, tgt)
    assert abs(float(loss) - float(sloss)) <= 1e-5
    for a, b in zip(tree_leaves(tmesh.gather_params(sp)), tree_leaves(ref)):
        _close(a, b.numpy())


def test_mla_heads_split_by_whole_heads_or_replicate():
    """tp 2 of 4 heads: each rank holds two heads' columns of w_uk and
    w_uv and two heads' rows of wo, the latent weights whole; tp 8 does
    not divide the heads, so attention is replicated."""
    _, _, tc, tp = _shared("direct_q_half_equal")
    sp = tmesh.shard_params(tp, tmesh.LocalMesh(1, 2, "cpu"), cfg=tc)
    blk = sp.local[1]["blocks"][0]
    assert torch.equal(blk["w_uk"], tp["blocks"][0]["w_uk"][:, 16:])
    assert torch.equal(blk["w_q"], tp["blocks"][0]["w_q"][:, 32:])
    assert torch.equal(blk["wo"], tp["blocks"][0]["wo"][32:])
    assert torch.equal(blk["w_dkv"], tp["blocks"][0]["w_dkv"])
    cfg8 = dataclasses.replace(tc, d_model=64, n_heads=4)
    sp8 = tmesh.shard_params(tp, tmesh.LocalMesh(1, 8, "cpu"), cfg=cfg8)
    assert not sp8.attn_split
    assert torch.equal(sp8.local[3]["blocks"][0]["w_uk"],
                       tp["blocks"][0]["w_uk"])
