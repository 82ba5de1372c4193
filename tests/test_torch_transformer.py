"""Port parity: the dense transformer pieces and the cached forward.

The same numpy inputs and the same weights (the JAX init_params carried
across by models/weights.params_from_jax) go through the JAX package and
kfunca_tpu_torch on the CPU.  fp32 tolerances are stated per test: the two
frameworks sum in different orders, so results agree to a few fp32 ulps
of the values involved, not bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import generate as jgen
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import generate as tgen
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax, params_to_numpy

SMALL = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=512, max_seq_len=256, dtype="float32")


def _cfgs(**kw):
    return (jtf.TransformerConfig(**{**SMALL, **kw}),
            ttf.TransformerConfig(**{**SMALL, **kw}))


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def shared_params():
    jc, tc = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    return jp, params_from_jax(jp, tc, device="cpu")


def test_config_mirrors_jax_fields():
    jf = [(f.name, f.default) for f in dataclasses.fields(jtf.TransformerConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ttf.TransformerConfig)]
    assert tf == jf
    for kw in ({}, {"rope_scaling": 4.0}, {"rope_scaling": 2.0,
                                           "rope_scaling_type": "ntk"}):
        jc, tc = _cfgs(**kw)
        assert (tc.kv_heads, tc.head_dim, tc.qkv_out) == (
            jc.kv_heads, jc.head_dim, jc.qkv_out)
        assert tc.rope_params() == pytest.approx(jc.rope_params(), rel=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    jd = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    td = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = np.asarray(jtf.rms_norm(jnp.asarray(x, jd), jnp.asarray(g), 1e-5),
                      np.float32)
    got = _np(ttf.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(g),
                           1e-5))
    # fp32: a few ulps of |x|/rms ~ 3.  bf16: both round the same fp32
    # product twice to bf16; a hair's difference can flip one rounding
    # (one bf16 step, 2^-8 relative)
    tol = 2e-6 * 4 if dtype is np.float32 else 2.0 ** -7
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_layer_norm_and_offset_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    for norm in ("layernorm", "rms_offset"):
        jc, tc = _cfgs(norm=norm, d_model=32, n_heads=2, n_kv_heads=2)
        p = {"n": g, "n_b": b}
        want = np.asarray(jtf.apply_norm(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, "n",
            jc))
        got = _np(ttf.apply_norm(
            torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
            "n", tc))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw", [
    {}, {"rope_scaling": 4.0}, {"rope_scaling": 2.0, "rope_scaling_type": "ntk"},
    {"rope_pct": 0.25},
])
def test_rope_at(kw):
    jc, tc = _cfgs(**kw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 5, 64)).astype(np.float32)
    theta, pscale = jc.rope_params()
    pos = np.asarray([0, 3, 17, 200, 255], np.int32)
    want = np.asarray(jgen._rope_at(jnp.asarray(x), jnp.asarray(pos), theta,
                                    pscale, jc.rope_pct))
    got = _np(tgen._rope_at(torch.from_numpy(x), torch.from_numpy(pos),
                            theta, pscale, tc.rope_pct))
    # angles up to 255 rad: the two libraries' sin/cos differ by ~1 ulp of
    # the angle, ~3e-5 on a unit value
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    # per-sequence positions (B, T), the decode step's form: each row of
    # the batch at its own positions, as the JAX engine's vmap
    bpos = np.asarray([[7], [130]], np.int32)
    xb = x[:, :, :1]
    got = _np(tgen._rope_at(torch.from_numpy(xb), torch.from_numpy(bpos),
                            theta, pscale, tc.rope_pct))
    for b in range(2):
        want = np.asarray(jgen._rope_at(
            jnp.asarray(xb[b:b + 1]), jnp.asarray(bpos[b]), theta, pscale,
            jc.rope_pct))
        np.testing.assert_allclose(got[b:b + 1], want, atol=5e-5, rtol=0)


def test_split_qkv_exact():
    jc, tc = _cfgs()
    qkv = np.random.default_rng(3).standard_normal(
        (2, 3, jc.qkv_out)).astype(np.float32)
    for w, g in zip(jtf.split_qkv(jnp.asarray(qkv), jc),
                    ttf.split_qkv(torch.from_numpy(qkv), tc)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("mlp_type,bias", [("swiglu", False),
                                           ("geglu", False), ("gelu", True)])
def test_dense_mlp(mlp_type, bias):
    jc, tc = _cfgs(mlp_type=mlp_type, proj_bias=bias)
    jp = jtf.init_params(jax.random.PRNGKey(4), jc)["blocks"][0]
    if bias:  # nonzero biases, so adding them is tested
        rng = np.random.default_rng(4)
        jp = {**jp, "b_fc": jnp.asarray(rng.standard_normal(jc.d_ff),
                                        jnp.float32),
              "b_proj": jnp.asarray(rng.standard_normal(jc.d_model),
                                    jnp.float32)}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    y = np.random.default_rng(5).standard_normal((2, 3, 256)).astype(
        np.float32)
    want = np.asarray(jtf.mlp(jnp.asarray(y), jp, jc))
    got = _np(ttf.mlp(torch.from_numpy(y), tp, tc))
    # fp32 sums of 256 and 512 terms of magnitude ~1
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_bf16_matmul_keeps_fp32_result(shared_params):
    """bf16 activations: the product of a bf16 pair is summed and returned
    in fp32 (jnp.dot(..., preferred_element_type=float32)); gate/up reach
    silu unrounded."""
    jp, tp = shared_params
    y = np.random.default_rng(6).standard_normal((4, 256)).astype(np.float32)
    w = jp["blocks"][0]["w_gate"]
    want = np.asarray(jtf._plain_mm(jnp.asarray(y, jnp.bfloat16), w))
    got = ttf._plain_mm(torch.from_numpy(y).bfloat16(), tp["blocks"][0]["w_gate"])
    assert got.dtype == torch.float32
    # identical bf16 inputs, exact products; only the fp32 summation order
    # of 256 terms differs
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 12])
def test_forward_with_cache_logits(window):
    """Prefill 20 tokens, then 5 more at start_pos 20, from one cache:
    logits and the cache match the JAX package."""
    jc, tc = _cfgs(attention_window=window)
    jp = jtf.init_params(jax.random.PRNGKey(7), jc)
    tp = params_from_jax(jp, tc, device="cpu")
    toks = np.random.default_rng(8).integers(0, 256, (2, 25)).astype(np.int32)
    jcache = jgen.init_kv_cache(jc, 2, 32)
    tcache = tgen.init_kv_cache(tc, 2, 32, device="cpu")
    for s0, s1 in ((0, 20), (20, 25)):
        jl, jcache = jgen.forward_with_cache(
            jp, jnp.asarray(toks[:, s0:s1]), jcache, jnp.int32(s0), jc)
        tl, tcache = tgen.forward_with_cache(
            tp, torch.from_numpy(toks[:, s0:s1]).long(), tcache, s0, tc)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        # two fp32 layers of sums over 256-512 terms; logits ~ 0.1
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    for jlc, tlc in zip(jcache, tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tlc[name]), np.asarray(jlc[name]),
                                       atol=1e-4, rtol=1e-4)


def test_cache_overrun_raises(shared_params):
    _, tp = shared_params
    _, tc = _cfgs()
    cache = tgen.init_kv_cache(tc, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="overrun"):
        tgen.forward_with_cache(tp, torch.zeros((1, 9), dtype=torch.long),
                                cache, 0, tc)


def test_init_params_layout_matches_jax():
    for kw in ({}, {"mlp_type": "gelu", "proj_bias": True},
               {"norm": "layernorm", "qk_norm": True, "pos": "learned"}):
        jc, tc = _cfgs(**kw)
        jp = jtf.init_params(jax.random.PRNGKey(0), jc)
        tp = ttf.init_params(0, tc, device="cpu")
        jl, jtree = jax.tree_util.tree_flatten_with_path(jp)
        tl, ttree = jax.tree_util.tree_flatten_with_path(tp)
        assert [k for k, _ in jl] == [k for k, _ in tl], kw
        for (path, a), (_, b) in zip(jl, tl):
            assert tuple(b.shape) == a.shape and b.dtype == torch.float32
    # the same distributions: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) matrices,
    # N(0, 0.02^2) embedding, unit norm gains
    tp = ttf.init_params(0, ttf.TransformerConfig(**SMALL), device="cpu")
    w = tp["blocks"][0]["w_up"]
    assert float(w.abs().max()) <= 1 / 16 and float(w.std()) == pytest.approx(
        1 / 16 / 3 ** 0.5, rel=0.02)
    assert float(tp["embed"].std()) == pytest.approx(0.02, rel=0.02)
    assert torch.equal(tp["final_norm"], torch.ones(256))
    again = ttf.init_params(0, ttf.TransformerConfig(**SMALL), device="cpu")
    assert torch.equal(again["blocks"][1]["wqkv"], tp["blocks"][1]["wqkv"])


def test_weights_round_trip_exact():
    jc, tc = _cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(11), jc)
    jp["lm_head"] = jnp.asarray(np.random.default_rng(0).standard_normal(
        (256, 256)), jnp.bfloat16)
    tp = params_from_jax(jp, tc, device="cpu")
    assert tp["lm_head"].dtype == torch.bfloat16
    back = params_to_numpy(tp)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    bl = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in jl] == [k for k, _ in bl]
    for (_, a), (_, b) in zip(jl, bl):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))
    # a recast copy, and a tree that does not fit the config
    half = params_from_jax(jp, tc, device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16
               for t in jax.tree_util.tree_leaves(half))
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax({**jp, "blocks": jp["blocks"][:1]}, tc, device="cpu")
    with pytest.raises(ValueError, match="wqkv"):
        params_from_jax(jp, dataclasses.replace(tc, n_kv_heads=4),
                        device="cpu")
