"""Port parity: the dense transformer pieces and the cached forward.

The same numpy inputs and the same weights (the JAX init_params carried
across by models/weights.params_from_jax) go through the JAX package and
kfunca_tpu_torch on the CPU.  fp32 tolerances are stated per test: the two
frameworks sum in different orders, so results agree to a few fp32 ulps
of the values involved, not bit for bit.
"""

import dataclasses
import functools

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


# -- the training forward, the losses and their gradients ---------------------

# __graft_entry__._tiny_cfg()'s fields
TINY = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
            max_seq_len=128)
MODEL_CASES = {
    # fp32: sums of 128-256 fp32 terms in another order
    "tiny_fp32": (dict(TINY, dtype="float32"), 1e-5),
    # bf16 activations: both packages round to bf16 at the same places, but
    # their fp32 sums differ in the last bits, which now and then flips a
    # bf16 rounding (2^-8 relative) somewhere upstream; logits are ~0.3
    "tiny_bf16": (dict(TINY, dtype="bfloat16"), 2e-2),
    "gqa_window": (dict(SMALL, attention_window=24), 1e-5),
    "remat": (dict(TINY, dtype="float32", remat=True), 1e-5),
    "mha_neox": (dict(TINY, dtype="float32", norm="layernorm", pos="learned",
                      mlp_type="gelu", proj_bias=True,
                      parallel_residual=True, qk_norm=True), 1e-5),
}


@functools.lru_cache(maxsize=None)
def _model(name):
    kw, tol = MODEL_CASES[name]
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(3), jc)
    rng = np.random.default_rng(9)
    if name == "gqa_window":  # an untied head, as an HF import carries
        jp["lm_head"] = jnp.asarray(
            rng.uniform(-1, 1, (jc.d_model, jc.vocab_size)) / 16, jnp.float32)
    window = rng.integers(0, jc.vocab_size, (2, 49)).astype(np.int32)
    return jc, tc, jp, window[:, :-1], window[:, 1:], tol


def _torch_value_and_grad(fn, tp, *args, **kw):
    leaves = jax.tree_util.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = fn(tp, *args, **kw)
    grads = torch.autograd.grad(loss, leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return loss.detach(), grads


def _assert_grads_close(grads, jgrads, tol):
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(grads) == len(want)
    for g, (path, w) in zip(grads, want):
        w = np.asarray(w, np.float32)
        # relative to the leaf's largest entry: small entries of a leaf are
        # sums that cancel, and carry the absolute error of the large ones
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(_np(g), w, atol=tol * scale, rtol=tol * 10,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_forward_logits(name):
    jc, tc, jp, tokens, _, tol = _model(name)
    tp = params_from_jax(jp, tc, device="cpu")
    want = np.asarray(jtf.forward(jp, jnp.asarray(tokens), jc))
    with torch.no_grad():
        got = ttf.forward(tp, torch.from_numpy(tokens), tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_loss_fn_and_gradients(name):
    jc, tc, jp, tokens, targets, tol = _model(name)
    tp = params_from_jax(jp, tc, device="cpu")
    want, jgrads = jax.value_and_grad(jtf.loss_fn)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jc)
    got, grads = _torch_value_and_grad(
        ttf.loss_fn, tp, torch.from_numpy(tokens), torch.from_numpy(targets),
        tc)
    assert float(got) == pytest.approx(float(want), abs=tol)
    _assert_grads_close(grads, jgrads, max(tol, 1e-4))


@pytest.mark.parametrize("name,chunk", [
    ("tiny_fp32", 64), ("tiny_fp32", 100), ("gqa_window", 64),
    ("tiny_bf16", 100)])
def test_loss_fn_chunked_and_gradients(name, chunk):
    """Vocab 256 in chunks of 64 and in ragged chunks of 100 (the last one
    padded with -inf columns)."""
    jc, tc, jp, tokens, targets, tol = _model(name)
    tp = params_from_jax(jp, tc, device="cpu")
    want, jgrads = jax.value_and_grad(jtf.loss_fn_chunked)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jc, chunk)
    got, grads = _torch_value_and_grad(
        ttf.loss_fn_chunked, tp, torch.from_numpy(tokens),
        torch.from_numpy(targets), tc, chunk)
    assert float(got) == pytest.approx(float(want), abs=tol)
    _assert_grads_close(grads, jgrads, max(tol, 1e-4))
    plain, _ = _torch_value_and_grad(
        ttf.loss_fn, tp, torch.from_numpy(tokens), torch.from_numpy(targets),
        tc)
    assert float(got) == pytest.approx(float(plain), abs=max(tol, 1e-5))


@pytest.mark.parametrize("loss", ["loss_fn", "loss_fn_chunked"])
def test_ignore_index(loss):
    jc, tc, jp, tokens, targets, tol = _model("tiny_fp32")
    tp = params_from_jax(jp, tc, device="cpu")
    targets = targets.copy()
    targets[0, :20] = -100
    targets[1, ::3] = -100
    extra = (32,) if loss == "loss_fn_chunked" else ()
    want, jgrads = jax.value_and_grad(getattr(jtf, loss))(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jc, *extra,
        ignore_index=-100)
    got, grads = _torch_value_and_grad(
        getattr(ttf, loss), tp, torch.from_numpy(tokens),
        torch.from_numpy(targets), tc, *extra, ignore_index=-100)
    assert float(got) == pytest.approx(float(want), abs=tol)
    _assert_grads_close(grads, jgrads, 1e-4)
    # every target ignored: the mean divides by max(count, 1)
    none = np.full_like(targets, -100)
    got = getattr(ttf, loss)(tp, torch.from_numpy(tokens),
                             torch.from_numpy(none), tc, *extra,
                             ignore_index=-100)
    assert float(got) == 0.0


def test_tied_head_gradient_sums_both_uses():
    """params["embed"] feeds the gather and, transposed, the head."""
    jc, tc, jp, tokens, targets, _ = _model("tiny_fp32")
    assert "lm_head" not in jp
    tp = params_from_jax(jp, tc, device="cpu")
    _, grads = _torch_value_and_grad(
        ttf.loss_fn, tp, torch.from_numpy(tokens), torch.from_numpy(targets),
        tc)
    leaves = jax.tree_util.tree_leaves_with_path(tp)
    (g_embed,) = [g for g, (path, _) in zip(grads, leaves)
                  if jax.tree_util.keystr(path) == "['embed']"]
    unseen = np.setdiff1d(np.arange(256), tokens)
    # rows of tokens the batch never reads still get the head's gradient
    assert len(unseen) > 50 and float(g_embed[unseen].abs().min()) > 0


def test_rope_matches_jax():
    x = np.random.default_rng(12).standard_normal((2, 3, 37, 64)).astype(
        np.float32)
    for kw in ({}, {"pos_scale": 0.25}, {"pct": 0.5}):
        want = np.asarray(jtf._rope(jnp.asarray(x), 10000.0, **kw))
        got = _np(ttf._rope(torch.from_numpy(x), 10000.0, **kw))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_chunked_softmax_xent_against_the_naive_loss():
    """As tests/test_loss.py: a non-uniform cotangent, fp32 and bf16, a
    ragged last chunk, and a negative (ignored) target."""
    from kfunca_tpu_torch.models.loss import chunked_softmax_xent

    rng = np.random.default_rng(13)
    n, d, v = 24, 32, 150
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.2).astype(np.float32)
    targets = rng.integers(0, v, n)
    cot = rng.uniform(0.5, 2.0, n).astype(np.float32)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        tt = torch.from_numpy(targets)
        nll = chunked_softmax_xent(tx, tw, tt, 64)
        assert nll.dtype == torch.float32
        gx, gw = torch.autograd.grad(nll, (tx, tw), torch.from_numpy(cot))
        logits = ttf._plain_mm(tx, tw)
        ref = -torch.log_softmax(logits, -1).gather(1, tt[:, None])[:, 0]
        rx, rw = torch.autograd.grad(ref, (tx, tw), torch.from_numpy(cot))
        np.testing.assert_allclose(_np(nll), _np(ref), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(gx), _np(rx), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(gw), _np(rw), atol=tol, rtol=tol)
    neg = chunked_softmax_xent(torch.from_numpy(x), torch.from_numpy(w),
                               torch.full((n,), -100), 64)
    lse = torch.logsumexp(torch.from_numpy(x) @ torch.from_numpy(w), -1)
    np.testing.assert_allclose(_np(neg), _np(lse), atol=1e-5, rtol=1e-5)


def test_unported_branches_raise():
    """No branch of the flagship is left to come: MoE and MLA blocks run
    (tests/test_torch_moe_mlp.py, test_torch_mla.py), and so does a block's
    "lora" entry (tests/test_torch_lora.py), which raised until the LoRA
    slice.  An empty entry leaves the forward as it was; an adapter moves
    it."""
    _, tc = _cfgs()
    tp = ttf.init_params(0, tc, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    lora = dict(tp, blocks=[dict(b, lora={}) for b in tp["blocks"]])
    assert torch.equal(ttf.forward(lora, toks, tc), ttf.forward(tp, toks, tc))
    ad = {"wqkv": {"A": torch.ones((tc.d_model, 2)),
                   "B": torch.ones((2, tc.qkv_out)), "scale": 0.5}}
    moved = dict(tp, blocks=[dict(b, lora=ad) for b in tp["blocks"]])
    assert not torch.equal(ttf.forward(moved, toks, tc),
                           ttf.forward(tp, toks, tc))
