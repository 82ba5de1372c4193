"""Port parity: LoRA (kfunca_tpu_torch/models/lora.py and the adapter hooks
of models/transformer.py and models/mla.py).

The same weights (the JAX init_params carried across by
models/weights.params_from_jax) and the same adapters (the JAX init_lora
with B drawn nonzero by numpy, carried across by weights.lora_from_jax) go
through both packages in fp32 on the CPU: the attached forward of every
target set, a MoE block's attention adapters and an MLA block's wo, the
identity at B = 0, merge_lora and to_serving, and three steps of
make_lora_train_step.  Losses are held within 1e-5, logits, gradients and
updated adapters within 1e-4 of max(1, max |ref|) a tensor.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import lora as jlora
from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.utils.errors import KfError as JaxKfError
from kfunca_tpu_torch.models import lora as tlora
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import (
    lora_from_jax, params_from_jax, tree_to_numpy)
from kfunca_tpu_torch.utils.errors import KfError

DENSE = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=96, max_seq_len=32, dtype="float32")
MOE = dict(DENSE, n_experts=4, moe_top_k=2, d_ff=48)
MLA = dict(DENSE, n_kv_heads=None, attention="mla", kv_lora_rank=16,
           qk_nope_head_dim=8, qk_rope_head_dim=8)
ALL = ("wqkv", "wo", "w_gate", "w_up", "w_down")
LOSS_TOL = 1e-5
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _model(cfg_items, seed=0):
    kw = dict(cfg_items)
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jc)
    return jc, jp, tc, params_from_jax(jp, tc, device="cpu")


def _jax_adapters(jc, targets, rank=4, alpha=8.0, seed=1, b_std=0.1):
    """The JAX init_lora with B drawn nonzero from numpy (B = 0 makes every
    delta vanish, which would hide a wrong hook)."""
    ad = jlora.init_lora(jax.random.PRNGKey(seed), jc, rank=rank,
                         targets=targets, alpha=alpha)
    rng = np.random.default_rng(seed)
    for blk in ad["blocks"]:
        for ab in blk.values():
            if b_std:
                ab["B"] = jnp.asarray(rng.normal(0, b_std, ab["B"].shape),
                                      jnp.float32)
    return ad


_jforward = jax.jit(jtf.forward, static_argnums=2)


def _batch(vocab, batch=2, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
    return w[:, :-1], w[:, 1:]


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _trees_close(got, want, tol=TOL):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        _close(g, w, tol)


TARGETS = {"wqkv": ("wqkv",), "attention": ("wqkv", "wo"),
           "mlp": ("w_gate", "w_up", "w_down"), "all": ALL}
CFGS = {"dense": DENSE, "geglu": dict(DENSE, mlp_type="geglu"),
        "moe": MOE, "mla": MLA}


@pytest.mark.parametrize("case", ["dense-wqkv", "dense-attention",
                                  "dense-mlp", "dense-all", "geglu-all",
                                  "moe-attention", "mla-wo"])
def test_attached_forward_matches_jax(case):
    """forward over attach_lora(params, adapters): the JAX logits."""
    cname, tname = case.split("-")
    targets = ("wo",) if tname == "wo" else TARGETS[tname]
    jc, jp, tc, tp = _model(tuple(sorted(CFGS[cname].items())))
    jad = _jax_adapters(jc, targets)
    tad = lora_from_jax(jad, device="cpu")
    tokens, _ = _batch(tc.vocab_size)
    want = _jforward(jlora.attach_lora(jp, jad), jnp.asarray(tokens), jc)
    got = ttf.forward(tlora.attach_lora(tp, tad), torch.as_tensor(tokens),
                      tc)
    _close(got, want)
    base = ttf.forward(tp, torch.as_tensor(tokens), tc)
    assert float((got - base).abs().max()) > 1e-3  # the deltas are real


@pytest.mark.parametrize("cname", ["dense", "mla"])
def test_zero_b_is_the_base_model(cname):
    """init_lora's B = 0: the attached forward is the base forward bit for
    bit, and the JAX scale rule (alpha / rank, 1.0 without alpha)."""
    _, _, tc, tp = _model(tuple(sorted(CFGS[cname].items())))
    gen = torch.Generator().manual_seed(0)
    targets = ("wo",) if cname == "mla" else ALL
    ad = tlora.init_lora(gen, tc, rank=4, targets=targets)
    assert ad["scale"] == 1.0
    assert tlora.init_lora(gen, tc, rank=4, alpha=8.0)["scale"] == 2.0
    blk = ad["blocks"][0]
    assert sorted(blk) == sorted(targets)
    for t in targets:
        d_in, d_out = tlora._TARGET_DIMS[t](tc)
        assert blk[t]["A"].shape == (d_in, 4)
        assert torch.equal(blk[t]["B"], torch.zeros(4, d_out))
    tokens, _ = _batch(tc.vocab_size)
    got = ttf.forward(tlora.attach_lora(tp, ad), torch.as_tensor(tokens), tc)
    assert torch.equal(got, ttf.forward(tp, torch.as_tensor(tokens), tc))


def test_init_lora_refuses_what_jax_refuses():
    """An unknown target (a check failure) and MLP targets on a MoE config
    (NotImplementedError), in both packages."""
    jc, _, tc, _ = _model(tuple(sorted(MOE.items())))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        jlora.init_lora(jax.random.PRNGKey(0), jc, targets=("w_up",))
    with pytest.raises(NotImplementedError, match="MoE"):
        tlora.init_lora(gen, tc, targets=("w_up",))
    with pytest.raises(JaxKfError):
        jlora.init_lora(jax.random.PRNGKey(0), jc, targets=("w_q",))
    with pytest.raises(KfError, match="unknown LoRA target"):
        tlora.init_lora(gen, tc, targets=("w_q",))


@pytest.mark.parametrize("tname", ["wqkv", "all"])
def test_merge_lora_matches_jax_and_the_attached_forward(tname):
    jc, jp, tc, tp = _model(tuple(sorted(DENSE.items())))
    jad = _jax_adapters(jc, TARGETS[tname])
    tad = lora_from_jax(jad, device="cpu")
    merged = tlora.merge_lora(tp, tad)
    _trees_close(tree_to_numpy(merged), jlora.merge_lora(jp, jad), 1e-6)
    tokens = torch.as_tensor(_batch(tc.vocab_size)[0])
    _close(ttf.forward(merged, tokens, tc),
           ttf.forward(tlora.attach_lora(tp, tad), tokens, tc).numpy())
    assert tp["blocks"][0]["wqkv"] is not merged["blocks"][0]["wqkv"]


def test_to_serving_matches_jax_and_refuses_alike():
    jc, _, tc, _ = _model(tuple(sorted(DENSE.items())))
    jad = _jax_adapters(jc, ("wqkv",))
    got = tlora.to_serving(lora_from_jax(jad, device="cpu"))
    want = jlora.to_serving(jad)
    assert len(got) == len(want) == tc.n_layers
    for g, w in zip(got, want):
        _close(g["A"], w["A"], 0)
        _close(g["B"], w["B"], 1e-7)
    both = lora_from_jax(_jax_adapters(jc, ("wqkv", "wo")), device="cpu")
    with pytest.raises(NotImplementedError, match="wqkv-only"):
        tlora.to_serving(both)
    with pytest.raises(NotImplementedError):
        jlora.to_serving(_jax_adapters(jc, ("wqkv", "wo")))
    with pytest.raises(KfError, match="wqkv"):
        tlora.to_serving(lora_from_jax(_jax_adapters(jc, ("wo",)),
                                       device="cpu"))


STEPS = {"dense-all": (DENSE, ALL, {}),
         "dense-wqkv-chunked": (DENSE, ("wqkv",),
                                dict(loss_chunk=48, ignore_index=-100)),
         "moe-attention": (MOE, ("wqkv", "wo"), {}),
         "mla-wo": (MLA, ("wo",), {})}


@pytest.mark.parametrize("case", list(STEPS))
def test_lora_train_step_matches_jax(case):
    """Three AdamW steps of make_lora_train_step from the same adapters and
    optimizer state: the JAX losses, adapters and moments; the base params
    get no gradient and do not move."""
    cfg, targets, kw = STEPS[case]
    jc, jp, tc, tp = _model(tuple(sorted(cfg.items())))
    oc = dict(lr=1e-2, weight_decay=0.0)
    jad = _jax_adapters(jc, targets, b_std=0.05)
    tad = lora_from_jax(jad, device="cpu")
    jst = jtr.init_opt_state(jad["blocks"], jtr.OptConfig(**oc))
    tst = ttr.init_opt_state(tad["blocks"], ttr.OptConfig(**oc),
                             device="cpu")
    jstep = jax.jit(jlora.make_lora_train_step(jp, jc, jtr.OptConfig(**oc),
                                               **kw))
    tstep = tlora.make_lora_train_step(tp, tc, ttr.OptConfig(**oc),
                                       device="cpu", **kw)
    before = [t.copy() for t in jax.tree_util.tree_leaves(
        tree_to_numpy(tp))]
    for i in range(3):
        tokens, targets_ = _batch(tc.vocab_size, seed=i)
        if kw.get("ignore_index") is not None:
            targets_ = targets_.copy()
            targets_[:, :4] = -100
        jad, jst, jl = jstep(jad, jst, jnp.asarray(tokens),
                             jnp.asarray(targets_))
        tad, tst, tl = tstep(tad, tst, tokens, targets_)
        np.testing.assert_allclose(float(tl), float(jl), atol=LOSS_TOL,
                                   rtol=0)
    _trees_close(tree_to_numpy(tad["blocks"]), jad["blocks"])
    _trees_close(tree_to_numpy(tst), jst)
    assert tad["scale"] == float(jad["scale"])
    after = jax.tree_util.tree_leaves(tree_to_numpy(tp))
    assert all(np.array_equal(a, b) for a, b in zip(after, before))
    assert all(t.grad is None for t in jax.tree_util.tree_leaves(tp))


def test_lora_gradients_match_jax():
    """The adapter gradients of the attached loss, all five targets."""
    jc, jp, tc, tp = _model(tuple(sorted(DENSE.items())))
    jad = _jax_adapters(jc, ALL)
    tad = lora_from_jax(jad, device="cpu")
    tokens, targets = _batch(tc.vocab_size)

    def jloss(blocks):
        p = jlora.attach_lora(jp, {"blocks": blocks, "scale": jad["scale"]})
        return jtf.loss_fn(p, jnp.asarray(tokens), jnp.asarray(targets), jc)

    want_l, want_g = jax.jit(jax.value_and_grad(jloss))(jad["blocks"])

    def tloss(blocks, tok, tgt):
        p = tlora.attach_lora(tp, {"blocks": blocks, "scale": tad["scale"]})
        return ttf.loss_fn(p, tok, tgt, tc)

    got_l, got_g = ttr._value_and_grad(tloss, tad["blocks"],
                                       torch.as_tensor(tokens),
                                       torch.as_tensor(targets))
    np.testing.assert_allclose(float(got_l), float(want_l), atol=LOSS_TOL)
    _trees_close(tree_to_numpy(got_g), want_g)


def test_lora_from_jax_takes_a_step_output():
    """A jitted JAX step returns the scale as an array: lora_from_jax reads
    it as a float, A and B as fp32 tensors on the device asked for."""
    jc, _, _, _ = _model(tuple(sorted(DENSE.items())))
    jad = _jax_adapters(jc, ("wqkv",), alpha=2.0)
    jad = {"blocks": jad["blocks"], "scale": jnp.float32(jad["scale"])}
    tad = lora_from_jax(jad, device="cpu")
    assert isinstance(tad["scale"], float) and tad["scale"] == 0.5
    a = tad["blocks"][1]["wqkv"]["A"]
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    _close(a, jad["blocks"][1]["wqkv"]["A"], 0)
