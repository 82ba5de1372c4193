"""Port parity: QLoRA (models/lora.quantize_base and the dequantizing
product of models/transformer._plain_mm).

The JAX quantize_base tree of the same weights is carried across by
models/weights.decode_params_from_jax (int4 widened to int8, then packed)
and must equal the port's own quantize_base; the adapted forward and two
LoRA steps over int8 and int4 bases (dense, and a MoE block whose routed
experts are quantized) then match the JAX package's in fp32 on the CPU:
losses within 1e-5, logits and adapters within 1e-4 of max(1, max |ref|).
The backward of a quantized product keeps the (intN, scale) pair and no
dequantized weight (saved-tensor hooks).
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
from kfunca_tpu_torch.models import lora as tlora
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import (
    decode_params_from_jax, lora_from_jax, params_from_jax, tree_to_numpy)

DENSE = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=96, max_seq_len=32, dtype="float32")
MOE = dict(DENSE, n_experts=4, moe_top_k=2, d_ff=48)
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


@functools.lru_cache(maxsize=None)
def _bases(cfg_items, bits):
    """(JAX quantize_base tree, the port's carried copy, the port's own)."""
    jc, jp, tc, tp = _model(cfg_items)
    jq = jlora.quantize_base(jp, bits)  # eager: jit may round otherwise
    widened = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.int8) if x.dtype == jnp.int4 else x, jq)
    return jq, decode_params_from_jax(widened, device="cpu"), \
        tlora.quantize_base(tp, bits)


def _adapters(jc, targets, seed=1):
    ad = jlora.init_lora(jax.random.PRNGKey(seed), jc, rank=4,
                         targets=targets, alpha=8.0)
    rng = np.random.default_rng(seed)
    for blk in ad["blocks"]:
        for ab in blk.values():
            ab["B"] = jnp.asarray(rng.normal(0, 0.05, ab["B"].shape),
                                  jnp.float32)
    return ad


def _batch(vocab, seed=0):
    w = np.random.default_rng(seed).integers(0, vocab, (2, 17)).astype(
        np.int32)
    return w[:, :-1], w[:, 1:]


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


CASES = {"dense-int8": (DENSE, 8), "dense-int4": (DENSE, 4),
         "moe-int8": (MOE, 8), "moe-int4": (MOE, 4)}


@pytest.mark.parametrize("case", list(CASES))
def test_quantize_base_equals_the_carried_jax_tree(case):
    """The port's quantize_base is the JAX one bit for bit: the same
    matrices quantized (experts too), the same integers and scales, the
    rest left as it was."""
    cfg, bits = CASES[case]
    _, _, tc, tp = _model(tuple(sorted(cfg.items())))
    _, carried, own = _bases(tuple(sorted(cfg.items())), bits)
    for blk_c, blk_o, blk_p in zip(carried["blocks"], own["blocks"],
                                   tp["blocks"]):
        assert sorted(blk_c) == sorted(blk_o)
        for key in blk_o:
            if key in tlora._QUANTIZED:
                assert isinstance(blk_o[key], tuple)
                assert blk_o[key][0].dtype == (torch.int8 if bits == 8
                                               else torch.uint8)
        leaves_c = jax.tree_util.tree_leaves(blk_c)
        leaves_o = jax.tree_util.tree_leaves(blk_o)
        assert all(torch.equal(a, b) for a, b in zip(leaves_c, leaves_o))
        if "experts" in blk_p:
            assert isinstance(blk_o["experts"][0]["w_up"], tuple)
            assert blk_o["router"] is blk_p["router"]
    assert own["embed"] is tp["embed"]


def test_quantize_base_refuses_other_widths():
    _, jp, _, tp = _model(tuple(sorted(DENSE.items())))
    with pytest.raises(ValueError):
        jlora.quantize_base(jp, 3)
    with pytest.raises(ValueError, match="unsupported bits"):
        tlora.quantize_base(tp, 3)


_jforward = jax.jit(jtf.forward, static_argnums=2)


@pytest.mark.parametrize("case", list(CASES))
def test_adapted_forward_over_a_quantized_base_matches_jax(case):
    cfg, bits = CASES[case]
    jc, _, tc, _ = _model(tuple(sorted(cfg.items())))
    jq, _, own = _bases(tuple(sorted(cfg.items())), bits)
    jad = _adapters(jc, ("wqkv", "wo"))
    tokens, _ = _batch(tc.vocab_size)
    want = _jforward(jlora.attach_lora(jq, jad), jnp.asarray(tokens), jc)
    got = ttf.forward(tlora.attach_lora(own, lora_from_jax(jad, "cpu")),
                      torch.as_tensor(tokens), tc)
    _close(got, want)


STEPS = {"dense-int8-all": (DENSE, 8, ("wqkv", "wo", "w_gate", "w_up",
                                       "w_down")),
         "dense-int4-attention": (DENSE, 4, ("wqkv", "wo")),
         "moe-int8-attention": (MOE, 8, ("wqkv", "wo"))}


@pytest.mark.parametrize("case", list(STEPS))
def test_qlora_steps_match_jax(case):
    """Two AdamW steps of make_lora_train_step over a quantized base: the
    JAX losses and adapters; the base pairs do not move."""
    cfg, bits, targets = STEPS[case]
    jc, _, tc, _ = _model(tuple(sorted(cfg.items())))
    jq, _, own = _bases(tuple(sorted(cfg.items())), bits)
    oc = dict(lr=1e-2, weight_decay=0.0)
    jad = _adapters(jc, targets)
    tad = lora_from_jax(jad, device="cpu")
    jst = jtr.init_opt_state(jad["blocks"], jtr.OptConfig(**oc))
    tst = ttr.init_opt_state(tad["blocks"], ttr.OptConfig(**oc),
                             device="cpu")
    jstep = jax.jit(jlora.make_lora_train_step(jq, jc, jtr.OptConfig(**oc)))
    tstep = tlora.make_lora_train_step(own, tc, ttr.OptConfig(**oc),
                                       device="cpu")
    q0 = own["blocks"][0]["wqkv"][0].clone()
    for i in range(2):
        tokens, tgts = _batch(tc.vocab_size, seed=i)
        jad, jst, jl = jstep(jad, jst, jnp.asarray(tokens), jnp.asarray(tgts))
        tad, tst, tl = tstep(tad, tst, tokens, tgts)
        np.testing.assert_allclose(float(tl), float(jl), atol=LOSS_TOL,
                                   rtol=0)
    for g, w in zip(jax.tree_util.tree_leaves(tree_to_numpy(tad["blocks"])),
                    jax.tree_util.tree_leaves(jad["blocks"])):
        _close(g, w)
    assert torch.equal(own["blocks"][0]["wqkv"][0], q0)


@pytest.mark.parametrize("bits", [8, 4])
def test_a_quantized_product_saves_only_the_pair(bits):
    """The autograd graph of a block over a quantized base saves the
    (intN, scale) pairs and no float tensor of a base matrix's shape: the
    backward dequantizes again."""
    _, _, tc, _ = _model(tuple(sorted(DENSE.items())))
    _, _, own = _bases(tuple(sorted(DENSE.items())), bits)
    blk = own["blocks"][0]
    ad = tlora.init_lora(torch.Generator().manual_seed(0), tc, rank=4)
    ad["blocks"][0]["wqkv"]["A"].requires_grad_(True)
    p = tlora.attach_lora(own, ad)["blocks"][0]
    shapes = {tuple(tlora._TARGET_DIMS[k](tc)) for k in
              ("wqkv", "wo", "w_gate", "w_up", "w_down")}
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    x = torch.randn(2, 8, tc.d_model, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = ttf._block(x, p, tc)
    float_mats = [s for dt, s in saved if dt.is_floating_point
                  and s in shapes]
    assert float_mats == []
    qdtype = torch.int8 if bits == 8 else torch.uint8
    assert any(dt == qdtype for dt, _ in saved)
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert ad["blocks"][0]["wqkv"]["A"].grad is not None
    assert blk["wqkv"][0].grad is None


def test_quantized_product_gradient_is_the_dequantized_ones():
    """_DequantMm's gradient in y: that of y @ dequant_weight(pair)."""
    from kfunca_tpu_torch.ops.quant import dequant_weight

    g = torch.Generator().manual_seed(3)
    w = torch.randn(64, 40, generator=g)
    for pair in (tlora.quantize_cols(w), tlora.quantize_cols_int4(w, 32)):
        y = torch.randn(5, 64, generator=g, requires_grad=True)
        ttf._plain_mm(y, pair).square().sum().backward()
        y2 = y.detach().clone().requires_grad_(True)
        (y2 @ dequant_weight(*pair)).square().sum().backward()
        torch.testing.assert_close(y.grad, y2.grad, atol=1e-5, rtol=1e-5)
