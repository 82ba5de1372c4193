"""Port parity: the hybrid attention + SSM stack (models/hybrid.py).

Shared weights (the JAX init_hybrid_params, carried across by
models/weights.hybrid_params_from_jax), shared numpy tokens.  Held: layer
placement, the forward, loss and every gradient (an attention layer and
SSM layers in one stack, both SSM engine settings), three train steps,
greedy generate against the JAX generate (with eos), and the port's
recurrent decode against its own parallel forward.  fp32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import hybrid as jh
from kfunca_tpu.models import train as jtr
from kfunca_tpu_torch.models import hybrid as th
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import (
    hybrid_params_from_jax, opt_state_from_jax, tree_to_numpy)
from kfunca_tpu_torch.utils.tree import tree_leaves, tree_unflatten

CFG = dict(vocab_size=89, d_model=32, n_layers=4, d_ff=48, n_heads=2,
           n_kv_heads=1, d_state=4, d_conv=3, expand=2, max_seq_len=64,
           scan_chunk=None, dtype="float32", attn_every=4, attn_offset=2)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 89, (b, s)).astype(np.int32)


def _trees_close(got, want, tol):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def model():
    jc, tc = jh.HybridConfig(**CFG), th.HybridConfig(**CFG)
    jp = jh.init_hybrid_params(jax.random.PRNGKey(8), jc)
    return jc, jp, tc, hybrid_params_from_jax(jp, tc, device="cpu")


def test_placement_and_shapes_follow_the_jax_config(model):
    jc, jp, tc, tp = model
    assert tc.layer_kinds() == jc.layer_kinds() == (
        "mamba", "mamba", "attn", "mamba")
    jamba = dict(n_layers=28, attn_every=14, attn_offset=7)
    assert (th.HybridConfig(**jamba).layer_kinds()
            == jh.HybridConfig(**jamba).layer_kinds())
    assert th.HybridConfig(n_layers=8, attn_every=14,
                           attn_offset=7).layer_kinds()[7] == "attn"
    own = th.init_hybrid_params(0, tc, device="cpu")
    for mine, theirs in zip(own["blocks"], tp["blocks"]):
        assert {k: tuple(v.shape) for k, v in mine.items()} == {
            k: tuple(v.shape) for k, v in theirs.items()}
    st = th.init_hybrid_state(tc, batch=2, max_len=10, device="cpu")
    jst = jh.init_hybrid_state(jc, batch=2, max_len=10)
    for a, b in zip(st, jst):
        assert {k: tuple(v.shape) for k, v in a.items()} == {
            k: tuple(v.shape) for k, v in b.items()}
    with pytest.raises(ValueError, match="pattern"):
        th.HybridConfig(n_layers=2, pattern=("attn",)).layer_kinds()


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_forward_loss_and_gradients_match_jax(model, monkeypatch, engine):
    jc, jp, tc, tp = model
    toks, tgt = _tokens(2, 2, 12), _tokens(3, 2, 12)
    jl, jg = jax.jit(jax.value_and_grad(jh.loss_fn), static_argnums=3)(
        jp, jnp.asarray(toks), jnp.asarray(tgt), jc)
    logits = jax.jit(jh.forward, static_argnums=2)(jp, jnp.asarray(toks), jc)
    monkeypatch.setenv("KFUNCA_SSM_ENGINE", engine)
    got = th.forward(tp, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               rtol=1e-5, atol=1e-5)
    views = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss = th.loss_fn(tree_unflatten(tp, views), torch.from_numpy(toks),
                      torch.from_numpy(tgt), tc)
    grads = torch.autograd.grad(loss, views)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _trees_close(tree_to_numpy(tree_unflatten(tp, grads)), jg, 1e-4)


def test_all_attention_pattern_is_the_transformer(model):
    cfg = th.HybridConfig(**{**CFG, "n_layers": 2, "pattern": ("attn", "attn")})
    params = th.init_hybrid_params(3, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(4, 2, 9))
    torch.testing.assert_close(th.forward(params, toks, cfg),
                               ttf.forward(params, toks, cfg.tcfg),
                               rtol=1e-5, atol=1e-6)


def test_train_steps_match_jax(model):
    jc, jp, tc, _ = model
    oc = dict(lr=1e-2, warmup_steps=0, weight_decay=0.0)
    joc, toc = jtr.OptConfig(**oc), ttr.OptConfig(**oc)
    jst = jtr.init_opt_state(jp, joc)
    tp = hybrid_params_from_jax(jp, tc, device="cpu")
    tst = opt_state_from_jax(jst, device="cpu")
    jstep = jax.jit(jh.make_hybrid_train_step(jc, joc))
    tstep = th.make_hybrid_train_step(tc, toc, device="cpu")
    jlosses, tlosses = [], []
    tok, tgt = _tokens(10, 2, 16), _tokens(20, 2, 16)
    for _ in range(3):
        jp, jst, jl = jstep(jp, jst, jnp.asarray(tok), jnp.asarray(tgt))
        tp, tst, tl = tstep(tp, tst, tok, tgt)
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    _trees_close(tree_to_numpy(tp), jp, 2e-4)


@pytest.mark.parametrize("eos_from", [None, 2])
def test_generate_matches_jax(model, eos_from):
    jc, jp, tc, tp = model
    prompt = _tokens(9, 2, 6)
    free = np.asarray(jh.generate(jp, jnp.asarray(prompt), jc,
                                  max_new_tokens=5))
    eos = -1 if eos_from is None else int(free[0, eos_from])
    want = np.asarray(jh.generate(jp, jnp.asarray(prompt), jc,
                                  max_new_tokens=5, eos_id=eos))
    got = th.generate(tp, torch.from_numpy(prompt), tc, max_new_tokens=5,
                      eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_decode_matches_the_parallel_forward(model):
    _, _, tc, tp = model
    prompt = torch.from_numpy(_tokens(11, 2, 6))
    toks = th.generate(tp, prompt, tc, max_new_tokens=5)
    seq = prompt.long()
    for i in range(5):
        nxt = torch.argmax(th.forward(tp, seq, tc)[:, -1], dim=-1)
        assert torch.equal(toks[:, i], nxt.int())
        seq = torch.cat([seq, nxt[:, None]], dim=1)


def test_params_from_jax_checks_the_layer_kinds(model):
    _, jp, tc, _ = model
    with pytest.raises(ValueError, match="no wqkv"):
        hybrid_params_from_jax(jp, dataclasses.replace(tc, attn_offset=1),
                               device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        hybrid_params_from_jax(jp, dataclasses.replace(tc, n_layers=5),
                               device="cpu")
