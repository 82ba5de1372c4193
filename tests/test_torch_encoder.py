"""Port parity: the bidirectional text encoder
(kfunca_tpu_torch/models/encoder.py), both architectures.

The same weights (the JAX inits or from_hf_bert, carried across by
models/weights.encoder_params_from_jax) and the same numpy inputs go
through both packages in fp32 on the CPU: encode under padding masks
(with token types for "bert"), the pooled embeddings, mlm_loss through the
chunked-vocab cross-entropy and its gradients, one MLM step, and a
directory written by transformers' BertModel.save_pretrained read without
transformers.  mlm_corrupt draws from a torch.Generator, so it is held to
the 80/10/10 law in distribution.  Outputs within 1e-5 x max(1,
max |ref|), gradients 1e-4 of each leaf's largest entry, a step's loss
1e-5 and params 1e-4 x max(1, max |ref|).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import encoder as je
from kfunca_tpu.models import train as jtr
from kfunca_tpu_torch.models import encoder as te
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models.weights import (
    encoder_params_from_jax, opt_state_from_jax)
from torch_parity import close, one_thread, same_shapes, trees_close  # noqa: F401

SMALL = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq_len=32, dtype="float32")
ARCHS = {"preln": {}, "bert": dict(arch="bert", type_vocab=2)}
OUT_TOL, GRAD_TOL, LOSS_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5, 1e-4


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch, kw in ARCHS.items():
        jc = je.EncoderConfig(**SMALL, **kw)
        tc = te.EncoderConfig(**dataclasses.asdict(jc))
        jp = je.init_encoder_params(jax.random.PRNGKey(0), jc)
        if arch == "bert":  # nonzero biases and norms, as a trained model's
            rng = np.random.default_rng(1)
            jp = jax.tree_util.tree_map(
                lambda a: np.asarray(a) + rng.normal(
                    0, 0.05, np.shape(a)).astype(np.float32), jp)
        out[arch] = (jc, jp, tc, encoder_params_from_jax(jp, tc,
                                                         device="cpu"))
    return out


def _batch(seed, b=3, s=10):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, 128, (b, s)).astype(np.int32)
    lengths = np.array([s, 7, 4][:b])
    valid = np.arange(s)[None, :] < lengths[:, None]
    types = (np.arange(s)[None, :] >= lengths[:, None] // 2).astype(np.int32)
    return tokens, valid, types


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_has_the_jax_layout(arch):
    jc = je.EncoderConfig(**SMALL, **ARCHS[arch])
    tc = te.EncoderConfig(**dataclasses.asdict(jc))
    same_shapes(te.init_encoder_params(0, tc, "cpu"),
                je.init_encoder_params(jax.random.PRNGKey(0), jc))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("masked", [False, True])
def test_encode_matches_jax(models, arch, masked):
    jc, jp, tc, tp = models[arch]
    tokens, valid, types = _batch(2)
    jv = jnp.asarray(valid) if masked else None
    tv = torch.from_numpy(valid) if masked else None
    if arch == "bert":
        want = je.encode(jp, jnp.asarray(tokens), jc, jv, jnp.asarray(types))
        got = te.encode(tp, torch.from_numpy(tokens), tc, tv,
                        torch.from_numpy(types))
    else:
        want = je.encode(jp, jnp.asarray(tokens), jc, jv)
        got = te.encode(tp, torch.from_numpy(tokens), tc, tv)
    assert got.shape == (3, 10, 32)
    close(got, want, OUT_TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_padded_keys_change_nothing(models, arch):
    """Valid rows see no padded key: another token in a padded slot leaves
    every valid position's hidden state as it was."""
    _, _, tc, tp = models[arch]
    tokens, valid, _ = _batch(3)
    t2 = tokens.copy()
    t2[~valid] = 5
    a = te.encode(tp, torch.from_numpy(tokens), tc, torch.from_numpy(valid))
    b = te.encode(tp, torch.from_numpy(t2), tc, torch.from_numpy(valid))
    close(a[torch.from_numpy(valid)], b[torch.from_numpy(valid)], OUT_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_pooled_embeddings_match_jax(models, masked):
    tokens, valid, types = _batch(4)
    jc, jp, tc, tp = models["preln"]
    jv = jnp.asarray(valid) if masked else None
    tv = torch.from_numpy(valid) if masked else None
    want = je.embed_pooled(jp, jnp.asarray(tokens), jc, jv)
    got = te.embed_pooled(tp, torch.from_numpy(tokens), tc, tv)
    close(got, want, OUT_TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-5)
    jc, jp, tc, tp = models["bert"]
    want = je.bert_pooled(jp, jnp.asarray(tokens), jc, jv,
                          jnp.asarray(types))
    got = te.bert_pooled(tp, torch.from_numpy(tokens), tc, tv,
                         torch.from_numpy(types))
    close(got, want, OUT_TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_mlm_loss_and_grads_match_jax(models, arch):
    """vocab_chunk 48 over 128 ids: the last chunk is partial."""
    jc, jp, tc, tp = models[arch]
    tokens, valid, _ = _batch(5)
    targets = np.where(np.random.default_rng(6).random(tokens.shape) < 0.3,
                       tokens, je.IGNORE).astype(np.int32)
    want_l, want_g = jax.jit(jax.value_and_grad(je.mlm_loss),
                             static_argnums=(3, 5))(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jc,
        jnp.asarray(valid), 48)
    loss, grads = ttr._value_and_grad(
        lambda p, x, y: te.mlm_loss(p, x, y, tc, torch.from_numpy(valid),
                                    48), tp,
        torch.from_numpy(tokens), torch.from_numpy(targets))
    assert abs(float(loss) - float(want_l)) <= LOSS_TOL
    trees_close(grads, want_g, GRAD_TOL)


def test_mlm_corrupt_keeps_the_80_10_10_law():
    """The port's corruption against the law and against the JAX
    function's rates on the same tokens: a 15% selection, then [MASK]
    80%, a random id 10%, the token kept 10% (random ids may equal the
    token, 1/128 of them)."""
    cfg = te.EncoderConfig(**SMALL)
    tokens = np.random.default_rng(7).integers(2, 128, (64, 512)).astype(
        np.int32)
    gen = torch.Generator().manual_seed(0)
    inputs, targets = te.mlm_corrupt(gen, torch.from_numpy(tokens), cfg)
    assert inputs.dtype == targets.dtype == torch.int32
    ji, jt = je.mlm_corrupt(jax.random.PRNGKey(0), jnp.asarray(tokens),
                            je.EncoderConfig(**SMALL))

    def rates(inputs, targets):
        inputs, targets = np.asarray(inputs), np.asarray(targets)
        sel = targets != je.IGNORE
        assert (targets[sel] == tokens[sel]).all()
        assert (inputs[~sel] == tokens[~sel]).all()
        n = sel.sum()
        return (n / tokens.size, (inputs[sel] == cfg.mask_token).mean(),
                (inputs[sel] == tokens[sel]).mean(), n)

    port, ref = rates(inputs, targets), rates(ji, jt)
    n = port[3]
    for got, want, p in zip(port[:3], (0.15, 0.8, 0.1 + 0.1 / 128),
                            (0.15, 0.8, 0.1)):
        sd = np.sqrt(p * (1 - p) / (tokens.size if p == 0.15 else n))
        assert abs(got - want) < 5 * sd, (got, want)
    for got, want in zip(port[:3], ref[:3]):
        assert abs(got - want) < 0.02, (port, ref)


def test_mlm_train_step_matches_jax_on_its_draws(models):
    """The port's step draws its corruption from the generator; the JAX
    step (value_and_grad + apply_update) runs on those same draws."""
    jc, jp, tc, _ = models["preln"]
    oc_kw = dict(lr=1e-3, weight_decay=0.01)
    tokens, valid, _ = _batch(8)
    inputs, targets = te.mlm_corrupt(torch.Generator().manual_seed(3),
                                     torch.from_numpy(tokens), tc, 0.3)

    def jstep(params, opt, inputs, targets, valid):
        loss, grads = jax.value_and_grad(je.mlm_loss)(
            params, inputs, targets, jc, valid, 48)
        params, opt = jtr.apply_update(params, grads, opt,
                                       jtr.OptConfig(**oc_kw))
        return params, opt, loss

    jopt = jtr.init_opt_state(jp)
    jp2, _, jl = jax.jit(jstep)(jp, jopt, jnp.asarray(inputs.numpy()),
                                jnp.asarray(targets.numpy()),
                                jnp.asarray(valid))
    step = te.make_mlm_train_step(tc, ttr.OptConfig(**oc_kw), 0.3, 48,
                                  device="cpu")
    tp2, _, tl = step(encoder_params_from_jax(jp, tc, device="cpu"),
                      opt_state_from_jax(jopt, device="cpu"),
                      torch.Generator().manual_seed(3), tokens, valid)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    trees_close(tp2, jp2, STEP_TOL, close)


def _bert_model(seed=0):
    transformers = pytest.importorskip("transformers")
    hc = transformers.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        attn_implementation="eager")
    torch.manual_seed(seed)
    return transformers.BertModel(hc).eval()


def test_hf_bert_directory_matches_jax(tmp_path):
    model = _bert_model()
    model.save_pretrained(tmp_path)
    jp, jc = je.from_hf_bert(model)
    tp, tc = te.from_hf_bert(tmp_path, device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    trees_close(tp, jp, 0.0)  # the same numbers, bit for bit
    ip, icfg = te.from_hf_bert(model, device="cpu")
    assert icfg == tc
    trees_close(ip, tp, 0.0)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 128, (2, 12)).astype(np.int32)
    valid = np.ones((2, 12), bool)
    valid[1, 8:] = False
    types = (np.arange(12)[None, :] >= 6).astype(np.int32).repeat(2, 0)
    want = je.bert_encode(jp, jnp.asarray(tokens), jc, jnp.asarray(valid),
                          jnp.asarray(types))
    got = te.bert_encode(tp, torch.from_numpy(tokens), tc,
                         torch.from_numpy(valid), torch.from_numpy(types))
    close(got, want, OUT_TOL)
    want = je.bert_pooled(jp, jnp.asarray(tokens), jc, jnp.asarray(valid),
                          jnp.asarray(types))
    got = te.bert_pooled(tp, torch.from_numpy(tokens), tc,
                         torch.from_numpy(valid), torch.from_numpy(types))
    close(got, want, OUT_TOL)


def test_converter_checks_every_leaf(models):
    jc, jp, tc, _ = models["bert"]
    bad = jax.tree_util.tree_map(np.asarray, jp)
    del bad["type_embed"]
    with pytest.raises(ValueError, match="no type_embed"):
        encoder_params_from_jax(bad, tc, device="cpu")
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["blocks"][0]["b_fc"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match=r"blocks\[0\]\.b_fc"):
        encoder_params_from_jax(bad, tc, device="cpu")
    del bad["pooler_w"], bad["pooler_b"], bad["blocks"][0]["b_fc"]
    with pytest.raises(ValueError, match="no b_fc"):
        encoder_params_from_jax(bad, tc, device="cpu")
