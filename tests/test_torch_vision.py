"""Port parity: the ViT and the multimodal prefix LM
(kfunca_tpu_torch/models/vision.py).

The same weights (the JAX inits, carried across by
models/weights.vit_params_from_jax / multimodal_params_from_jax) and the
same numpy inputs go through both packages in fp32 on the CPU: patchify
exactly, vit_encode, the multimodal forward, loss and every gradient
(its text blocks through the port's transformer._block, whose attention
on CPU tensors is the flash kernels' plain version), and one AdamW step
through train.make_loss_train_step.  Outputs within 1e-5 x max(1,
max |ref|), gradients 1e-4 of each leaf's largest entry, a step's loss
1e-5 and params 1e-4 x max(1, max |ref|).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.models import vision as jv
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models import vision as tv
from kfunca_tpu_torch.models.weights import (
    multimodal_params_from_jax, opt_state_from_jax, vit_params_from_jax)
from torch_parity import close, one_thread, same_shapes, trees_close  # noqa: F401

VIT = dict(image_size=16, patch_size=4, channels=3, d_model=32, n_heads=2,
           n_layers=2, d_ff=64, dtype="float32")
TEXT = dict(vocab_size=64, d_model=32, n_heads=2, n_kv_heads=1, n_layers=2,
            d_ff=64, max_seq_len=64, dtype="float32")
OUT_TOL, GRAD_TOL, LOSS_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5, 1e-4


def _configs():
    jc = jv.MultimodalConfig(vit=jv.ViTConfig(**VIT),
                             text=jtf.TransformerConfig(**TEXT))
    tc = tv.MultimodalConfig(vit=tv.ViTConfig(**VIT),
                             text=ttf.TransformerConfig(**TEXT))
    return jc, tc


@pytest.fixture(scope="module")
def model():
    jc, tc = _configs()
    jp = jv.init_multimodal_params(jax.random.PRNGKey(0), jc)
    return jc, jp, tc, multimodal_params_from_jax(jp, tc, device="cpu")


def _batch(seed, b=2, t=6):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, 16, 16, 3)).astype(np.float32)
    tokens = rng.integers(0, 64, (b, t)).astype(np.int32)
    targets = rng.integers(0, 64, (b, t)).astype(np.int32)
    return images, tokens, targets


def test_patchify_is_the_jax_block_reshape():
    img = np.arange(2 * 16 * 16 * 3, dtype=np.float32).reshape(2, 16, 16, 3)
    want = np.asarray(jv.patchify(jnp.asarray(img), jv.ViTConfig(**VIT)))
    got = tv.patchify(torch.from_numpy(img), tv.ViTConfig(**VIT))
    assert got.shape == (2, 16, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 1].numpy(),
                                  img[0, 0:4, 4:8, :].reshape(-1))


def test_init_has_the_jax_layout():
    jc, tc = _configs()
    same_shapes(tv.init_multimodal_params(0, tc, "cpu"),
                jv.init_multimodal_params(jax.random.PRNGKey(0), jc))
    same_shapes(tv.init_vit_params(0, tc.vit, "cpu"),
                jv.init_vit_params(jax.random.PRNGKey(0), jc.vit))


def test_vit_encode_matches_jax(model):
    jc, jp, tc, tp = model
    images = _batch(1)[0]
    want = jax.jit(jv.vit_encode, static_argnums=2)(
        jp["vit"], jnp.asarray(images), jc.vit)
    got = tv.vit_encode(vit_params_from_jax(jp["vit"], tc.vit, device="cpu"),
                        torch.from_numpy(images), tc.vit)
    assert got.shape == (2, 16, 32)
    close(got, want, OUT_TOL)


def test_encoder_block_key_mask_matches_jax(model):
    """A block with a padding mask: masked keys take no attention."""
    jc, jp, tc, tp = model
    x = np.random.default_rng(2).normal(size=(2, 5, 32)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    want = jv._encoder_block(jnp.asarray(x), jp["vit"]["blocks"][0], jc.vit,
                             jnp.asarray(mask))
    got = tv._encoder_block(torch.from_numpy(x), tp["vit"]["blocks"][0],
                            tc.vit, torch.from_numpy(mask))
    close(got, want, OUT_TOL)
    x2 = x.copy()
    x2[0, 3:] = 7.0  # the padded positions' content reaches no valid row
    again = tv._encoder_block(torch.from_numpy(x2), tp["vit"]["blocks"][0],
                              tc.vit, torch.from_numpy(mask))
    close(again[0, :3], got[0, :3], OUT_TOL)


def test_multimodal_forward_matches_jax(model):
    jc, jp, tc, tp = model
    images, tokens, _ = _batch(3)
    want = jax.jit(jv.multimodal_forward, static_argnums=3)(
        jp, jnp.asarray(images), jnp.asarray(tokens), jc)
    got = tv.multimodal_forward(tp, torch.from_numpy(images),
                                torch.from_numpy(tokens), tc)
    assert got.shape == (2, 6, 64) and got.dtype == torch.float32
    close(got, want, OUT_TOL)


def test_multimodal_loss_and_grads_match_jax(model):
    jc, jp, tc, tp = model
    images, tokens, targets = _batch(4)
    want_l, want_g = jax.jit(jax.value_and_grad(jv.multimodal_loss),
                             static_argnums=4)(
        jp, jnp.asarray(images), jnp.asarray(tokens), jnp.asarray(targets),
        jc)
    loss, grads = ttr._value_and_grad(
        lambda p, x, y: tv.multimodal_loss(p, x[0], x[1], y, tc), tp,
        (torch.from_numpy(images), torch.from_numpy(tokens)),
        torch.from_numpy(targets))
    assert abs(float(loss) - float(want_l)) <= LOSS_TOL
    trees_close(grads, want_g, GRAD_TOL)


def test_train_step_matches_jax(model):
    jc, jp, tc, _ = model
    oc_kw = dict(lr=1e-3, weight_decay=0.1)

    def jstep(params, opt, images, tokens, targets):
        loss, grads = jax.value_and_grad(jv.multimodal_loss)(
            params, images, tokens, targets, jc)
        params, opt = jtr.apply_update(params, grads, opt,
                                       jtr.OptConfig(**oc_kw))
        return params, opt, loss

    images, tokens, targets = _batch(5)
    jopt = jtr.init_opt_state(jp)
    jp2, _, jl = jax.jit(jstep)(jp, jopt, jnp.asarray(images),
                                jnp.asarray(tokens), jnp.asarray(targets))
    tstep = ttr.make_loss_train_step(
        lambda p, x, y: tv.multimodal_loss(p, x[0], x[1], y, tc),
        ttr.OptConfig(**oc_kw), device="cpu")
    tp = multimodal_params_from_jax(jp, tc, device="cpu")
    tp2, _, tl = tstep(tp, opt_state_from_jax(jopt, device="cpu"),
                       (images, tokens), targets)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    trees_close(tp2, jp2, STEP_TOL, close)


def test_converters_check_every_leaf(model):
    jc, jp, tc, _ = model
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["img_proj"] = np.zeros((32, 16), np.float32)
    with pytest.raises(ValueError, match="img_proj"):
        multimodal_params_from_jax(bad, tc, device="cpu")
    with pytest.raises(ValueError, match="patch_proj"):
        vit_params_from_jax(jp["vit"], dataclasses.replace(tc.vit,
                                                           patch_size=8),
                            device="cpu")
    extra = dict(jax.tree_util.tree_map(np.asarray, jp["vit"]), cls=np.zeros(1))
    with pytest.raises(ValueError, match="no place"):
        vit_params_from_jax(extra, tc.vit, device="cpu")
