"""Port parity: CLIP (kfunca_tpu_torch/models/clip.py).

The same weights (the JAX init_clip_params, carried across by
models/weights.clip_params_from_jax) and the same numpy inputs go through
both packages in fp32 on the CPU: both encoders, clip_loss with its
metrics and every gradient (the logit-scale clamp included), the
data-parallel clip_loss_sharded over a LocalMesh against clip_loss on the
concatenated batch, and one AdamW step of make_clip_train_step.  Outputs
within 1e-5 x max(1, max |ref|), gradients 1e-4 of each leaf's largest
entry, a step's loss 1e-5 and params 1e-4 x max(1, max |ref|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import clip as jcl
from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.models import vision as jv
from kfunca_tpu_torch.models import clip as tcl
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models import vision as tv
from kfunca_tpu_torch.models.weights import (
    clip_params_from_jax, opt_state_from_jax)
from kfunca_tpu_torch.parallel.mesh import LocalMesh
from torch_parity import close, one_thread, same_shapes, trees_close  # noqa: F401

VIT = dict(image_size=16, patch_size=8, d_model=32, n_heads=2, n_layers=1,
           d_ff=64, dtype="float32")
TEXT = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=16, dtype="float32")
OUT_TOL, GRAD_TOL, LOSS_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5, 1e-4


def _configs():
    return (jcl.ClipConfig(vit=jv.ViTConfig(**VIT),
                           text=jtf.TransformerConfig(**TEXT), embed_dim=16),
            tcl.ClipConfig(vit=tv.ViTConfig(**VIT),
                           text=ttf.TransformerConfig(**TEXT), embed_dim=16))


@pytest.fixture(scope="module")
def model():
    jc, tc = _configs()
    jp = jcl.init_clip_params(jax.random.PRNGKey(0), jc)
    return jc, jp, tc, clip_params_from_jax(jp, tc, device="cpu")


@pytest.fixture(scope="module")
def jax_grad():
    return jax.jit(jax.value_and_grad(jcl.clip_loss, has_aux=True),
                   static_argnums=3)


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 16, 16, 3)).astype(np.float32),
            rng.integers(0, 64, (b, 6)).astype(np.int32))


def test_init_has_the_jax_layout():
    jc, tc = _configs()
    same_shapes(tcl.init_clip_params(0, tc, "cpu"),
                jcl.init_clip_params(jax.random.PRNGKey(0), jc))


def test_encoders_match_jax(model):
    jc, jp, tc, tp = model
    images, tokens = _batch(1)
    img = tcl.encode_image(tp, torch.from_numpy(images), tc)
    txt = tcl.encode_text(tp, torch.from_numpy(tokens), tc)
    close(img, jcl.encode_image(jp, jnp.asarray(images), jc), OUT_TOL)
    close(txt, jcl.encode_text(jp, jnp.asarray(tokens), jc), OUT_TOL)
    np.testing.assert_allclose(np.linalg.norm(img.numpy(), axis=-1), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("logit_scale", [None, 5.0])
def test_loss_metrics_and_grads_match_jax(model, jax_grad, logit_scale):
    """5.0 lies past the clamp at log(100): the scale reads 100 and its
    gradient is 0 in both packages."""
    jc, jp, tc, tp = model
    if logit_scale is not None:
        jp = dict(jp, logit_scale=jnp.asarray(logit_scale, jnp.float32))
        tp = dict(tp, logit_scale=torch.tensor(logit_scale))
    images, tokens = _batch(2)
    (want_l, want_m), want_g = jax_grad(jp, jnp.asarray(images),
                                        jnp.asarray(tokens), jc)
    loss, metrics, grads = ttr.value_and_grad_aux(
        lambda p: tcl.clip_loss(p, torch.from_numpy(images),
                                torch.from_numpy(tokens), tc), tp)
    assert abs(float(loss) - float(want_l)) <= LOSS_TOL
    assert float(metrics["acc_i2t"]) == float(want_m["acc_i2t"])
    close(metrics["logit_scale"], want_m["logit_scale"], OUT_TOL)
    trees_close({k: v for k, v in grads.items() if k != "logit_scale"},
                {k: v for k, v in want_g.items() if k != "logit_scale"},
                GRAD_TOL)
    if logit_scale is None:
        trees_close(grads["logit_scale"], want_g["logit_scale"], GRAD_TOL)
    else:
        assert float(metrics["logit_scale"]) == pytest.approx(100.0,
                                                              rel=1e-6)
        assert float(grads["logit_scale"]) == float(
            want_g["logit_scale"]) == 0.0


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_loss_is_the_global_batch_loss(model, dp):
    """Every rank's loss is clip_loss's on the concatenated batch, and
    autograd over the ranks' losses gives its gradient (the JAX
    shard_map'd function's), each rank's embeddings all-gathered as the
    negatives and their gradients reduce-scattered home."""
    jc, jp, tc, tp = model
    images, tokens = _batch(3, b=8)
    (want_l, _), want_g = jax.jit(
        jax.value_and_grad(jcl.clip_loss, has_aux=True), static_argnums=3)(
        jp, jnp.asarray(images), jnp.asarray(tokens), jc)
    mesh = LocalMesh(dp, 1, "cpu")
    leaves, treedef = jax.tree_util.tree_flatten(tp)
    views = [t.detach().requires_grad_(True) for t in leaves]
    losses = tcl.clip_loss_sharded(
        jax.tree_util.tree_unflatten(treedef, views),
        torch.from_numpy(images), torch.from_numpy(tokens), tc, mesh)
    grads = jax.tree_util.tree_unflatten(
        treedef, torch.autograd.grad(losses, views))
    assert len(losses) == dp
    for loss in losses:
        assert abs(float(loss.detach()) - float(want_l)) <= LOSS_TOL
    trees_close(grads, want_g, GRAD_TOL)


def test_train_step_matches_jax(model):
    jc, jp, tc, _ = model
    oc_kw = dict(lr=3e-3, weight_decay=0.0)
    jstep = jax.jit(jcl.make_clip_train_step(jc, jtr.OptConfig(**oc_kw)))
    tstep = tcl.make_clip_train_step(tc, ttr.OptConfig(**oc_kw),
                                     device="cpu")
    images, tokens = _batch(4)
    jopt = jtr.init_opt_state(jp)
    jp2, _, jm = jstep(jp, jopt, jnp.asarray(images), jnp.asarray(tokens))
    tp2, _, tm = tstep(clip_params_from_jax(jp, tc, device="cpu"),
                       opt_state_from_jax(jopt, device="cpu"), images, tokens)
    assert set(tm) == {"loss", "acc_i2t", "logit_scale"}
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    trees_close(tp2, jp2, STEP_TOL, close)


def test_converter_checks_every_leaf(model):
    jc, jp, tc, _ = model
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["logit_scale"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="logit_scale"):
        clip_params_from_jax(bad, tc, device="cpu")
