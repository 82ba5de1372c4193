"""Port parity: DiT (kfunca_tpu_torch/models/dit.py).

The same weights (the JAX init_dit_params with its zero leaves drawn
nonzero by numpy, carried across by models/weights.dit_params_from_jax)
and the same numpy inputs go through both packages in fp32 on the CPU:
dit_forward (and its zero output at the adaLN-Zero init), unpatchify of
patchify, the schedule and q_sample, the loss core on the draws JAX's
dit_loss makes from its key (the same splits) with every gradient, one
AdamW step, and the DDIM loop from JAX's starting noise (and, for eta >
0, its per-step noises) against JAX's ddim_sample.  Outputs within 1e-5 x
max(1, max |ref|) (the sampler's 1e-4, and the sinusoid's at large t, for
the reasons their tests give), gradients 1e-4 of each leaf's largest
entry, a step's loss 1e-5 and params 1e-4 x max(1, max |ref|).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import dit as jd
from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import vision as jv
from kfunca_tpu_torch.models import dit as td
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import vision as tv
from kfunca_tpu_torch.models.weights import (
    dit_params_from_jax, opt_state_from_jax)
from torch_parity import close, one_thread, same_shapes, trees_close  # noqa: F401

SMALL = dict(image_size=8, patch_size=2, channels=4, d_model=32, n_heads=2,
             n_layers=2, d_ff=64, n_classes=5, timesteps=50, dtype="float32")
OUT_TOL, GRAD_TOL, LOSS_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5, 1e-4
DDIM_TOL = 1e-4  # the sampler's own spread, below


@pytest.fixture(scope="module")
def model():
    """JAX params with every leaf nonzero (the init's zero modulations and
    projections drawn N(0, 0.05^2)), so that every path carries signal."""
    jc = jd.DiTConfig(**SMALL)
    tc = td.DiTConfig(**SMALL)
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if np.abs(np.asarray(a)).max() > 0 else
        rng.normal(0, 0.05, np.shape(a)).astype(np.float32),
        jd.init_dit_params(jax.random.PRNGKey(0), jc))
    return jc, jp, tc, dit_params_from_jax(jp, tc, device="cpu")


def _batch(seed, b=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 8, 8, 4)).astype(np.float32),
            rng.integers(0, 5, (b,)).astype(np.int32),
            rng.integers(0, 50, (b,)).astype(np.int32))


def test_init_has_the_jax_layout_and_predicts_zero():
    jc, tc = jd.DiTConfig(**SMALL), td.DiTConfig(**SMALL)
    jp = jd.init_dit_params(jax.random.PRNGKey(0), jc)
    tp = td.init_dit_params(0, tc, "cpu")
    same_shapes(tp, jp)
    images, labels, t = _batch(1)
    out = td.dit_forward(tp, torch.from_numpy(images), torch.from_numpy(t),
                         torch.from_numpy(labels), tc)
    assert out.shape == (3, 8, 8, 4) and not out.abs().max()


def test_unpatchify_inverts_patchify():
    cfg = td.DiTConfig(**SMALL)
    images = torch.from_numpy(_batch(2)[0])
    x = tv.patchify(images, cfg.vit())
    assert x.shape == (3, 16, 16)
    assert torch.equal(td.unpatchify(x, cfg), images)
    np.testing.assert_array_equal(
        td.unpatchify(x, cfg).numpy(),
        np.asarray(jd.unpatchify(jv.patchify(jnp.asarray(images.numpy()),
                                             jd.DiTConfig(**SMALL).vit()),
                                 jd.DiTConfig(**SMALL))))


@pytest.mark.parametrize("timesteps", [50, 1000])
def test_schedule_and_q_sample_match_jax(timesteps):
    jc = jd.DiTConfig(**{**SMALL, "timesteps": timesteps})
    tc = td.DiTConfig(**{**SMALL, "timesteps": timesteps})
    want = np.asarray(jd.alphas_bar(jc))
    ab = td.alphas_bar(tc, "cpu")
    close(ab, want, OUT_TOL)
    images, _, _ = _batch(3)
    t = np.array([0, timesteps // 2, timesteps - 1], np.int32)
    noise = np.random.default_rng(4).normal(size=images.shape).astype(
        np.float32)
    close(td.q_sample(torch.from_numpy(images), torch.from_numpy(t),
                      torch.from_numpy(noise), ab),
          jd.q_sample(jnp.asarray(images), jnp.asarray(t),
                      jnp.asarray(noise), jnp.asarray(want)), OUT_TOL)


def test_timestep_embedding_matches_jax():
    """cos / sin of t x f: each frequency f is one fp32 exp, which XLA's
    and torch's may round one ulp apart (neither is correctly rounded
    everywhere), so an angle carries up to t ulps of f.  Within 1e-5 over
    the small schedule's t < 50; at t = 999 within those ulps."""
    for t, tol in (([0, 1, 25, 49], OUT_TOL), ([500, 999], 999 * 2 ** -22)):
        t = np.array(t, np.int32)
        close(td.timestep_embedding(torch.from_numpy(t)),
              jd.timestep_embedding(jnp.asarray(t)), tol)


def test_forward_matches_jax(model):
    jc, jp, tc, tp = model
    images, labels, t = _batch(5)
    labels[1] = jc.null_class
    want = jax.jit(jd.dit_forward, static_argnums=4)(
        jp, jnp.asarray(images), jnp.asarray(t), jnp.asarray(labels), jc)
    got = td.dit_forward(tp, torch.from_numpy(images), torch.from_numpy(t),
                         torch.from_numpy(labels), tc)
    close(got, want, OUT_TOL)


def _jax_draws(key, images, labels, cfg, drop_prob):
    """The draws jax dit_loss makes from its key (dit.py's splits)."""
    b = images.shape[0]
    kt, kn, kd = jax.random.split(key, 3)
    t = jax.random.randint(kt, (b,), 0, cfg.timesteps, jnp.int32)
    noise = jax.random.normal(kn, images.shape, jnp.float32)
    y = jnp.where(jax.random.uniform(kd, (b,)) < drop_prob,
                  jnp.int32(cfg.null_class), jnp.asarray(labels, jnp.int32))
    return (torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise)),
            torch.from_numpy(np.array(y)))


def test_loss_core_on_jax_draws_matches_dit_loss(model):
    jc, jp, tc, tp = model
    images, labels, _ = _batch(6, b=6)
    key = jax.random.PRNGKey(3)
    want_l, want_g = jax.jit(jax.value_and_grad(jd.dit_loss),
                             static_argnums=(4, 5))(
        jp, key, jnp.asarray(images), jnp.asarray(labels), jc, 0.5)
    t, noise, y = _jax_draws(key, images, labels, jc, 0.5)
    assert (y == jc.null_class).any() and (y != jc.null_class).any()
    loss, _, grads = ttr.value_and_grad_aux(
        lambda p: (td.dit_loss_core(p, torch.from_numpy(images), t, noise, y,
                                    tc), None), tp)
    assert abs(float(loss) - float(want_l)) <= LOSS_TOL
    trees_close(grads, want_g, GRAD_TOL)


def test_train_step_matches_jax_on_its_draws(model):
    jc, jp, tc, _ = model
    oc_kw = dict(lr=1e-3, weight_decay=0.0)
    images, labels, _ = _batch(7, b=4)
    t, noise, y = td.draw_loss_inputs(torch.Generator().manual_seed(5),
                                      torch.from_numpy(images),
                                      torch.from_numpy(labels), tc, 0.3)

    def jstep(params, opt, images, t, noise, y):
        def loss(p):
            xt = jd.q_sample(images, t, noise, jd.alphas_bar(jc))
            return jnp.mean(jnp.square(jd.dit_forward(p, xt, t, y, jc)
                                       - noise))

        lv, grads = jax.value_and_grad(loss)(params)
        params, opt = jtr.apply_update(params, grads, opt,
                                       jtr.OptConfig(**oc_kw))
        return params, opt, lv

    jopt = jtr.init_opt_state(jp)
    jp2, _, jl = jax.jit(jstep)(jp, jopt, jnp.asarray(images),
                                *(jnp.asarray(a.numpy()) for a in (t, noise,
                                                                   y)))
    step = td.make_dit_train_step(tc, ttr.OptConfig(**oc_kw), 0.3,
                                  device="cpu")
    tp2, _, tl = step(dit_params_from_jax(jp, tc, device="cpu"),
                      opt_state_from_jax(jopt, device="cpu"),
                      torch.Generator().manual_seed(5), images, labels)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    trees_close(tp2, jp2, STEP_TOL, close)


@pytest.mark.parametrize("guidance,eta", [(1.0, 0.0), (4.0, 0.0),
                                          (4.0, 0.5)])
def test_ddim_loop_from_jax_noise_matches_ddim_sample(model, guidance, eta):
    """Held at DDIM_TOL: the iterated sampler amplifies fp32 roundings
    (x0 divides by sqrt(ab_t), guidance 4 weighs cond - uncond by 4), so
    JAX's own ddim_sample moves by 1.8e-5 (guidance 1) and 5.9e-5
    (guidance 4) at 20 steps when every weight moves by one ulp; the
    forwards inside agree within 2.4e-7."""
    jc, jp, tc, tp = model
    labels = np.array([0, 3, 4], np.int32)
    key = jax.random.PRNGKey(11)
    steps = 8
    want = jd.ddim_sample(jp, key, jnp.asarray(labels), jc, steps=steps,
                          guidance=guidance, eta=eta)
    shape = (3, 8, 8, 4)
    key2, knoise = jax.random.split(key)
    x = torch.from_numpy(np.array(jax.random.normal(knoise, shape,
                                                    jnp.float32)))
    noises = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key2, i), shape, jnp.float32)))
        for i in range(steps)]
    got = td.ddim_loop(tp, x, torch.from_numpy(labels), tc, steps, guidance,
                       eta, noises)
    assert got.shape == shape
    close(got, want, DDIM_TOL)


def test_ddim_sample_draws_on_its_device(model):
    _, _, tc, tp = model
    got = td.ddim_sample(tp, torch.Generator().manual_seed(0), [1, 2], tc,
                         steps=4, guidance=2.0, eta=1.0, device="cpu")
    assert got.shape == (2, 8, 8, 4) and torch.isfinite(got).all()
    again = td.ddim_sample(tp, torch.Generator().manual_seed(0), [1, 2], tc,
                           steps=4, guidance=2.0, eta=1.0, device="cpu")
    assert torch.equal(got, again)
    assert td.ddim_timesteps(tc, 4) == [49, 33, 16, 0]


def test_converter_checks_every_leaf(model):
    jc, jp, tc, _ = model
    with pytest.raises(ValueError, match="y_embed"):
        dit_params_from_jax(jp, dataclasses.replace(tc, n_classes=6),
                            device="cpu")
