"""Port parity: the runnable examples #10-#14 (kfunca_tpu_torch/examples/:
zb_pipeline, seq2seq_t5, asr_whisper, caption_multimodal, generate_dit)
against the JAX package's examples/ and modules on the CPU, at sizes well
under the defaults.

  * Data: the batch makers (T5's sorting task, Whisper's tones, the
    captioning quadrants, DiT's half-planes) and zb_pipeline's layers,
    targets and inputs give the JAX examples' arrays bit for bit from the
    same numpy seeds.
  * Stages: the JAX init exported through models/weights.py starts each
    example's run(args, params=...); its losses over 3 steps equal the
    jitted JAX steps' on the same batches within 1e-5 x max(1, |loss|),
    and its fp32 greedy tokens (t5_generate, whisper_generate, the
    captioning loop) equal the JAX package's.  Whisper's JAX steps take
    the port's log-mel features; DiT's take the port's draws (recorded
    from dit.draw_loss_inputs), since the two frameworks draw differently.
  * zb_pipeline runs through main([..., "--device", "cpu"]): its loss
    falls, and its first iterations equal the JAX zero-bubble step's over
    four of the conftest's virtual CPU devices.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import audio as jaudio
from kfunca_tpu.models import dit as jdit
from kfunca_tpu.models import t5 as jt5
from kfunca_tpu.models import train as jtrain
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.models import vision as jvision
from kfunca_tpu.models import whisper as jwhisper
from kfunca_tpu.parallel import pipeline as jpipe
from kfunca_tpu.parallel import zero_bubble as jzb
from kfunca_tpu_torch.examples import (asr_whisper, caption_multimodal,
                                       generate_dit, seq2seq_t5, zb_pipeline)
from kfunca_tpu_torch.models import dit as tdit
from kfunca_tpu_torch.models.weights import (dit_params_from_jax,
                                             multimodal_params_from_jax,
                                             t5_params_from_jax,
                                             whisper_params_from_jax)
from torch_parity import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = 1e-5
CPU = ["--device", "cpu"]


@functools.lru_cache(maxsize=None)
def jax_example(name):
    """The JAX example's module, loaded by path (for its data helpers)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def losses_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_TOL * max(1.0, abs(w)), (got, want)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def as_jax(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


# -- data -----------------------------------------------------------------


def _equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 123])
def test_seq2seq_batches_are_the_jax_examples(seed):
    ref = jax_example("seq2seq_t5").make_batch(np.random.RandomState(seed),
                                               5, 8, 32)
    _equal(seq2seq_t5.make_batch(np.random.RandomState(seed), 5, 8, 32), ref)


def test_asr_tones_are_the_jax_examples():
    ref = jax_example("asr_whisper").make_batch(np.random.RandomState(0), 3,
                                                4)
    port = asr_whisper.make_batch(np.random.RandomState(0), 3, 4)
    _equal(port, ref)
    cfg = asr_whisper.config(asr_whisper.parse(CPU))
    feats = asr_whisper.features(port[0], cfg, torch.device("cpu"))
    want = jaudio.log_mel_spectrogram(jnp.asarray(port[0]),
                                      n_mels=cfg.n_mels)
    want = np.asarray(want)[:, :, : 2 * cfg.max_source_positions]
    assert feats.shape == want.shape
    np.testing.assert_allclose(feats.numpy(), want, rtol=0, atol=1e-4)


def test_caption_batches_are_the_jax_examples():
    ref = jax_example("caption_multimodal").make_batch(
        np.random.RandomState(0), 6)
    _equal(caption_multimodal.make_batch(np.random.RandomState(0), 6), ref)


def test_dit_batches_and_contrast_are_the_jax_examples():
    jx = jax_example("generate_dit")
    ref = jx.make_batch(np.random.RandomState(0), 4, 16)
    port = generate_dit.make_batch(np.random.RandomState(0), 4, 16)
    _equal(port, ref)
    np.testing.assert_array_equal(generate_dit.contrast(port[0]),
                                  jx.contrast(np.asarray(ref[0])))


def test_zb_data_is_the_jax_examples_stream():
    rng = np.random.default_rng(0)  # the JAX example's draws, in order
    n, m, mb, d = (zb_pipeline.N_STAGES, zb_pipeline.N_MICRO, zb_pipeline.MB,
                   zb_pipeline.DIM)
    want_w = [rng.standard_normal((d, d)) * 0.2 for _ in range(2 * n)]
    want_t = rng.standard_normal((m, mb, d))
    want_x = rng.standard_normal((m, mb, d))
    layers, targets, x = zb_pipeline.data()
    for lay, w in zip(layers, want_w):
        np.testing.assert_array_equal(lay["w"], np.float32(w))
        np.testing.assert_array_equal(lay["b"], np.zeros(d, np.float32))
    np.testing.assert_array_equal(targets, np.float32(want_t))
    np.testing.assert_array_equal(x, np.float32(want_x))


# -- stages -----------------------------------------------------------------


def test_seq2seq_t5_stages_match_jax():
    args = seq2seq_t5.parse(["--steps", "3", "--batch", "4", *CPU])
    cfg = seq2seq_t5.CFG
    jc = as_jax(cfg, jt5.T5Config)
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(
        jt5.init_t5_params, static_argnums=1)(jax.random.PRNGKey(0), jc))
    out = seq2seq_t5.run(args, params=t5_params_from_jax(jp, cfg,
                                                         device="cpu"))
    oc = as_jax(seq2seq_t5.opt_config(args), jtrain.OptConfig)
    step = jax.jit(jt5.make_t5_train_step(jc, oc))
    jp, opt, losses = jax_tree(jp), jtrain.init_opt_state(jp, oc), []
    rng = np.random.RandomState(0)
    for _ in range(3):
        enc, labels = seq2seq_t5.make_batch(rng, 4, 8, cfg.vocab_size)
        jp, opt, loss = step(jp, opt, enc, labels)
        losses.append(float(loss))
    losses_close(out["losses"], losses)
    enc, _ = seq2seq_t5.make_batch(np.random.RandomState(123), 64, 8,
                                   cfg.vocab_size)
    want = jt5.t5_generate(jp, jnp.asarray(enc), jc, max_new_tokens=9,
                           eos_id=seq2seq_t5.EOS)
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))


def test_asr_whisper_stages_match_jax():
    args = asr_whisper.parse(["--steps", "3", "--batch", "4", "--slots", "3",
                              *CPU])
    cfg = asr_whisper.config(args)
    jc = as_jax(cfg, jwhisper.WhisperConfig)
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(
        jwhisper.init_whisper_params, static_argnums=1)(
            jax.random.PRNGKey(0), jc))
    out = asr_whisper.run(args, params=whisper_params_from_jax(
        jp, cfg, device="cpu"))
    oc = as_jax(asr_whisper.opt_config(args), jtrain.OptConfig)
    step = jax.jit(jwhisper.make_whisper_train_step(jc, oc))
    jp, opt, losses = jax_tree(jp), jtrain.init_opt_state(jp, oc), []
    rng = np.random.RandomState(0)
    cpu = torch.device("cpu")
    for _ in range(3):
        wave, labels = asr_whisper.make_batch(rng, 4, 3)
        feats = asr_whisper.features(wave, cfg, cpu).numpy()
        jp, opt, loss = step(jp, opt, feats, labels)
        losses.append(float(loss))
    losses_close(out["losses"], losses)
    wave, _ = asr_whisper.make_batch(np.random.RandomState(123), 32, 3)
    want = jwhisper.whisper_generate(
        jp, jnp.asarray(asr_whisper.features(wave, cfg, cpu).numpy()), jc,
        max_new_tokens=4)
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))


def test_caption_multimodal_stages_match_jax():
    args = caption_multimodal.parse(["--steps", "3", "--batch", "4", *CPU])
    cfg = caption_multimodal.CFG
    jc = jvision.MultimodalConfig(
        vit=as_jax(cfg.vit, jvision.ViTConfig),
        text=as_jax(cfg.text, jtf.TransformerConfig))
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(
        jvision.init_multimodal_params, static_argnums=1)(
            jax.random.PRNGKey(0), jc))
    out = caption_multimodal.run(args, params=multimodal_params_from_jax(
        jp, cfg, device="cpu"))
    oc = as_jax(caption_multimodal.opt_config(args), jtrain.OptConfig)

    @jax.jit
    def step(params, opt, img, inp, tgt):
        loss, grads = jax.value_and_grad(jvision.multimodal_loss)(
            params, img, inp, tgt, jc)
        params, opt = jtrain.apply_update(params, grads, opt, oc)
        return params, opt, loss

    jp, opt, losses = jax_tree(jp), jtrain.init_opt_state(jp, oc), []
    rng = np.random.RandomState(0)
    for _ in range(3):
        jp, opt, loss = step(jp, opt,
                             *caption_multimodal.make_batch(rng, 4))
        losses.append(float(loss))
    losses_close(out["losses"], losses)
    img, _, _ = caption_multimodal.make_batch(np.random.RandomState(123), 64)
    # the JAX loop of the example, over a fixed (64, 3) buffer so that one
    # compiled forward serves every step (position i sees tokens <= i)
    fwd = jax.jit(functools.partial(jvision.multimodal_forward, cfg=jc))
    buf = np.zeros((64, 3), np.int32)
    buf[:, 0] = caption_multimodal.BOS
    got = []
    for i in range(3):
        got.append(np.asarray(jnp.argmax(
            fwd(jp, jnp.asarray(img), jnp.asarray(buf))[:, i], axis=-1)))
        if i < 2:
            buf[:, i + 1] = got[-1]
    np.testing.assert_array_equal(out["tokens"], np.stack(got, axis=1))


def test_generate_dit_stages_match_jax_on_the_ports_draws(monkeypatch):
    draws = []

    def recorded(*a, **kw):
        draws.append(real(*a, **kw))
        return draws[-1]

    real = tdit.draw_loss_inputs
    monkeypatch.setattr(tdit, "draw_loss_inputs", recorded)
    args = generate_dit.parse(["--steps", "3", "--batch", "4", *CPU])
    cfg = generate_dit.CFG
    jc = as_jax(cfg, jdit.DiTConfig)
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(
        jdit.init_dit_params, static_argnums=1)(jax.random.PRNGKey(0), jc))
    out = generate_dit.run(args, params=dit_params_from_jax(jp, cfg,
                                                            device="cpu"))
    assert len(draws) == 3
    oc = as_jax(generate_dit.opt_config(args), jtrain.OptConfig)

    @jax.jit
    def step(params, opt, images, t, noise, y):
        def loss(p):
            xt = jdit.q_sample(images, t, noise, jdit.alphas_bar(jc))
            return jnp.mean(jnp.square(jdit.dit_forward(p, xt, t, y, jc)
                                       - noise))

        lv, grads = jax.value_and_grad(loss)(params)
        params, opt = jtrain.apply_update(params, grads, opt, oc)
        return params, opt, lv

    jp, opt, losses = jax_tree(jp), jtrain.init_opt_state(jp, oc), []
    rng = np.random.RandomState(0)
    for t, noise, y in draws:
        img, _ = generate_dit.make_batch(rng, 4, cfg.image_size)
        jp, opt, loss = step(jp, opt, img, t.numpy(), noise.numpy(),
                             y.numpy())
        losses.append(float(loss))
    losses_close(out["losses"], losses)
    assert out["contrast"].shape == (16,)


# -- zb_pipeline --------------------------------------------------------------


def test_zb_pipeline_main_loss_falls_as_the_jax_steps():
    out = zb_pipeline.main(CPU)
    assert out["losses"][-1] < out["losses"][0]
    assert out["cost"] == jzb.schedule_cost(zb_pipeline.N_STAGES,
                                            zb_pipeline.N_MICRO)
    layers, targets, x = zb_pipeline.data()
    params = jpipe.stack_stages([jax_tree(lay) for lay in layers],
                                zb_pipeline.N_STAGES)
    tg = jnp.asarray(targets)

    def stage_fn(sp, h):
        h, _ = jax.lax.scan(
            lambda c, lp: (jnp.tanh(c @ lp["w"] + lp["b"]), None), h, sp)
        return h

    def loss_fn(y, i):
        t = jax.lax.dynamic_index_in_dim(tg, i, 0, keepdims=False)
        return jnp.mean((y - t) ** 2)

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:zb_pipeline.N_STAGES]),
                             ("pp",))
    step = jax.jit(jzb.make_zb_train_step(stage_fn, loss_fn, mesh,
                                          n_micro=zb_pipeline.N_MICRO))
    losses = []
    with mesh:
        for _ in range(3):
            loss, grads = step(params, jnp.asarray(x))
            params = jax.tree_util.tree_map(
                lambda p, g: p - zb_pipeline.LR * g.astype(p.dtype), params,
                grads)
            losses.append(float(loss))
    losses_close(out["losses"][:3], losses)
