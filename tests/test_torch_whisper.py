"""Port parity: the Whisper encoder-decoder
(kfunca_tpu_torch/models/whisper.py).

The same weights (the JAX init_whisper_params, its biases and norms moved
off their init values, carried across by
models/weights.whisper_params_from_jax) and the same numpy inputs go
through both packages on the CPU: the sinusoid table, the conv front end
and encode, the forward, the loss and every gradient with IGNORE labels,
one AdamW step, bf16 activations (the convs on bf16-rounded operands with
fp32 sums), cached greedy generation with and without a forced prompt
(exactly), and the tp forms over LocalMesh meshes against the JAX forward
on shard_whisper_params over the conftest's virtual CPU devices.  fp32
outputs and losses within 1e-5 x max(1, max |ref|), every gradient 1e-5
of its leaf's largest entry, a step's params 1e-4 x max(1, max |ref|);
bf16 at the port's bf16 training-step tolerance, 2^-7.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import whisper as jw
from kfunca_tpu.parallel import mesh as jmesh
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import whisper as tw
from kfunca_tpu_torch.models.weights import (opt_state_from_jax,
                                             whisper_params_from_jax)
from kfunca_tpu_torch.parallel import mesh as tmesh
from torch_parity import (close, one_thread, same_shapes,  # noqa: F401
                          trees_close)

SMALL = dict(vocab_size=96, n_mels=8, d_model=32, n_heads=4, n_enc_layers=1,
             n_dec_layers=2, d_ff=64, max_source_positions=16,
             max_target_positions=32, dtype="float32")
OUT_TOL, GRAD_TOL, LOSS_TOL, STEP_TOL, BF16_TOL = 1e-5, 1e-5, 1e-5, 1e-4, 2**-7


@functools.lru_cache(maxsize=None)
def _model(scaled=False):
    """The JAX init with its zero biases and unit norms drawn off their
    init values, as a trained model's; `scaled` also takes the blocks'
    matrices and the embedding x3, the model the generation tests decode
    with (at the init's scales greedy decoding repeats one token)."""
    jc = jw.WhisperConfig(**SMALL)
    tc = tw.WhisperConfig(**dataclasses.asdict(jc))
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(
        jw.init_whisper_params, static_argnums=1)(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(1)

    def nudge(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                nudge(v)
            elif not isinstance(v, list) and v.ndim == 1:
                tree[k] = v + rng.normal(0, 0.2, v.shape).astype(np.float32)

    nudge(jp)
    for blk in jp["encoder"] + jp["decoder"]:
        nudge(blk)
        if scaled:
            for sub in [v for v in blk.values() if isinstance(v, dict)]:
                for k, v in sub.items():
                    sub[k] = v * np.float32(3) if v.ndim == 2 else v
    if scaled:
        jp["embed"] = jp["embed"] * np.float32(3)
    return jc, jp, tc, whisper_params_from_jax(jp, tc, device="cpu")


def _batch(seed, b=2, t=32, td=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, 8, t)).astype(np.float32)
    dec = rng.integers(2, 96, (b, td)).astype(np.int32)
    return feats, dec


def _labels(seed):
    lab = np.random.default_rng(seed).integers(2, 96, (2, 6)).astype(np.int32)
    lab[0, 4:] = tw.IGNORE
    return lab


# the JAX references, each jitted once (the config static): one compile a
# config and input shape, where eager JAX compiles every primitive
@functools.partial(jax.jit, static_argnums=3)
def _jax_three(jp, feats, dec, jc):
    enc = jw.whisper_encode(jp, feats, jc)
    return (enc, jw.whisper_decode(jp, enc, dec, jc),
            jw.whisper_forward(jp, feats, dec, jc))


_jax_loss = jax.jit(jw.whisper_loss, static_argnums=3)
_jax_update = jax.jit(jtr.apply_update, static_argnums=3)
_jax_loss_grad = jax.jit(jax.value_and_grad(jw.whisper_loss),
                         static_argnums=3)


def test_init_has_the_jax_layout():
    jc, jp, tc, _ = _model()
    same_shapes(tw.init_whisper_params(0, tc, "cpu"), jp)


def test_sinusoid_table_matches_jax():
    """The table's first rows within 1e-6; by row 1499 one fp32 ulp of a
    frequency (torch's and XLA's exp round apart) moves the angle by
    ~1e-4, so the whole table is held at 2e-4."""
    got = tw.sinusoidal_positions(1500, 64, "cpu")
    want = np.asarray(jw.sinusoidal_positions(1500, 64))
    close(got[:16], want[:16], 1e-6)
    close(got, want, 2e-4)


@pytest.mark.parametrize("frames", [32, 30])
def test_encode_and_forward_match_jax(frames):
    """The conv front end (stride 1, then stride 2 with padding 1: an odd
    count of frames out of 30) and the whole forward."""
    jc, jp, tc, tp = _model()
    feats, dec = _batch(2, t=frames)
    jenc, jdec, want = _jax_three(jp, jnp.asarray(feats), jnp.asarray(dec),
                                  jc)
    got = tw.whisper_encode(tp, torch.from_numpy(feats), tc)
    assert got.shape == (2, frames // 2, 32)
    close(got, jenc, OUT_TOL, "encode")
    close(tw.whisper_decode(tp, torch.from_numpy(np.array(jenc)),
                            torch.from_numpy(dec), tc), jdec, OUT_TOL,
          "decode")
    close(tw.whisper_forward(tp, torch.from_numpy(feats),
                             torch.from_numpy(dec), tc), want, OUT_TOL,
          "forward")


def test_bf16_conv_front_end_and_loss_within_the_step_tolerance():
    """bf16 activations: the conv front end (two convs on bf16-rounded
    operands, fp32 sums, fp32 bias and GELU, then the cast; no encoder
    layer) bit for bit the JAX package's; the logits within 2^-7 x max(1,
    max |ref|), the loss within 2^-7 relative."""
    jc, jp, tc, tp = _model()
    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in (jc, tc))
    feats, dec = _batch(3)
    front = [dataclasses.replace(c, n_enc_layers=0) for c in (jc, tc)]
    # eager: under jit XLA's fusion of the conv with its bias, GELU and
    # cast rounds some outputs one bf16 ulp apart from the op's semantics
    want = jw.whisper_encode({**jp, "encoder": []}, jnp.asarray(feats),
                             front[0])
    got = tw.whisper_encode({**tp, "encoder": []}, torch.from_numpy(feats),
                            front[1])
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    want = _jax_three(jp, jnp.asarray(feats), jnp.asarray(dec), jc)[2]
    close(tw.whisper_forward(tp, torch.from_numpy(feats),
                             torch.from_numpy(dec), tc), want, BF16_TOL)
    lab = _labels(4)
    want = float(_jax_loss(jp, jnp.asarray(feats), jnp.asarray(lab), jc))
    got = float(tw.whisper_loss(tp, feats, lab, tc))
    assert abs(got - want) <= BF16_TOL * abs(want)


def test_conv_rounds_its_operands_and_sums_in_fp32():
    """_conv1d of bf16 activations: the fp32 sum of bf16-rounded products,
    not a bf16 output (a bf16 F.conv1d would round it)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 9, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 4, 6)).astype(np.float32))
    got = tw._conv1d(x.bfloat16(), w, 2)
    assert got.dtype == torch.float32 and got.shape == (1, 5, 6)
    xr, wr = x.bfloat16().float(), w.bfloat16().float()
    want = torch.nn.functional.conv1d(xr.transpose(1, 2), wr.permute(2, 1, 0),
                                      stride=2, padding=1).transpose(1, 2)
    assert torch.allclose(got, want, atol=1e-6)
    want_jax = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy(), jnp.bfloat16), jnp.asarray(w.numpy(),
                                                          jnp.bfloat16),
        (2,), [(1, 1)], dimension_numbers=("NHC", "HIO", "NHC"),
        preferred_element_type=jnp.float32)
    close(got, want_jax, 1e-6)


def test_loss_and_every_gradient_match_jax():
    jc, jp, tc, tp = _model()
    feats, _ = _batch(6)
    lab = _labels(7)
    want_l, want_g = _jax_loss_grad(jp, jnp.asarray(feats), jnp.asarray(lab),
                                    jc)
    loss, _, grads = ttr.value_and_grad_aux(
        lambda p: (tw.whisper_loss(p, feats, lab, tc), None), tp)
    assert abs(float(loss) - float(want_l)) <= LOSS_TOL
    trees_close(grads, want_g, GRAD_TOL)


def test_train_step_matches_jax():
    """make_whisper_train_step against the JAX step's two halves
    (value_and_grad of whisper_loss, then apply_update) on the same params,
    opt state and batch."""
    jc, jp, tc, _ = _model()
    feats, _ = _batch(8)
    lab = _labels(9)
    oc = dict(lr=1e-3)
    jopt = jtr.init_opt_state(jp)
    jl, jg = _jax_loss_grad(jp, jnp.asarray(feats), jnp.asarray(lab), jc)
    jp2, _ = _jax_update(jp, jg, jopt, jtr.OptConfig(**oc))
    step = tw.make_whisper_train_step(tc, ttr.OptConfig(**oc), device="cpu")
    tp2, _, tl = step(whisper_params_from_jax(jp, tc, device="cpu"),
                      opt_state_from_jax(jopt, device="cpu"), feats, lab)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    trees_close(tp2, jp2, STEP_TOL, close)


PROMPT = np.asarray([[5, 9, 40], [7, 3, 61]], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_generated(prompted):
    jc, jp, _, _ = _model(True)
    feats, _ = _batch(10)
    prompt = jnp.asarray(PROMPT) if prompted else None
    return feats, np.asarray(jw.whisper_generate(
        jp, jnp.asarray(feats), jc, max_new_tokens=8, prompt=prompt))


@pytest.mark.parametrize("prompted", [False, True])
def test_generate_gives_the_jax_tokens(prompted):
    """Greedy tokens, with and without a forced prompt, and eos_id after a
    row's EOS (the model's eos_id 1 taken as EOS in the JAX run too)."""
    _, _, tc, tp = _model(True)
    feats, want = _jax_generated(prompted)
    assert len(set(want.ravel().tolist())) >= 3  # not a degenerate model
    got = tw.whisper_generate(tp, torch.from_numpy(feats), tc, 8,
                              None if not prompted else
                              torch.from_numpy(PROMPT))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_generate_writes_eos_after_eos():
    """With the first generated token taken as EOS, every later position
    holds it: the JAX rule (eos_id after EOS, where T5 writes pad_id)."""
    jc, jp, tc, tp = _model(True)
    feats, full = _jax_generated(False)
    eos = int(full[0, 1])
    jc2, tc2 = (dataclasses.replace(c, eos_id=eos) for c in (jc, tc))
    want = np.asarray(jw.whisper_generate(jp, jnp.asarray(feats), jc2,
                                          max_new_tokens=8))
    got = tw.whisper_generate(tp, torch.from_numpy(feats), tc2, 8)
    assert np.array_equal(got.numpy(), want)
    stop = list(want[0]).index(eos)
    assert (want[0, stop:] == eos).all()


def test_cached_generate_is_the_teacher_forced_argmax():
    _, _, tc, tp = _model(True)
    feats, _ = _batch(11)
    prompt = torch.from_numpy(PROMPT)
    got = tw.whisper_generate(tp, torch.from_numpy(feats), tc, 5, prompt)
    start = torch.full((2, 1), tc.decoder_start_id)
    seq = torch.cat([start, prompt.long(), got[:, :-1].long()], 1)
    logits = tw.whisper_forward(tp, torch.from_numpy(feats), seq, tc)
    assert torch.equal(logits[:, 3:].argmax(-1).int(), got)


def test_specs_match_jax():
    _, jp, _, tp = _model()
    want = jax.tree_util.tree_map(
        tuple, jw.whisper_param_specs(jp),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = jax.tree_util.tree_map(tuple, tw.whisper_param_specs(tp),
                                 is_leaf=lambda x: isinstance(x, tmesh.P))
    assert got == want


@functools.lru_cache(maxsize=None)
def _jax_sharded_forward():
    jc, jp, _, _ = _model()
    feats, dec = _batch(12)
    mesh = jmesh.make_mesh(4, dp=2, tp=2)
    sharded = jw.shard_whisper_params(
        jax.tree_util.tree_map(jnp.asarray, jp), mesh)
    with mesh:
        out = jax.jit(lambda p, f, d: jw.whisper_forward(p, f, d, jc))(
            sharded, jnp.asarray(feats), jnp.asarray(dec))
    return np.asarray(out)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_tp_forward_matches_the_jax_sharded_forward(shape):
    """conv1 over its output channels, conv2 over its input channels (one
    all-reduce before its bias), heads, MLP slices and the embedding's
    d_model slice a rank."""
    _, _, tc, tp = _model()
    feats, dec = _batch(12)
    sp = tw.shard_whisper_params(tp, tmesh.LocalMesh(*shape, "cpu"), tc)
    tpn = shape[1]
    assert sp.local[0]["conv1_w"].shape == (3, 8, 32 // tpn)
    assert sp.local[0]["conv2_w"].shape == (3, 32 // tpn, 32)
    close(tw.whisper_forward(sp, torch.from_numpy(feats),
                             torch.from_numpy(dec), tc),
          _jax_sharded_forward(), OUT_TOL)


def test_tp_generate_and_loss_match_the_single_device():
    _, _, tc, tp = _model(True)
    feats, want = _jax_generated(True)
    sp = tw.shard_whisper_params(tp, tmesh.LocalMesh(1, 2, "cpu"), tc)
    got = tw.whisper_generate(sp, torch.from_numpy(feats), tc, 8,
                              torch.from_numpy(PROMPT))
    assert np.array_equal(got.numpy(), want)
    lab = _labels(13)
    assert abs(float(tw.whisper_loss(sp, feats, lab, tc))
               - float(tw.whisper_loss(tp, feats, lab, tc))) <= LOSS_TOL


def test_shard_refuses_a_tp_that_splits_a_head():
    _, _, tc, tp = _model()
    with pytest.raises(ValueError, match="does not divide"):
        tw.shard_whisper_params(tp, tmesh.LocalMesh(1, 8, "cpu"), tc)


def test_converter_checks_every_leaf():
    jc, jp, tc, _ = _model()
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["decoder"][0]["attn"]["bk"] = np.zeros(32, np.float32)
    with pytest.raises(ValueError, match="bk"):
        whisper_params_from_jax(bad, tc, device="cpu")
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["conv1_w"] = bad["conv1_w"].transpose(2, 1, 0)
    with pytest.raises(ValueError, match="conv1_w"):
        whisper_params_from_jax(bad, tc, device="cpu")
