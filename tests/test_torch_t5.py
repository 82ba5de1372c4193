"""Port parity: the T5 encoder-decoder (kfunca_tpu_torch/models/t5.py).

The same weights (the JAX init_t5_params, its norms and bias tables moved
off their init values, carried across by models/weights.t5_params_from_jax)
and the same numpy inputs go through both packages on the CPU, for both
generations (ReLU with the tied, rescaled head; gated GELU with an untied
head): the relative-position buckets for every offset in +-4 x max_distance
(exactly), encode / decode / forward under padding masks, the loss and
every gradient with IGNORE labels, one AdamW step, cached greedy
generation (exactly, with EOS padding), the HF interop through a directory
that transformers' save_pretrained writes and read without transformers,
the export round trip, and the tp forms over LocalMesh meshes against the
JAX forward on shard_t5_params over the conftest's virtual CPU devices.
fp32 outputs and losses within 1e-5 x max(1, max |ref|), every gradient
1e-5 of its leaf's largest entry, a step's params 1e-4 x max(1, max |ref|);
bf16 activations at the port's bf16 training-step tolerance, 2^-7.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import t5 as jt5
from kfunca_tpu.models import train as jtr
from kfunca_tpu.parallel import mesh as jmesh
from kfunca_tpu_torch.models import t5 as tt5
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models.weights import (opt_state_from_jax,
                                             t5_params_from_jax)
from kfunca_tpu_torch.parallel import mesh as tmesh
from torch_parity import (close, one_thread, same_shapes,  # noqa: F401
                          trees_close)

SMALL = dict(vocab_size=96, d_model=32, n_heads=4, d_kv=4, d_ff=64,
             n_enc_layers=2, n_dec_layers=2, dtype="float32")
ARCHS = {"relu": dict(mlp_type="relu", tied_head=True),
         "gated": dict(mlp_type="gated-gelu", tied_head=False)}
OUT_TOL, GRAD_TOL, LOSS_TOL, STEP_TOL, BF16_TOL = 1e-5, 1e-5, 1e-5, 1e-4, 2**-7


@functools.lru_cache(maxsize=None)
def _model(arch, scaled=False):
    """The JAX init with its norms moved off 1, as a trained model's;
    `scaled` also takes the sub-layers' matrices x3 and the embedding
    x0.2, the model the generation tests decode with (at the init's
    scales greedy decoding repeats its first token)."""
    jc = jt5.T5Config(**SMALL, **ARCHS[arch])
    tc = tt5.T5Config(**dataclasses.asdict(jc))
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(
        jt5.init_t5_params, static_argnums=1)(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(1)
    for stack in ("encoder", "decoder"):
        for blk in jp[stack]:
            for k in [k for k in blk if k.endswith("norm")]:
                blk[k] = blk[k] + rng.normal(0, 0.2, blk[k].shape).astype(
                    np.float32)
            if scaled:
                for k in [k for k in blk if not k.endswith("norm")]:
                    blk[k] = {n: w * np.float32(3) for n, w in blk[k].items()}
    if scaled:
        jp["embed"] = jp["embed"] * np.float32(0.2)
    return jc, jp, tc, t5_params_from_jax(jp, tc, device="cpu")


def _batch(seed, b=2, s=9, t=6):
    rng = np.random.default_rng(seed)
    enc = rng.integers(2, 96, (b, s)).astype(np.int32)
    dec = rng.integers(2, 96, (b, t)).astype(np.int32)
    valid = np.ones((b, s), bool)
    valid[1, 6:] = False
    return enc, dec, valid


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


# the JAX references, each jitted once (the config static): one compile a
# config and input shape, where eager JAX compiles every primitive
@functools.partial(jax.jit, static_argnums=4)
def _jax_three(jp, enc, dec, valid, jc):
    e = jt5.t5_encode(jp, enc, jc, valid)
    return (e, jt5.t5_decode(jp, e, dec, jc, valid),
            jt5.t5_forward(jp, enc, dec, jc, valid))


_jax_update = jax.jit(jtr.apply_update, static_argnums=3)
_jax_loss_grad = jax.jit(jax.value_and_grad(jt5.t5_loss), static_argnums=3)
_jax_loss = jax.jit(jt5.t5_loss, static_argnums=3)


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_has_the_jax_layout(arch):
    jc, jp, tc, _ = _model(arch)
    same_shapes(tt5.init_t5_params(0, tc, "cpu"), jp)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (16, 128), (32, 64)])
def test_buckets_equal_jax_for_every_offset(bidirectional, buckets, distance):
    """Every offset in +-512 (at least +-4 x max_distance), both
    directions: the float32 log truncated to an integer gives the JAX
    bucket exactly."""
    rel = np.arange(-4 * 128, 4 * 128 + 1, dtype=np.int32)  # one shape
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(rel), bidirectional, buckets, distance))
    got = tt5.relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                       buckets, distance)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    table = tt5._host_buckets(3, 5, 300, bidirectional, buckets, distance)
    rel = np.arange(300)[None, :] - np.arange(3, 8)[:, None]
    assert np.array_equal(table.numpy(), got.numpy()[rel + 512])


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("masked", [False, True])
def test_encode_decode_forward_match_jax(arch, masked):
    jc, jp, tc, tp = _model(arch)
    enc, dec, valid = _batch(2)
    valid = valid if masked else None
    jenc, jdec, want = _jax_three(jp, *_j(enc, dec, valid), jc)
    tenc = tt5.t5_encode(tp, *_t(enc), tc, *_t(valid))
    close(tenc, jenc, OUT_TOL, "encode")
    close(tt5.t5_decode(tp, jenc, *_t(dec), tc, *_t(valid)), jdec, OUT_TOL,
          "decode")
    got = tt5.t5_forward(tp, *_t(enc, dec), tc, *_t(valid))
    assert got.shape == (2, 6, 96) and got.dtype == torch.float32
    close(got, want, OUT_TOL, "forward")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_padded_keys_change_nothing(arch):
    """Another token in a padded encoder slot leaves every valid position's
    encoding and every decoder logit as they were."""
    _, _, tc, tp = _model(arch)
    enc, dec, valid = _batch(3)
    enc2 = enc.copy()
    enc2[~valid] = 5
    a = tt5.t5_forward(tp, *_t(enc, dec), tc, *_t(valid))
    b = tt5.t5_forward(tp, *_t(enc2, dec), tc, *_t(valid))
    close(a, b, OUT_TOL)


def _labels(seed):
    lab = np.random.default_rng(seed).integers(2, 96, (2, 6)).astype(np.int32)
    lab[0, 4:] = tt5.IGNORE
    lab[1, 5] = tt5.IGNORE
    return lab


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("scaled,tol", [(False, GRAD_TOL), (True, 1e-4)])
def test_loss_and_every_gradient_match_jax(arch, scaled, tol):
    """At the init's scales every gradient within 1e-5 of its leaf's
    largest entry; the generation model's larger matrices amplify the two
    frameworks' fp32 roundings to about 6e-5 (held at 1e-4)."""
    jc, jp, tc, tp = _model(arch, scaled)
    enc, _, valid = _batch(4)
    lab = _labels(5)
    assert np.array_equal(tt5.shift_right(torch.from_numpy(lab), tc).numpy(),
                          np.asarray(jt5.shift_right(jnp.asarray(lab), jc)))
    want_l, want_g = _jax_loss_grad(jp, *_j(enc, lab), jc, *_j(valid))
    loss, _, grads = ttr.value_and_grad_aux(
        lambda p: (tt5.t5_loss(p, enc, lab, tc, valid), None), tp)
    assert abs(float(loss) - float(want_l)) <= LOSS_TOL
    trees_close(grads, want_g, tol)


def test_train_step_matches_jax():
    """One AdamW step of make_t5_train_step against the JAX step's two
    halves (value_and_grad of t5_loss, then apply_update) on the same
    params, opt state and batch (IGNORE labels included), for the untied
    model (the relu model's gradients are held above)."""
    jc, jp, tc, _ = _model("gated")
    enc, _, valid = _batch(6)
    lab = _labels(7)
    oc = dict(lr=1e-3)
    jopt = jtr.init_opt_state(jp)
    jl, jg = _jax_loss_grad(jp, *_j(enc, lab), jc, *_j(valid))
    jp2, _ = _jax_update(jp, jg, jopt, jtr.OptConfig(**oc))
    step = tt5.make_t5_train_step(tc, ttr.OptConfig(**oc), device="cpu")
    tp2, _, tl = step(t5_params_from_jax(jp, tc, device="cpu"),
                      opt_state_from_jax(jopt, device="cpu"), enc, lab, valid)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    trees_close(tp2, jp2, STEP_TOL, close)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bf16_forward_and_loss_within_the_step_tolerance(arch):
    """bf16 activations (params fp32): the logits within 2^-7 x max(1,
    max |ref|) and the loss within 2^-7 relative of the JAX package's."""
    jc, jp, tc, tp = _model(arch)
    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in (jc, tc))
    enc, dec, valid = _batch(8)
    close(tt5.t5_forward(tp, *_t(enc, dec), tc, *_t(valid)),
          _jax_three(jp, *_j(enc, dec, valid), jc)[2], BF16_TOL)
    lab = _labels(9)
    want = float(_jax_loss(jp, *_j(enc, lab), jc, *_j(valid)))
    got = float(tt5.t5_loss(tp, enc, lab, tc, valid))
    assert abs(got - want) <= BF16_TOL * abs(want)


@functools.lru_cache(maxsize=None)
def _jax_generated(arch):
    """JAX t5_generate of one batch (one padded row) with no EOS."""
    jc, jp, _, _ = _model(arch, True)
    enc, _, valid = _batch(10)
    full = np.asarray(jt5.t5_generate(jp, *_j(enc), jc, max_new_tokens=8,
                                      eos_id=-1, enc_valid=jnp.asarray(valid)))
    return enc, valid, full


@pytest.mark.parametrize("arch", list(ARCHS))
def test_generate_gives_the_jax_tokens(arch):
    _, _, tc, tp = _model(arch, True)
    enc, valid, full = _jax_generated(arch)
    assert len(set(full.ravel().tolist())) > 3  # not a degenerate model
    got = tt5.t5_generate(tp, *_t(enc), tc, 8, eos_id=-1,
                          enc_valid=torch.from_numpy(valid))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), full)


def test_generate_pads_after_eos_as_jax():
    """An EOS that stops row 0 at its third token: pad_id after it, the
    JAX t5_generate's tokens exactly."""
    jc, jp, tc, tp = _model("relu", True)
    enc, valid, full = _jax_generated("relu")
    eos = int(full[0, 2])
    want = np.asarray(jt5.t5_generate(jp, *_j(enc), jc, max_new_tokens=8,
                                      eos_id=eos,
                                      enc_valid=jnp.asarray(valid)))
    got = tt5.t5_generate(tp, *_t(enc), tc, 8, eos_id=eos,
                          enc_valid=torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), want)
    assert (want[0, 3:] == tc.pad_id).all()


def test_cached_generate_is_the_teacher_forced_argmax():
    """Each cached step's token is the argmax of the uncached forward over
    the tokens so far."""
    _, _, tc, tp = _model("gated", True)
    enc, _, valid = _batch(11)
    got = tt5.t5_generate(tp, *_t(enc), tc, 6, eos_id=-1,
                          enc_valid=torch.from_numpy(valid))
    dec = torch.full((2, 1), tc.decoder_start_id)
    logits = tt5.t5_forward(tp, torch.from_numpy(enc),
                            torch.cat([dec, got[:, :-1].long()], 1), tc,
                            torch.from_numpy(valid))
    assert torch.equal(logits.argmax(-1).int(), got)


def test_export_round_trip_and_jax_export():
    """to_hf_t5 gives the JAX to_hf_t5's dict; params_from_hf_t5 of it
    gives the params back."""
    jc, jp, tc, tp = _model("gated")
    sd = tt5.to_hf_t5(tp, tc)
    want = jt5.to_hf_t5(jp, jc)
    assert sorted(sd) == sorted(want)
    for k in sd:
        assert np.array_equal(sd[k], np.asarray(want[k])), k
    trees_close(tt5.params_from_hf_t5(sd, tc, device="cpu"), tp, 0.0)


def test_specs_match_jax():
    for arch in ARCHS:
        jc, jp, _, tp = _model(arch)
        want = jax.tree_util.tree_map(
            tuple, jt5.t5_param_specs(jp, jc),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = jax.tree_util.tree_map(
            tuple, tt5.t5_param_specs(tp, _model(arch)[2]),
            is_leaf=lambda x: isinstance(x, tmesh.P))
        assert got == want


@functools.lru_cache(maxsize=None)
def _jax_sharded_forward(arch):
    """The JAX forward on shard_t5_params over dp 2 x tp 2."""
    jc, jp, _, _ = _model(arch)
    enc, dec, valid = _batch(13)
    mesh = jmesh.make_mesh(4, dp=2, tp=2)
    sharded = jt5.shard_t5_params(
        jax.tree_util.tree_map(jnp.asarray, jp), mesh, jc)
    with mesh:
        out = jax.jit(lambda p, e, d, v: jt5.t5_forward(p, e, d, jc, v))(
            sharded, *_j(enc, dec, valid))
    return np.asarray(out)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tp_forward_matches_the_jax_sharded_forward(arch, shape):
    """The forward over a LocalMesh (each rank its heads, bias-table
    columns, MLP slices and d_model slice of the embedding) against the
    JAX forward on shard_t5_params."""
    _, _, tc, tp = _model(arch)
    enc, dec, valid = _batch(13)
    sp = tt5.shard_t5_params(tp, tmesh.LocalMesh(*shape, "cpu"), tc)
    assert sp.local[0]["enc_rel_bias"].shape == (32, 2)
    assert sp.local[0]["encoder"][0]["attn"]["wo"].shape == (8, 32)
    close(tt5.t5_forward(sp, *_t(enc, dec), tc, torch.from_numpy(valid)),
          _jax_sharded_forward(arch), OUT_TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp_generate_and_loss_match_the_single_device(arch):
    """Generation and the loss over tp 2 give the JAX tokens and the
    unsharded loss."""
    _, _, tc, tp = _model(arch, True)
    enc, valid, full = _jax_generated(arch)
    sp = tt5.shard_t5_params(tp, tmesh.LocalMesh(1, 2, "cpu"), tc)
    got = tt5.t5_generate(sp, *_t(enc), tc, 8, eos_id=-1,
                          enc_valid=torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), full)
    lab = _labels(14)
    assert abs(float(tt5.t5_loss(sp, enc, lab, tc, valid))
               - float(tt5.t5_loss(tp, enc, lab, tc, valid))) <= LOSS_TOL


def test_shard_refuses_a_tp_that_splits_a_head():
    _, _, tc, tp = _model("relu")
    with pytest.raises(ValueError, match="does not divide"):
        tt5.shard_t5_params(tp, tmesh.LocalMesh(1, 8, "cpu"), tc)


def test_converter_checks_every_leaf():
    jc, jp, tc, _ = _model("gated")
    bad = jax.tree_util.tree_map(np.asarray, jp)
    del bad["lm_head"]
    with pytest.raises(ValueError, match="no lm_head"):
        t5_params_from_jax(bad, tc, device="cpu")
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["decoder"][1]["cross"]["wk"] = np.zeros((32, 8), np.float32)
    with pytest.raises(ValueError, match=r"decoder\[1\]\.cross\.wk"):
        t5_params_from_jax(bad, tc, device="cpu")
