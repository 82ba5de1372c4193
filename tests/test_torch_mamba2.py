"""Port parity: Mamba-2 (kfunca_tpu_torch/models/mamba2.py).

Both packages get the same weights (the JAX init_mamba2_params, carried
across by models/weights.mamba2_params_from_jax) and the same numpy inputs,
fp32 on the CPU.  Held: the chunked SSD at chunks 1, 8 and 16 and its
chunk-size invariance, the forward at one and two B/C groups, the loss and
every gradient, one AdamW step, the recurrent step against the parallel
form, greedy generation, and a directory written by transformers'
Mamba2ForCausalLM.save_pretrained read without transformers.  Outputs
within 1e-5 x max(1, max |ref|), gradients 1e-4 of each leaf's largest
entry, a step's loss 1e-5 and params 1e-4 x max(1, max |ref|).

The reference's fault is held too: at 32 heads and chunk 256 the JAX
_segsum_decay overflows above the diagonal and its gradients are NaN,
where the port's, masked before the exponential, are finite.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import mamba2 as jm
from kfunca_tpu.models import train as jtr
from kfunca_tpu_torch.models import mamba2 as tm
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models.weights import (
    mamba2_params_from_jax, opt_state_from_jax, tree_to_numpy)
from torch_parity import close, one_thread, same_shapes, trees_close  # noqa: F401

SMALL = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, head_dim=16,
             d_state=16, n_groups=1, chunk_size=8, dtype="float32")
OUT_TOL, GRAD_TOL, LOSS_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5, 1e-4


def _model(groups=1, seed=0, **kw):
    jc = jm.Mamba2Config(**{**SMALL, "n_groups": groups, **kw})
    tc = tm.Mamba2Config(**dataclasses.asdict(jc))
    jp = jm.init_mamba2_params(jax.random.PRNGKey(seed), jc)
    return jc, jp, tc, mamba2_params_from_jax(jp, tc, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {g: _model(g) for g in (1, 2)}


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX references, jitted once a module (the config static)."""
    return {
        "forward": jax.jit(jm.forward, static_argnums=2),
        "grad": jax.jit(jax.value_and_grad(jm.loss_fn), static_argnums=3),
        "ssd": jax.jit(jm.ssd, static_argnums=4),
    }


def _tokens(seed, b, s, v=96):
    return np.random.default_rng(seed).integers(2, v, (b, s)).astype(np.int32)


def _ssd_inputs(b=2, L=16, h=3, p=4, n=5, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, L, h, p)).astype(np.float32),
            (-rng.uniform(0.01, 0.5, (b, L, h))).astype(np.float32),
            rng.normal(size=(b, L, h, n)).astype(np.float32),
            rng.normal(size=(b, L, h, n)).astype(np.float32))


@pytest.mark.parametrize("chunk", [1, 8, 16])
def test_ssd_matches_jax(jax_fns, chunk):
    x = _ssd_inputs()
    want = jax_fns["ssd"](*(jnp.asarray(a) for a in x), chunk)
    got = tm.ssd(*(torch.from_numpy(a) for a in x), chunk)
    close(got.numpy(), want, OUT_TOL, f"chunk {chunk}")


def test_ssd_is_chunk_size_invariant():
    x = [torch.from_numpy(a) for a in _ssd_inputs(L=24, seed=7)]
    a, b = tm.ssd(*x, 4), tm.ssd(*x, 12)
    close(a.numpy(), b.numpy(), OUT_TOL)
    with pytest.raises(ValueError, match="not a multiple"):
        tm.ssd(*x, 5)


def test_segsum_decay_is_the_jax_mask_where_finite():
    a = np.random.default_rng(3).uniform(-0.6, -0.01, (2, 3, 8)).astype(
        np.float32)
    want = np.asarray(jm._segsum_decay(jnp.asarray(a)))
    got = tm._segsum_decay(torch.from_numpy(a)).numpy()
    close(got, want, OUT_TOL)
    assert (got[..., np.triu_indices(8, 1)[0], np.triu_indices(8, 1)[1]]
            == 0).all()


@pytest.mark.parametrize("groups", [1, 2])
def test_forward_matches_jax(models, jax_fns, groups):
    jc, jp, tc, tp = models[groups]
    tok = _tokens(1, 2, 16)
    want = jax_fns["forward"](jp, jnp.asarray(tok), jc)
    got = tm.forward(tp, torch.from_numpy(tok), tc)
    assert got.shape == (2, 16, 96) and got.dtype == torch.float32
    close(got.numpy(), want, OUT_TOL)


def test_forward_picks_a_chunk_that_divides_the_length(models, jax_fns):
    """L = 12 is no multiple of chunk 8: both packages fall back to 4."""
    jc, jp, tc, tp = models[1]
    assert tm._pick_chunk(12, tc) == jm._pick_chunk(12, jc) == 4
    tok = _tokens(2, 1, 12)
    want = jax_fns["forward"](jp, jnp.asarray(tok), jc)
    close(tm.forward(tp, torch.from_numpy(tok), tc).numpy(), want, OUT_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_loss_and_grads_match_jax(models, jax_fns, groups):
    jc, jp, tc, tp = models[groups]
    tok = _tokens(3, 2, 16)
    tgt = np.roll(tok, -1, axis=1)
    tgt[0, -3:] = jm.IGNORE
    want_l, want_g = jax_fns["grad"](jp, jnp.asarray(tok), jnp.asarray(tgt),
                                     jc)
    loss, grads = ttr._value_and_grad(
        lambda p, t, y: tm.loss_fn(p, t, y, tc), tp, torch.from_numpy(tok),
        torch.from_numpy(tgt))
    assert abs(float(loss) - float(want_l)) <= LOSS_TOL
    trees_close(grads, want_g, GRAD_TOL)


def test_train_step_matches_jax(models):
    jc, jp, tc, tp = models[2]
    oc_kw = dict(lr=1e-3, weight_decay=0.1)
    jstep = jax.jit(jm.make_mamba2_train_step(jc, jtr.OptConfig(**oc_kw)))
    tstep = tm.make_mamba2_train_step(tc, ttr.OptConfig(**oc_kw),
                                      device="cpu")
    jopt = jtr.init_opt_state(jp)
    tp2 = mamba2_params_from_jax(jp, tc, device="cpu")
    topt = opt_state_from_jax(jopt, device="cpu")
    tok = _tokens(4, 2, 16)
    tgt = np.roll(tok, -1, axis=1)
    jp2, jopt2, jl = jstep(jp, jopt, jnp.asarray(tok), jnp.asarray(tgt))
    tp2, topt2, tl = tstep(tp2, topt, tok, tgt)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    trees_close(tp2, jp2, STEP_TOL, close)


def test_recurrent_step_matches_the_parallel_form(models):
    jc, jp, tc, tp = models[2]
    tok = torch.from_numpy(_tokens(5, 2, 11))
    par = tm.forward(tp, tok, tc)
    states = tm.init_mamba2_state(tc, 2, "cpu")
    for i in range(tok.shape[1]):
        logits, states = tm._token_step(tp, tok[:, i], states, tc)
        close(logits.numpy(), par[:, i].numpy(), OUT_TOL, f"position {i}")


def test_mixer_step_matches_jax(models):
    jc, jp, tc, tp = models[2]
    x = np.random.default_rng(6).normal(size=(2, 32)).astype(np.float32)
    jst = jm.init_mamba2_state(jc, 2)[0]
    jst = {"ssm": jnp.asarray(np.random.default_rng(7).normal(
        size=jst["ssm"].shape).astype(np.float32)),
        "conv": jnp.asarray(np.random.default_rng(8).normal(
            size=jst["conv"].shape).astype(np.float32))}
    want, wst = jm._mixer_step(jnp.asarray(x), jp["layers"][1], jst, jc)
    got, gst = tm._mixer_step(
        torch.from_numpy(x), tp["layers"][1],
        {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}, tc)
    close(got.numpy(), want, OUT_TOL)
    for k in ("ssm", "conv"):
        close(gst[k].numpy(), wst[k], OUT_TOL, k)


@pytest.mark.parametrize("eos", [-1, "first"])
def test_generate_matches_jax(models, eos):
    jc, jp, tc, tp = models[1]
    prompt = _tokens(9, 2, 6)
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt), jc,
                                  max_new_tokens=6))
    eos_id = -1 if eos == -1 else int(want[0, 1])
    if eos != -1:
        want = np.asarray(jm.generate(jp, jnp.asarray(prompt), jc,
                                      max_new_tokens=6, eos_id=eos_id))
        assert (want[0, 2:] == 0).all()
    got = tm.generate(tp, torch.from_numpy(prompt), tc, max_new_tokens=6,
                      eos_id=eos_id)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_jax_gradients_break_where_the_port_holds():
    """The reference's fault: at 32 heads of 4 (A = -1..-32), chunk 256
    and 256 tokens, exp above the diagonal of the JAX decay square passes
    fp32's range and its backward multiplies 0 by inf.  The port's forward
    is the JAX forward, and every port gradient is finite."""
    jc, jp, tc, tp = _model(1, seed=1, n_layers=1, d_model=64, n_heads=32,
                            head_dim=4, chunk_size=256, vocab_size=64)
    tok = _tokens(10, 1, 256, v=64)
    tgt = np.roll(tok, -1, axis=1)
    want = jax.jit(jm.forward, static_argnums=2)(jp, jnp.asarray(tok), jc)
    close(tm.forward(tp, torch.from_numpy(tok), tc).numpy(), want, OUT_TOL)
    _, jg = jax.jit(jax.value_and_grad(jm.loss_fn), static_argnums=3)(
        jp, jnp.asarray(tok), jnp.asarray(tgt), jc)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree_util.tree_leaves(jg))
    loss, grads = ttr._value_and_grad(
        lambda p, t, y: tm.loss_fn(p, t, y, tc), tp, torch.from_numpy(tok),
        torch.from_numpy(tgt))
    assert np.isfinite(float(loss))
    leaves = jax.tree_util.tree_leaves(tree_to_numpy(grads))
    assert all(np.isfinite(g).all() for g in leaves)
    assert any(np.abs(g).max() > 0 for g in leaves)


def test_init_has_the_jax_layout():
    jc = jm.Mamba2Config(**SMALL)
    same_shapes(tm.init_mamba2_params(0, tm.Mamba2Config(**SMALL), "cpu"),
                jm.init_mamba2_params(jax.random.PRNGKey(0), jc))


def test_converter_checks_every_leaf(models):
    jc, jp, tc, tp = models[1]
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["layers"][1]["dt_bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match=r"layers\[1\]\.dt_bias"):
        mamba2_params_from_jax(bad, tc, device="cpu")
    with pytest.raises(ValueError, match="entries for a config of 3"):
        mamba2_params_from_jax(jp, dataclasses.replace(tc, n_layers=3),
                               device="cpu")


def _hf_model(groups, tied):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.Mamba2Config(
        vocab_size=96, hidden_size=32, state_size=16, num_hidden_layers=2,
        conv_kernel=4, expand=2, num_heads=4, head_dim=16, n_groups=groups,
        chunk_size=8, use_cache=False, tie_word_embeddings=tied,
        layer_norm_epsilon=1e-5, rms_norm=True)
    model = transformers.Mamba2ForCausalLM(hf_cfg).eval()
    if not tied:  # the head both packages read: the embedding's transpose
        with torch.no_grad():
            model.lm_head.weight.copy_(model.backbone.embeddings.weight)
    return model


@pytest.mark.parametrize("groups,fmt", [(1, "bin"), (2, "safetensors")])
def test_hf_directory_matches_jax_and_transformers(tmp_path, groups, fmt):
    """save_pretrained's directory (pytorch_model.bin of a tied model, or
    model.safetensors, which refuses tied tensors, of an untied one whose
    head is the embedding's copy) through the port's own readers."""
    model = _hf_model(groups, tied=fmt == "bin")
    model.save_pretrained(tmp_path, safe_serialization=fmt == "safetensors")
    assert (tmp_path / ("model.safetensors" if fmt == "safetensors"
                        else "pytorch_model.bin")).exists()
    jp, jc = jm.from_hf_mamba2(model, dtype="float32")
    tp, tc = tm.from_hf_mamba2(tmp_path, dtype="float32", device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tree_to_numpy(tp))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, w), (_, g) in zip(jl, tl):
        np.testing.assert_array_equal(g, np.asarray(w),
                                      jax.tree_util.keystr(path))
    ip, icfg = tm.from_hf_mamba2(model, dtype="float32", device="cpu")
    assert icfg == tc
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(ip)),
                    jax.tree_util.tree_leaves(tree_to_numpy(tp))):
        np.testing.assert_array_equal(a, b)
    ids = np.random.RandomState(0).randint(2, 96, (2, 9))
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids)).logits.numpy()
    got = tm.forward(tp, torch.from_numpy(ids), tc).numpy()
    assert np.abs(got - ref).max() <= 1e-4, np.abs(got - ref).max()
