"""Port parity: the optimizers and the training step.

Both packages start a step from the same (params, opt_state): the JAX
init_params and init_opt_state, carried across by models/weights.  The same
numpy batches go through three steps of make_train_step in each, and the
params and every optimizer-state leaf are compared.  fp32 throughout;
tolerances are relative to each leaf's largest entry, since a leaf's small
entries carry the absolute rounding error of its large ones.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import (
    opt_state_from_jax, params_from_jax, tree_to_numpy)

CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=96, max_seq_len=32, dtype="float32", attention_window=8)
RICH = dict(state_dtype="bfloat16", clip_norm=0.5, warmup_steps=2,
            total_steps=10, ema_decay=0.9, decay_mask_1d=False)
OPTS = {
    "adamw": dict(algo="adamw"),
    "sgd": dict(algo="sgd", lr=1e-2),
    "sgd_nesterov": dict(algo="sgd", lr=1e-2, nesterov=True),
    "lion": dict(algo="lion"),
    "adafactor": dict(algo="adafactor", lr=1e-2, clip_norm=1.0),
    "muon": dict(algo="muon", lr=1e-2, warmup_steps=1),
    "adamw_rich": dict(algo="adamw", **RICH),
    "muon_bf16_state": dict(algo="muon", lr=1e-3, state_dtype="bfloat16",
                            ema_decay=0.5),
}


def _batches(n=3, batch=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    windows = rng.integers(0, CFG["vocab_size"], (n, batch, seq + 1)).astype(
        np.int32)
    return [(w[:, :-1], w[:, 1:]) for w in windows]


@functools.lru_cache(maxsize=None)
def _jax_start():
    jc = jtf.TransformerConfig(**CFG)
    return jc, jtf.init_params(jax.random.PRNGKey(0), jc)


def _run_both(okw, steps=3, **step_kw):
    """`steps` steps in each package -> ((jax params, state, last out),
    (port params, state, last out)), the port's as numpy trees."""
    jc, jp = _jax_start()
    tc = ttf.TransformerConfig(**CFG)
    joc, toc = jtr.OptConfig(**okw), ttr.OptConfig(**okw)
    jst = jtr.init_opt_state(jp, joc)
    tp = params_from_jax(jp, tc, device="cpu")
    tst = opt_state_from_jax(jst, device="cpu")
    jstep = jax.jit(jtr.make_train_step(jc, joc, **step_kw))
    tstep = ttr.make_train_step(tc, toc, device="cpu", **step_kw)
    jout = tout = None
    for tokens, targets in _batches(steps):
        jp, jst, jout = jstep(jp, jst, jnp.asarray(tokens),
                              jnp.asarray(targets))
        tp, tst, tout = tstep(tp, tst, tokens, targets)
    return (jp, jst, jout), (tree_to_numpy(tp), tree_to_numpy(tst), tout)


def _assert_trees_close(got, want, tol, extra_atol=0.0):
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w, np.float32 if w.dtype == jnp.bfloat16 else None)
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30) if w.size else 1.0
        np.testing.assert_allclose(
            g, w, atol=tol * scale + extra_atol, rtol=tol,
            err_msg=jax.tree_util.keystr(path))


def _assert_state_close(tst, jst, okw, flip=0.0, extra=0.0):
    bf16 = okw.get("state_dtype") == "bfloat16"
    assert sorted(tst) == sorted(jst)
    assert int(tst["step"]) == int(jst["step"])
    for key in jst:
        stored_bf16 = bf16 and key in ("m", "v", "v1")
        _assert_trees_close(tst[key], jst[key],
                            2.0 ** -7 if stored_bf16 else 1e-5,
                            extra_atol=flip + extra if key == "ema" else 0.0)


@pytest.mark.parametrize("name", list(OPTS))
def test_update_rules_match_jax(name):
    """apply_update three times on the SAME gradients (numpy noise of order
    0.1, a new draw each step) in both packages: params and every state
    leaf within 1e-5 of the leaf's largest entry.  This holds the formulas
    themselves (bias corrections, eps inside g^2 + eps, RMS clipping, the
    0-dim dummies, the Newton-Schulz transpose, bf16 storage with fp32
    compute, the EMA) apart from any difference between the two packages'
    gradients.  bf16-stored moments are compared after the same rounding on
    both sides, where a last-bit difference in fp32 can flip one bf16
    rounding (2^-8 relative) of a moment entry, and with it lr * 2^-8 of
    that entry's update."""
    okw = OPTS[name]
    jc, jp = _jax_start()
    joc, toc = jtr.OptConfig(**okw), ttr.OptConfig(**okw)
    jst = jtr.init_opt_state(jp, joc)
    tp = params_from_jax(jp, ttf.TransformerConfig(**CFG), device="cpu")
    tst = opt_state_from_jax(jst, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 0.1).astype(np.float32),
            jp)
        jp, jst = jtr.apply_update(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), jst, joc)
        tp, tst = ttr.apply_update(
            tp, jax.tree_util.tree_map(torch.from_numpy, grads), tst, toc)
    flip = toc.lr * 2.0 ** -8 if okw.get("state_dtype") == "bfloat16" else 0.0
    _assert_trees_close(tree_to_numpy(tp), jp, 1e-5, extra_atol=flip)
    _assert_state_close(tree_to_numpy(tst), jst, okw, flip)


@pytest.mark.parametrize("name", list(OPTS))
def test_three_steps_match_jax(name):
    """Three whole steps (loss, gradients, update) from a shared start.
    The two packages' gradients agree to ~1e-6 of a leaf's largest entry
    (fp32 sums in another order), and for sgd, whose update is linear in
    the gradient, so do the params: 1e-5.  Every other rule divides an
    entry's gradient by its own size (adamw, lion's sign, adafactor, muon's
    orthogonalization), which turns the RELATIVE error of an entry, up to
    ~1e-2 where the entry's sum nearly cancels, into that share of an
    lr-sized update: 1e-2 * lr a step on top.  The exact formulas are held
    to 1e-5 in test_update_rules_match_jax."""
    okw = OPTS[name]
    (jp, jst, _), (tp, tst, _) = _run_both(okw)
    lr = ttr.OptConfig(**okw).lr
    flip = lr * 2.0 ** -8 if okw.get("state_dtype") == "bfloat16" else 0.0
    extra = 0.0 if okw["algo"] == "sgd" else 3 * 1e-2 * lr
    _assert_trees_close(tp, jp, 1e-5, extra_atol=flip + extra)
    assert int(tst["step"]) == 3
    _assert_state_close(tst, jst, okw, flip, extra)


def test_state_layout_and_dtypes_match_jax():
    """init_opt_state builds the JAX layout: the same keys, shapes and
    dtypes, 0-dim dummies in the unused slots, int32 step."""
    jc, jp = _jax_start()
    tp = params_from_jax(jp, ttf.TransformerConfig(**CFG), device="cpu")
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int32: "int32"}
    for okw in list(OPTS.values()) + [None]:
        joc = None if okw is None else jtr.OptConfig(**okw)
        toc = None if okw is None else ttr.OptConfig(**okw)
        jst = jtr.init_opt_state(jp, joc)
        tst = ttr.init_opt_state(tp, toc, device="cpu")
        jl = jax.tree_util.tree_leaves_with_path(jst)
        tl = jax.tree_util.tree_leaves_with_path(tst)
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (path, j), (_, t) in zip(jl, tl):
            assert tuple(t.shape) == j.shape, path
            assert names[t.dtype] == j.dtype.name, path


def test_grad_accum_matches_jax_and_the_full_batch():
    okw = dict(algo="adamw", clip_norm=1.0)
    (jp, jst, jloss), (tp, tst, tloss) = _run_both(okw, steps=2, grad_accum=2)
    lr_term = 2 * 1e-2 * 3e-4  # adamw: see test_three_steps_match_jax
    _assert_trees_close(tp, jp, 1e-5, extra_atol=lr_term)
    _assert_trees_close(tst["v"], jst["v"], 1e-5)
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    _, (fp, fst, floss) = _run_both(okw, steps=2)
    _assert_trees_close(tp, fp, 1e-5, extra_atol=lr_term)
    assert float(tloss) == pytest.approx(float(floss), abs=1e-5)
    tc = ttf.TransformerConfig(**CFG)
    params = ttf.init_params(0, tc, device="cpu")
    step = ttr.make_train_step(tc, grad_accum=3, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        step(params, ttr.init_opt_state(params, device="cpu"), *_batches(1)[0])


def test_loss_chunk_and_ignore_index_match_jax():
    okw = dict(algo="adamw")
    (jp, _, jloss), (tp, _, tloss) = _run_both(
        okw, steps=2, loss_chunk=48, ignore_index=5)
    # adamw: see test_three_steps_match_jax for the lr term
    _assert_trees_close(tp, jp, 1e-5, extra_atol=2 * 1e-2 * 3e-4)
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)


def test_with_metrics_matches_jax():
    (_, _, jm), (_, _, tm) = _run_both(OPTS["adamw_rich"], with_metrics=True)
    assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr", "step"]
    assert int(tm["step"]) == int(jm["step"]) == 3
    assert tm["step"].dtype == torch.int32
    for key in ("loss", "grad_norm", "lr"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5)


def test_schedule_lr_matches_jax():
    """Computed in fp32 on both sides: equal to the last bit or two."""
    for okw in ({}, {"warmup_steps": 5}, {"total_steps": 30},
                {"warmup_steps": 4, "total_steps": 20, "min_lr_frac": 0.25}):
        joc, toc = jtr.OptConfig(**okw), ttr.OptConfig(**okw)
        for step in (1, 2, 4, 5, 11, 20, 35):
            want = float(jtr.schedule_lr(joc, jnp.int32(step)))
            got = ttr.schedule_lr(toc, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.ndim == 0
            assert float(got) == pytest.approx(want, rel=3e-7)
            assert float(ttr.schedule_lr(toc, step)) == pytest.approx(
                want, rel=3e-7)


def test_newton_schulz_transposes_tall_matrices():
    rng = np.random.default_rng(1)
    for shape in ((8, 24), (24, 8), (2, 12, 5)):
        g = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(jtr._newton_schulz5(jnp.asarray(g)))
        got = ttr._newton_schulz5(torch.from_numpy(g)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_global_norm_and_ema_params():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    want = float(jtr.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    assert float(ttr.global_norm(ttree)) == pytest.approx(want, rel=1e-6)
    ema = ttr.ema_params({"ema": ttree}, torch.bfloat16)
    assert ema["a"].dtype == torch.bfloat16 and ttr.ema_params(
        {"ema": ttree})["b"][0] is ttree["b"][0]


def test_update_writes_in_place_and_returns_the_same_tensors():
    tc = ttf.TransformerConfig(**CFG)
    params = ttf.init_params(0, tc, device="cpu")
    opt = ttr.init_opt_state(params, device="cpu")
    before = params["blocks"][0]["wqkv"].clone()
    step = ttr.make_train_step(tc, device="cpu")
    new_params, new_opt, loss = step(params, opt, *_batches(1)[0])
    assert new_params["blocks"][0]["wqkv"] is params["blocks"][0]["wqkv"]
    assert new_opt["m"]["embed"] is opt["m"]["embed"]
    assert not torch.equal(params["blocks"][0]["wqkv"], before)
    assert int(new_opt["step"]) == 1 and int(opt["step"]) == 0
    assert loss.ndim == 0 and not loss.requires_grad
    assert not any(p.requires_grad for p in jax.tree_util.tree_leaves(params))


def test_unknown_algo_and_unported_entry_points_raise():
    tc = ttf.TransformerConfig(**CFG)
    params = ttf.init_params(0, tc, device="cpu")
    oc = ttr.OptConfig(algo="adamax")
    step = ttr.make_train_step(tc, oc, device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer algo 'adamax'"):
        step(params, ttr.init_opt_state(params, oc, device="cpu"),
             *_batches(1)[0])
    # the sharded step is ported (tests/test_torch_sharded_train.py); what
    # is not a mesh is refused
    with pytest.raises(TypeError, match="LocalMesh or a DeviceMesh"):
        ttr.make_sharded_train_step(tc, None)


def test_opt_config_mirrors_jax_fields():
    import dataclasses

    jf = [(f.name, f.default) for f in dataclasses.fields(jtr.OptConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ttr.OptConfig)]
    assert tf == jf
