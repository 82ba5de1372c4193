"""Port parity: the Mamba family (models/mamba.py).

Both packages get the same weights (the JAX init_mamba_params, carried
across by models/weights.mamba_params_from_jax) and the same numpy inputs.
Held: ssm_apply under both engine settings against the JAX ssm_apply,
mamba_mixer, forward, loss and every gradient, three train steps (params
and AdamW state), greedy generation with and without eos, and the HF
interop against a tiny in-memory transformers MambaForCausalLM.  fp32;
gradients and steps relative to each leaf's largest entry.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import mamba as jm
from kfunca_tpu.models import train as jtr
from kfunca_tpu_torch.models import mamba as tm
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models.weights import (
    mamba_params_from_jax, opt_state_from_jax, tree_to_numpy)

SMALL = dict(vocab_size=96, d_model=32, n_layers=2, d_state=8, d_conv=4,
             expand=2, dt_rank=4, dtype="float32")
ENGINES = ["xla", "pallas"]


def _leaf_close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=tol * scale, rtol=tol, err_msg=what)


def _trees_close(got, want, tol):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        _leaf_close(g, w, tol, jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def model():
    jc = jm.MambaConfig(**SMALL)
    jp = jm.init_mamba_params(jax.random.PRNGKey(0), jc)
    return jc, jp, tm.MambaConfig(**SMALL), mamba_params_from_jax(
        jp, tm.MambaConfig(**SMALL), device="cpu")


@pytest.fixture
def engine(monkeypatch):
    """Sets KFUNCA_SSM_ENGINE for the port's calls only (the JAX package
    reads the same variable, and its Pallas engine needs a TPU)."""
    def use(name):
        if name is None:
            monkeypatch.delenv("KFUNCA_SSM_ENGINE", raising=False)
        else:
            monkeypatch.setenv("KFUNCA_SSM_ENGINE", name)
    yield use
    monkeypatch.delenv("KFUNCA_SSM_ENGINE", raising=False)


def _tokens(seed, b, s, v=96):
    return np.random.default_rng(seed).integers(2, v, (b, s)).astype(np.int32)


def _ssm_inputs(b=2, L=16, di=24, n=8, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        hidden=(rng.normal(size=(b, L, di)) * 0.3).astype(np.float32),
        dt=rng.uniform(0.001, 0.1, (b, L, di)).astype(np.float32),
        Bm=rng.normal(size=(b, L, n)).astype(np.float32),
        C=rng.normal(size=(b, L, n)).astype(np.float32),
        A=(-rng.uniform(0.5, 2.0, (di, n))).astype(np.float32),
        D=rng.normal(size=(di,)).astype(np.float32))


@pytest.mark.parametrize("port_engine", ENGINES)
@pytest.mark.parametrize("chunk", [None, 4])
def test_ssm_apply_matches_jax(port_engine, chunk):
    x = _ssm_inputs()
    want = jax.jit(jm.ssm_apply, static_argnums=(6, 7))(
        *(jnp.asarray(v) for v in x.values()), chunk, "xla")
    got = tm.ssm_apply(*(torch.from_numpy(v) for v in x.values()), chunk,
                       engine=port_engine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_engine_choice_follows_the_environment_and_the_device(monkeypatch):
    cfg = tm.MambaConfig(**SMALL)
    monkeypatch.delenv("KFUNCA_SSM_ENGINE", raising=False)
    assert tm._ssm_engine(cfg, 16, 64, torch.device("cpu")) == "xla"
    assert tm._ssm_engine(cfg, 7, 65, torch.device("cuda")) == "pallas"
    monkeypatch.setenv("KFUNCA_SSM_ENGINE", "xla")
    assert tm._ssm_engine(cfg, 16, 64, torch.device("cuda")) == "xla"
    monkeypatch.setenv("KFUNCA_SSM_ENGINE", "pallas")
    assert tm._ssm_engine(cfg, 16, 64, torch.device("cpu")) == "pallas"
    with pytest.raises(ValueError, match="unknown SSM engine"):
        tm.ssm_apply(*(torch.from_numpy(v) for v in _ssm_inputs().values()),
                     engine="bogus")


@pytest.mark.parametrize("port_engine", ENGINES)
def test_mixer_matches_jax(model, engine, port_engine):
    jc, jp, tc, tp = model
    x = np.random.default_rng(1).normal(size=(2, 12, 32)).astype(np.float32)
    want = jax.jit(jm.mamba_mixer, static_argnums=2)(
        jnp.asarray(x), jp["layers"][0], jc)
    engine(port_engine)
    got = tm.mamba_mixer(torch.from_numpy(x), tp["layers"][0], tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("port_engine", ENGINES)
@pytest.mark.parametrize("scan_chunk", [None, 4])
def test_forward_matches_jax(model, engine, port_engine, scan_chunk):
    jc, jp, tc, tp = model
    jc = dataclasses.replace(jc, scan_chunk=scan_chunk)
    tc = dataclasses.replace(tc, scan_chunk=scan_chunk)
    toks = _tokens(2, 2, 12)
    want = jax.jit(jm.forward, static_argnums=2)(jp, jnp.asarray(toks), jc)
    engine(port_engine)
    got = tm.forward(tp, torch.from_numpy(toks), tc)
    assert got.dtype == torch.float32 and got.shape == (2, 12, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("port_engine", ENGINES)
def test_loss_and_gradients_match_jax(model, engine, port_engine):
    jc, jp, tc, tp = model
    toks = _tokens(3, 2, 16)
    tgt = np.roll(toks, -1, axis=1)
    tgt[0, -1] = jm.IGNORE
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn), static_argnums=3)(
        jp, jnp.asarray(toks), jnp.asarray(tgt), jc)
    engine(port_engine)
    from kfunca_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    views = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss = tm.loss_fn(tree_unflatten(tp, views), torch.from_numpy(toks),
                      torch.from_numpy(tgt), tc)
    grads = torch.autograd.grad(loss, views)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _trees_close(tree_to_numpy(tree_unflatten(tp, grads)), jg, 1e-4)


@pytest.fixture(scope="module")
def jax_steps(model):
    """Three JAX AdamW steps from the shared params (compiled once)."""
    jc, jp, _, _ = model
    oc = jtr.OptConfig(lr=1e-2, weight_decay=0.1)
    rng = np.random.default_rng(4)
    batches = [(w[:, :-1], w[:, 1:]) for w in
               rng.integers(0, 96, (3, 2, 17)).astype(np.int32)]
    st = jtr.init_opt_state(jp, oc)
    step = jax.jit(jm.make_mamba_train_step(jc, oc))
    p, losses = jp, []
    for tok, tgt in batches:
        p, st, loss = step(p, st, jnp.asarray(tok), jnp.asarray(tgt))
        losses.append(float(loss))
    return batches, jtr.init_opt_state(jp, oc), p, st, losses


@pytest.mark.parametrize("port_engine", ENGINES)
def test_train_steps_match_jax(model, jax_steps, engine, port_engine):
    jc, jp, tc, _ = model
    batches, st0, want_p, want_st, want_losses = jax_steps
    engine(port_engine)
    oc = ttr.OptConfig(lr=1e-2, weight_decay=0.1)
    tp = mamba_params_from_jax(jp, tc, device="cpu")
    tst = opt_state_from_jax(st0, device="cpu")
    step = tm.make_mamba_train_step(tc, oc, device="cpu")
    losses = []
    for tok, tgt in batches:
        tp, tst, loss = step(tp, tst, tok, tgt)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    # adam divides each entry by its own size: a few 1e-6 of the gradient
    # can move an entry whose sum nearly cancels by a share of lr
    _trees_close(tree_to_numpy(tp), want_p, 2e-4)
    _trees_close(tree_to_numpy(tst)["m"], want_st["m"], 1e-3)
    assert int(tst["step"]) == int(want_st["step"]) == 3


@pytest.mark.parametrize("eos_from", [None, 2])
def test_generate_matches_jax(model, eos_from):
    jc, jp, tc, tp = model
    prompt = _tokens(5, 2, 6)
    free = np.asarray(jm.generate(jp, jnp.asarray(prompt), jc,
                                  max_new_tokens=6))
    eos = -1 if eos_from is None else int(free[0, eos_from])
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt), jc,
                                  max_new_tokens=6, eos_id=eos))
    got = tm.generate(tp, torch.from_numpy(prompt), tc, max_new_tokens=6,
                      eos_id=eos)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_recurrent_decode_matches_the_parallel_forward(model):
    """Greedy recurrent tokens are the argmax of the parallel forward over
    the growing sequence (the O(1)-state path is exact)."""
    _, _, tc, tp = model
    prompt = torch.from_numpy(_tokens(6, 2, 5))
    got = tm.generate(tp, prompt, tc, max_new_tokens=4)
    seq = prompt
    for i in range(4):
        nxt = torch.argmax(tm.forward(tp, seq, tc)[:, -1], dim=-1).int()
        assert torch.equal(nxt, got[:, i])
        seq = torch.cat([seq, nxt[:, None].long()], dim=1)


def test_params_from_jax_checks_the_config(model):
    jc, jp, tc, _ = model
    with pytest.raises(ValueError, match="layers"):
        mamba_params_from_jax(jp, dataclasses.replace(tc, n_layers=3),
                              device="cpu")
    with pytest.raises(ValueError, match="x_proj"):
        mamba_params_from_jax(jp, dataclasses.replace(tc, dt_rank=5),
                              device="cpu")


# -- HF interop ------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_model():
    pytest.importorskip("transformers")
    from transformers import MambaConfig as HFMambaConfig
    from transformers import MambaForCausalLM

    torch.manual_seed(0)
    hf_cfg = HFMambaConfig(
        vocab_size=96, hidden_size=32, state_size=8, num_hidden_layers=2,
        conv_kernel=4, expand=2, time_step_rank=4, use_cache=False,
        layer_norm_epsilon=1e-5)
    return MambaForCausalLM(hf_cfg).eval()


def test_hf_logits_match_transformers(hf_model):
    params, cfg = tm.from_hf_mamba(hf_model, dtype="float32", device="cpu")
    assert cfg.d_inner == 64 and cfg.rank == 4
    ids = np.random.RandomState(0).randint(2, 96, (2, 9)).astype(np.int64)
    with torch.no_grad():
        ref = hf_model(input_ids=torch.from_numpy(ids)).logits
        ours = tm.forward(params, torch.from_numpy(ids), cfg)
    assert float((ours - ref).abs().max()) < 2e-4


def test_hf_greedy_generation_token_exact(hf_model):
    params, cfg = tm.from_hf_mamba(hf_model, dtype="float32", device="cpu")
    ids = np.random.RandomState(1).randint(2, 96, (2, 6)).astype(np.int64)
    with torch.no_grad():
        ref = hf_model.generate(torch.from_numpy(ids), max_new_tokens=6,
                                do_sample=False, num_beams=1)[:, 6:]
    ours = tm.generate(params, torch.from_numpy(ids), cfg, max_new_tokens=6)
    np.testing.assert_array_equal(ours.numpy(), ref.numpy())


def test_hf_export_round_trip(hf_model):
    params, cfg = tm.from_hf_mamba(hf_model, dtype="float32", device="cpu")
    sd = tm.to_hf_mamba(params, cfg)
    assert set(sd) == set(hf_model.state_dict())
    params2 = tm.params_from_hf_mamba(sd, cfg, device="cpu")
    t = torch.from_numpy(_tokens(7, 1, 7))
    with torch.no_grad():
        torch.testing.assert_close(tm.forward(params, t, cfg),
                                   tm.forward(params2, t, cfg), rtol=0,
                                   atol=0)
    # the export is what the JAX package's exporter writes for the same params
    jsd = jm.to_hf_mamba(tree_to_numpy(params), jm.MambaConfig(**SMALL))
    for k, v in jsd.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
