"""Port parity: DPO (kfunca_tpu_torch/models/dpo.py).

The same weights (two JAX init_params carried across: the policy and a
distinct reference) and the same numpy preference pairs (shared prompts
masked with ignore_index) go through both packages in fp32 on the CPU:
sequence log-probs with the streamed head (vocab % chunk != 0) and with
full logits, dpo_loss with label smoothing and its metrics, two steps of
the full-parameter make_dpo_step, and three of make_lora_dpo_step, whose
first loss is log 2 with every reward 0.  Losses and log-probs within
1e-5, params and adapters within 1e-4 of max(1, max |ref|).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import dpo as jdpo
from kfunca_tpu.models import lora as jlora
from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import dpo as tdpo
from kfunca_tpu_torch.models import lora as tlora
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import (
    lora_from_jax, opt_state_from_jax, params_from_jax, tree_to_numpy)

CFG = dict(vocab_size=120, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=96, max_seq_len=32, dtype="float32")
CHUNK = 48  # 120 = 2 x 48 + 24: the last chunk is partial
TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _models():
    jc, tc = jtf.TransformerConfig(**CFG), ttf.TransformerConfig(**CFG)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    jr = jtf.init_params(jax.random.PRNGKey(1), jc)
    return (jc, jp, jr, tc, params_from_jax(jp, tc, device="cpu"),
            params_from_jax(jr, tc, device="cpu"))


def _pairs(seed=0, batch=2, prompt=6, seq=16):
    """(tok_c, tgt_c, tok_r, tgt_r): two completions of shared prompts,
    the prompt's targets ignored."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, CFG["vocab_size"], (batch, prompt))
    out = []
    for _ in range(2):
        c = rng.integers(0, CFG["vocab_size"], (batch, seq + 1 - prompt))
        s = np.concatenate([p, c], axis=1).astype(np.int32)
        tgt = s[:, 1:].copy()
        tgt[:, :prompt - 1] = -100
        out += [s[:, :-1], tgt]
    return out


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("chunk", [CHUNK, None], ids=["chunked", "full"])
def test_sequence_logprobs_match_jax(chunk):
    jc, jp, _, tc, tp, _ = _models()
    tok, tgt = _pairs()[:2]
    want = jax.jit(functools.partial(jdpo.sequence_logprobs, cfg=jc,
                                     vocab_chunk=chunk))(
        jp, jnp.asarray(tok), jnp.asarray(tgt))
    got = tdpo.sequence_logprobs(tp, torch.as_tensor(tok),
                                 torch.as_tensor(tgt), tc, vocab_chunk=chunk)
    _close(got, want, LOSS_TOL)


def test_dpo_loss_and_metrics_match_jax():
    jc, jp, jr, tc, tp, tr = _models()
    batch = _pairs()
    want, wm = jax.jit(functools.partial(
        jdpo.dpo_loss, cfg=jc, beta=0.2, label_smoothing=0.1,
        vocab_chunk=CHUNK))(jp, jr, *map(jnp.asarray, batch))
    got, gm = tdpo.dpo_loss(tp, tr, *map(torch.as_tensor, batch), tc,
                            beta=0.2, label_smoothing=0.1, vocab_chunk=CHUNK)
    _close(got, want, LOSS_TOL)
    assert sorted(gm) == sorted(wm)
    for k in gm:
        _close(gm[k], wm[k], LOSS_TOL)


def test_the_reference_forwards_keep_no_graph():
    """Reference leaves that ask for a gradient get none: their forwards
    run under no_grad."""
    _, _, _, tc, tp, tr = _models()
    ref = {k: v for k, v in tr.items()}
    ref["embed"] = tr["embed"].detach().clone().requires_grad_(True)
    pol = dict(tp, embed=tp["embed"].detach().clone().requires_grad_(True))
    loss, _ = tdpo.dpo_loss(pol, ref, *map(torch.as_tensor, _pairs()), tc,
                            vocab_chunk=CHUNK)
    loss.backward()
    assert ref["embed"].grad is None and pol["embed"].grad is not None


def test_full_parameter_dpo_steps_match_jax():
    jc, jp, jr, tc, tp, tr = _models()
    oc = dict(lr=1e-3, weight_decay=0.0)
    jst = jtr.init_opt_state(jp, jtr.OptConfig(**oc))
    tst = opt_state_from_jax(jst, device="cpu")
    tpol = params_from_jax(jp, tc, device="cpu")  # the step writes in place
    jstep = jax.jit(jdpo.make_dpo_step(jr, jc, jtr.OptConfig(**oc), beta=0.2,
                                       vocab_chunk=CHUNK))
    tstep = tdpo.make_dpo_step(tr, tc, ttr.OptConfig(**oc), beta=0.2,
                               vocab_chunk=CHUNK, device="cpu")
    jpol = jp
    for i in range(2):
        batch = _pairs(seed=i)
        jpol, jst, jm = jstep(jpol, jst, *map(jnp.asarray, batch))
        tpol, tst, tm = tstep(tpol, tst, *batch)
        for k in jm:
            _close(tm[k], jm[k], LOSS_TOL)
    for g, w in zip(jax.tree_util.tree_leaves(tree_to_numpy(tpol)),
                    jax.tree_util.tree_leaves(jpol)):
        _close(g, w)


@pytest.mark.parametrize("bits", [None, 8], ids=["fp", "int8_base"])
def test_lora_dpo_starts_at_log2_and_matches_jax(bits):
    """LoRA-DPO over the frozen base (fp, or an int8 quantize_base): the
    first loss is log 2 within 1e-6 with every reward 0, and three steps
    give the JAX losses, metrics and adapters."""
    jc, jp, _, tc, tp, _ = _models()
    jbase = jp if bits is None else jlora.quantize_base(jp, bits)
    tbase = tp if bits is None else tlora.quantize_base(tp, bits)
    oc = dict(lr=1e-2, weight_decay=0.0)
    jad = jlora.init_lora(jax.random.PRNGKey(3), jc, rank=4,
                          targets=("wqkv", "wo"))
    tad = lora_from_jax(jad, device="cpu")
    jst = jtr.init_opt_state(jad["blocks"], jtr.OptConfig(**oc))
    tst = ttr.init_opt_state(tad["blocks"], ttr.OptConfig(**oc),
                             device="cpu")
    jstep = jax.jit(jdpo.make_lora_dpo_step(jbase, jc, jtr.OptConfig(**oc),
                                            vocab_chunk=CHUNK))
    tstep = tdpo.make_lora_dpo_step(tbase, tc, ttr.OptConfig(**oc),
                                    vocab_chunk=CHUNK, device="cpu")
    for i in range(3):
        batch = _pairs(seed=i)
        jad, jst, jm = jstep(jad, jst, *map(jnp.asarray, batch))
        tad, tst, tm = tstep(tad, tst, *batch)
        if i == 0:
            assert abs(float(tm["loss"]) - math.log(2.0)) < 1e-6
            for k in ("reward_margin", "chosen_reward", "rejected_reward"):
                assert float(tm[k]) == 0.0
        for k in jm:
            _close(tm[k], jm[k], LOSS_TOL)
    for g, w in zip(jax.tree_util.tree_leaves(tree_to_numpy(tad["blocks"])),
                    jax.tree_util.tree_leaves(jad["blocks"])):
        _close(g, w)
    assert float(tm["loss"]) != float(math.log(2.0))
