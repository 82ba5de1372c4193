"""Port parity: GRPO (kfunca_tpu_torch/models/rlhf.py).

The same weights (the JAX init_params carried across) and the same numpy
data go through both packages in fp32 on the CPU: per-token log-probs
(streamed head with vocab % chunk != 0, and full logits), the group
advantages (a tied group among them: the population std, as jnp.std),
grpo_loss with clipped ratios and the KL term, two steps of
make_grpo_step, and rollout_group at temperature 0 (greedy: the JAX
completions token for token).  Sampled completions match the JAX ones in
distribution only, so the sampled rollout is held to its own contract and
the steps take the same completions on both sides.  Losses within 1e-5,
params within 1e-4 of max(1, max |ref|).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import rlhf as jrl
from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import rlhf as trl
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import (
    opt_state_from_jax, params_from_jax, tree_to_numpy)

CFG = dict(vocab_size=120, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=96, max_seq_len=32, dtype="float32")
CHUNK = 48
G = 4  # completions a prompt
TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _model():
    jc, tc = jtf.TransformerConfig(**CFG), ttf.TransformerConfig(**CFG)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    return jc, jp, tc, params_from_jax(jp, tc, device="cpu")


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _rollout_data(seed=0, prompts=2, t_prompt=5, new=6):
    """Shifted (tokens, targets) of P x G sequences, the prompt's targets
    ignored, old / ref log-probs near the policy's and rewards."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, CFG["vocab_size"],
                       (prompts * G, t_prompt + new)).astype(np.int32)
    tokens, targets = seq[:, :-1], seq[:, 1:].copy()
    targets[:, :t_prompt - 1] = -100
    shape = targets.shape
    old = rng.normal(-4.8, 0.3, shape).astype(np.float32)
    ref = rng.normal(-4.8, 0.3, shape).astype(np.float32)
    rewards = rng.integers(0, 3, prompts * G).astype(np.float32)
    return tokens, targets, old, ref, rewards


@pytest.mark.parametrize("chunk", [CHUNK, None], ids=["chunked", "full"])
def test_token_logprobs_match_jax(chunk):
    jc, jp, tc, tp = _model()
    tokens, targets = _rollout_data()[:2]
    want = jax.jit(functools.partial(jrl.token_logprobs, cfg=jc,
                                     vocab_chunk=chunk))(
        jp, jnp.asarray(tokens), jnp.asarray(targets))
    got = trl.token_logprobs(tp, torch.as_tensor(tokens),
                             torch.as_tensor(targets), tc, vocab_chunk=chunk)
    _close(got, want, LOSS_TOL)


def test_group_advantages_match_jax_with_a_tied_group():
    """jnp.std is the population std (torch.std's default is not): a
    group of two differing rewards standardizes to +-1 / (0.5 + eps)
    times half their gap; a tied group gets zeros; every group's mean is
    0."""
    rewards = np.array([1, 1, 1, 1, 0, 2, 0, 2, 3, 0, 1, 5], np.float32)
    want = jrl.grpo_advantages(jnp.asarray(rewards), G)
    got = trl.grpo_advantages(torch.as_tensor(rewards), G)
    _close(got, want, 1e-6)
    assert torch.equal(got[:G], torch.zeros(G))
    np.testing.assert_allclose(got.reshape(-1, G).mean(dim=-1).numpy(), 0,
                               atol=1e-6)
    np.testing.assert_allclose(got[4:8].numpy(),
                               [-1 / (1 + 1e-4), 1 / (1 + 1e-4)] * 2,
                               rtol=1e-6)


@pytest.mark.parametrize("kl_beta", [0.04, 0.0])
def test_grpo_loss_matches_jax(kl_beta):
    jc, jp, tc, tp = _model()
    tokens, targets, old, ref, rewards = _rollout_data()
    adv = np.array(jrl.grpo_advantages(jnp.asarray(rewards), G))
    want, wm = jax.jit(functools.partial(
        jrl.grpo_loss, cfg=jc, kl_beta=kl_beta, vocab_chunk=CHUNK))(
        jp, *map(jnp.asarray, (tokens, targets, old, ref, adv)))
    got, gm = trl.grpo_loss(tp, *map(torch.as_tensor,
                                     (tokens, targets, old, ref, adv)),
                            tc, kl_beta=kl_beta, vocab_chunk=CHUNK)
    _close(got, want, LOSS_TOL)
    assert sorted(gm) == sorted(wm)
    for k in gm:
        _close(gm[k], wm[k], LOSS_TOL)
    assert 0.0 < float(gm["clip_frac"]) < 1.0  # some ratios clip


def test_grpo_steps_match_jax():
    jc, jp, tc, _ = _model()
    oc = dict(lr=1e-3, weight_decay=0.0)
    jst = jtr.init_opt_state(jp, jtr.OptConfig(**oc))
    tst = opt_state_from_jax(jst, device="cpu")
    tparams = params_from_jax(jp, tc, device="cpu")
    jstep = jax.jit(jrl.make_grpo_step(jc, jtr.OptConfig(**oc),
                                       vocab_chunk=CHUNK))
    tstep = trl.make_grpo_step(tc, ttr.OptConfig(**oc), vocab_chunk=CHUNK,
                               device="cpu")
    jparams = jp
    for i in range(2):
        tokens, targets, old, ref, rewards = _rollout_data(seed=i)
        adv = np.array(jrl.grpo_advantages(jnp.asarray(rewards), G))
        batch = (tokens, targets, old, ref, adv)
        jparams, jst, jm = jstep(jparams, jst, *map(jnp.asarray, batch))
        tparams, tst, tm = tstep(tparams, tst, *batch)
        for k in jm:
            _close(tm[k], jm[k], LOSS_TOL)
    for g, w in zip(jax.tree_util.tree_leaves(tree_to_numpy(tparams)),
                    jax.tree_util.tree_leaves(jparams)):
        _close(g, w)


def test_greedy_rollout_matches_jax():
    """temperature 0: the JAX completions, shifted pair and old log-probs."""
    jc, jp, tc, tp = _model()
    prompt = np.random.default_rng(5).integers(0, 120, (2, 5)).astype(
        np.int32)
    want = jrl.rollout_group(jp, jnp.asarray(prompt), jc, G, 6,
                             temperature=0.0, vocab_chunk=CHUNK)
    got = trl.rollout_group(tp, torch.as_tensor(prompt), tc, G, 6,
                            temperature=0.0, vocab_chunk=CHUNK)
    for k in ("completions", "tokens", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    _close(got["old_logp"], want["old_logp"], LOSS_TOL)


def test_a_sampled_rollout_feeds_a_first_epoch_with_ratio_one():
    """Sampled completions (a torch.Generator): group-major repeats of the
    prompts, targets masked before the first completion token, old_logp
    the policy's own, so the first epoch's ratio is 1 and nothing clips;
    the same generator seed gives the same completions."""
    _, _, tc, tp = _model()
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, 120, (2, 5)))
    out = trl.rollout_group(tp, prompt, tc, G, 6,
                            generator=torch.Generator().manual_seed(1),
                            vocab_chunk=CHUNK)
    again = trl.rollout_group(tp, prompt, tc, G, 6,
                              generator=torch.Generator().manual_seed(1),
                              vocab_chunk=CHUNK)
    assert torch.equal(out["completions"], again["completions"])
    assert out["completions"].shape == (2 * G, 6)
    assert torch.equal(out["tokens"][:, :5],
                       prompt.repeat_interleave(G, 0).to(torch.int32))
    assert (out["targets"][:, :4] == -100).all()
    assert torch.equal(out["targets"][:, 4:], out["completions"])
    rewards = out["completions"].float().mean(dim=-1)
    adv = trl.grpo_advantages(rewards, G)
    _, m = trl.grpo_loss(tp, out["tokens"], out["targets"], out["old_logp"],
                         out["old_logp"], adv, tc, vocab_chunk=CHUNK)
    assert abs(float(m["ratio_mean"]) - 1.0) < 1e-6
    assert float(m["clip_frac"]) == 0.0 and abs(float(m["kl"])) < 1e-6
