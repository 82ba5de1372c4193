"""GRPO policy-gradient finetuning (Shao et al., "DeepSeekMath: Pushing the
Limits of Mathematical Reasoning").

Counterpart of kfunca_tpu/models/rlhf.py.  GRPO is PPO's clipped
surrogate without a value network: G completions are sampled per prompt
and each one's advantage is its reward standardized within its group,

    A_i = (r_i - mean(r_group)) / (std(r_group) + eps)

(the population std, as jnp.std takes it).  The per-token objective is

    L = -E[ min(rho * A, clip(rho, 1-eps, 1+eps) * A) ] + beta * KL

with rho = exp(logp_pi - logp_old) and the KL against a frozen reference
by the k3 estimator exp(d) - d - 1, d = ref - pi.  Token terms are
averaged per sequence over the completion tokens, then over the batch.
Per-token log-probs stream the LM head in vocab chunks (models/loss.py);
rollouts run models/generate.generate.  The ratio, clip and KL are plain
elementwise torch (XLA's work in the JAX package); the trunk forwards run
the flash kernels K1 and K2 on the card.
"""

from __future__ import annotations

import torch

from ..runtime.backend import resolve_device
from .dpo import _on, _token_logps
from .train import (
    OptConfig, apply_update, check_params_device, value_and_grad_aux,
)
from .transformer import TransformerConfig


def token_logprobs(params, tokens, targets, cfg: TransformerConfig,
                   vocab_chunk: int | None = 4096):
    """(B, S) fp32 per-token log p(target_t | tokens_<=t).  A position
    whose target is negative gets a finite value of no meaning (its
    target is read as 0); callers mask it."""
    targets = torch.as_tensor(targets, device=tokens.device)
    return _token_logps(params, tokens, targets.clamp_min(0), cfg,
                        vocab_chunk)


def grpo_advantages(rewards, group_size: int, eps: float = 1e-4):
    """Group-standardized advantages of (B,) rewards laid out group-major
    (the G completions of prompt 0, then prompt 1, ...; rollout_group's
    layout): (B,) fp32, zero-mean in every group; a group of equal rewards
    gets zero advantage everywhere."""
    r = torch.as_tensor(rewards).float().reshape(-1, group_size)
    mu = r.mean(dim=-1, keepdim=True)
    sd = r.std(dim=-1, keepdim=True, correction=0)
    return ((r - mu) / (sd + eps)).reshape(-1)


def _seq_mean(x, mask):
    """Per-sequence masked token mean, then the batch mean."""
    denom = mask.sum(dim=-1).clamp_min(1.0)
    return ((x * mask).sum(dim=-1) / denom).mean()


def grpo_loss(params, tokens, targets, old_logp, ref_logp, advantages,
              cfg: TransformerConfig, clip_eps: float = 0.2,
              kl_beta: float = 0.04, ignore_index: int = -100,
              vocab_chunk: int | None = 4096):
    """GRPO objective and metrics {kl, clip_frac, ratio_mean}.

    tokens / targets: (B, S), prompt and padding targets ignore_index.
    old_logp: (B, S) log-probs under the sampling policy (the ratio's
    anchor; the current params' for one online epoch, where the ratio
    starts at 1).  ref_logp: (B, S) under the frozen reference (the KL's
    anchor; kl_beta = 0 leaves the penalty out).  advantages: (B,)."""
    mask = (targets != ignore_index).float()
    logp = token_logprobs(params, tokens, targets, cfg, vocab_chunk)
    rho = torch.exp(logp - old_logp)
    adv = advantages.float()[:, None]
    lo, hi = 1.0 - clip_eps, 1.0 + clip_eps
    surr = torch.minimum(rho * adv, rho.clamp(lo, hi) * adv)
    loss = -_seq_mean(surr, mask)
    d = ref_logp - logp  # k3 estimator: exp(d) - d - 1 >= 0
    kl = _seq_mean(torch.exp(d) - d - 1.0, mask)
    if kl_beta:
        loss = loss + kl_beta * kl
    clipped = ((rho < lo) | (rho > hi)).float()
    metrics = {
        "kl": kl.detach(),
        "clip_frac": _seq_mean(clipped, mask).detach(),
        "ratio_mean": _seq_mean(rho.detach(), mask),
    }
    return loss, metrics


def make_grpo_step(cfg: TransformerConfig,
                   oc: OptConfig = OptConfig(weight_decay=0.0),
                   clip_eps: float = 0.2, kl_beta: float = 0.04,
                   ignore_index: int = -100,
                   vocab_chunk: int | None = 4096, device=None):
    """step(params, opt_state, tokens, targets, old_logp, ref_logp,
    advantages) -> (params, opt_state, metrics) on `device` (default: the
    CUDA device).  The old and reference log-probs come in as data, so
    one step serves every inner epoch of a rollout batch.  The update
    writes params and moments in place (models/train)."""
    dev = resolve_device(device)

    def step(params, opt_state, tokens, targets, old_logp, ref_logp,
             advantages):
        check_params_device(params, dev)
        batch = _on(dev, tokens, targets, old_logp, ref_logp, advantages)
        loss_v, metrics, grads = value_and_grad_aux(
            lambda p: grpo_loss(p, *batch, cfg, clip_eps, kl_beta,
                                ignore_index, vocab_chunk), params)
        params, opt_state = apply_update(params, grads, opt_state, oc)
        return params, opt_state, {"loss": loss_v, **metrics}

    return step


@torch.no_grad()
def rollout_group(params, prompt, cfg: TransformerConfig, group_size: int,
                  max_new: int, temperature: float = 1.0, generator=None,
                  ignore_index: int = -100,
                  vocab_chunk: int | None = 4096):
    """Sample G completions of each prompt and package them for grpo_loss.

    prompt: (P, T_prompt) integer tensor on the params' device (no
    padding; pad upstream and mask with ignore_index).  Sampling draws
    from `generator` (a torch.Generator on that device; seeded with 0 when
    None), so the completions match the JAX package's in distribution
    only.  Returns {completions (P*G, max_new) group-major, tokens /
    targets (P*G, T_prompt + max_new - 1) the shifted pair with every
    target before the first completion token masked, old_logp (P*G, S)
    the targets' log-probs under `params`}.  Scoring the completions is
    the caller's (feed the rewards to grpo_advantages)."""
    from .generate import generate

    prompt = torch.as_tensor(prompt)
    p_rep = prompt.repeat_interleave(group_size, dim=0)  # group-major
    completions = generate(params, p_rep, cfg, max_new,
                           temperature=temperature, generator=generator)
    seq = torch.cat([p_rep.to(completions.dtype), completions], dim=1)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    t_prompt = prompt.shape[1]
    # target t predicts seq[t + 1]; completions start at seq[t_prompt]
    pos = torch.arange(targets.shape[1], device=targets.device)
    targets = torch.where(pos[None, :] >= t_prompt - 1, targets,
                          torch.full_like(targets, ignore_index))
    old_logp = token_logprobs(params, tokens, targets, cfg, vocab_chunk)
    return {"completions": completions, "tokens": tokens,
            "targets": targets, "old_logp": old_logp}
