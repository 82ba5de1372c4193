"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of kfunca_tpu/models/speculative.py.  One round commits up to
gamma + 1 tokens for ONE target forward:

  1. the draft model proposes d_1..d_gamma, gamma decode steps on its own
     KV cache;
  2. the target runs one forward over [last committed, d_1..d_gamma];
  3. greedy: keep the longest prefix where the draft token equals the
     target's argmax, then commit the target's own token at the first
     mismatch, so the committed stream is the target's greedy stream token
     for token.  Sampled: accept d_i with probability min(1, p(d_i) /
     q(d_i)) and, at the first rejection, resample from norm(max(p - q,
     0)); all accepted, a bonus token from the target's last position
     (Leviathan et al.), so the output is distributed as target sampling;
  4. both caches roll back for free: a rejected position's stale K/V is
     overwritten by the next round's forward before anything reads it,
     and the causal mask admits nothing past a query's own position.

The JAX package runs the whole generation as one lax.while_loop; here the
rounds are a Python loop over the port's forward_with_cache (one host
sync a round, for the accepted count), and the sampled form draws from a
torch.Generator, so it matches the JAX function in distribution only.
Target and draft may be parallel.mesh.ShardedParams (tensor-parallel, as
the JAX function takes sharded trees): forward_with_cache runs them over
their mesh.
"""

from __future__ import annotations

import torch

from .generate import forward_with_cache, new_cache
from .transformer import TransformerConfig


def _prefill(params_t, cfg_t, params_d, cfg_d, prompt, max_new, gamma):
    """Both caches, sized for the generation plus a round's overrun, with
    every prompt token but the last (which enters on the next forward)."""
    b, t_prompt = prompt.shape
    if b != 1:
        raise ValueError("speculative decoding takes one sequence "
                         f"(acceptance is per sequence); got a batch of {b}")
    max_len = t_prompt + max_new + gamma + 1
    caches = []
    for params, cfg in ((params_t, cfg_t), (params_d, cfg_d)):
        cache = new_cache(params, cfg, 1, max_len, prompt.device)
        forward_with_cache(params, prompt[:, :-1], cache, 0, cfg)
        caches.append(cache)
    return caches


def _first_false(flags) -> int:
    """Index of the first False in a 1-D bool tensor (its length if none)."""
    miss = (~flags).nonzero()
    return int(miss[0, 0]) if miss.numel() else flags.numel()


@torch.no_grad()
def speculative_generate(params_t, cfg_t: TransformerConfig, params_d,
                         cfg_d: TransformerConfig, prompt, max_new: int,
                         gamma: int = 4):
    """Greedy speculative generation of one sequence.

    prompt: (1, T) integer tensor on the params' device.  Returns
    ((1, max_new) int32 tokens, rounds), `rounds` the target forwards
    spent (max_new when the draft never helped, about max_new / (gamma +
    1) when it always did)."""
    t_cache, d_cache = _prefill(params_t, cfg_t, params_d, cfg_d, prompt,
                                max_new, gamma)
    pos = prompt.shape[1]  # committed length, `last` included
    last = prompt[0, -1:].long()
    out, rounds = [], 0
    while len(out) < max_new:
        tok, drafts = last, []
        for i in range(gamma):
            lg, _ = forward_with_cache(params_d, tok[None], d_cache,
                                       pos - 1 + i, cfg_d)
            tok = torch.argmax(lg[0, -1:], dim=-1)
            drafts.append(tok)
        drafts = torch.cat(drafts)
        lg, _ = forward_with_cache(params_t, torch.cat([last, drafts])[None],
                                   t_cache, pos - 1, cfg_t)
        targets = torch.argmax(lg[0], dim=-1)  # (gamma + 1,)
        n_acc = _first_false(drafts == targets[:gamma])
        out += targets[: n_acc + 1].tolist()  # = d_1..d_n, then the target's
        last = targets[n_acc : n_acc + 1]
        pos += n_acc + 1
        rounds += 1
    return torch.tensor([out[:max_new]], dtype=torch.int32,
                        device=prompt.device), rounds


@torch.no_grad()
def speculative_generate_sampled(params_t, cfg_t: TransformerConfig,
                                 params_d, cfg_d: TransformerConfig, prompt,
                                 max_new: int, gamma: int = 4,
                                 temperature: float = 1.0, generator=None):
    """Stochastic speculative sampling of one sequence at `temperature`:
    the output is distributed as sampling the target alone.  Draws come
    from `generator` (a torch.Generator on the prompt's device; seeded
    with 0 when None).  Returns ((1, max_new) int32 tokens, rounds)."""
    dev = prompt.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    inv_t = 1.0 / max(temperature, 1e-6)
    t_cache, d_cache = _prefill(params_t, cfg_t, params_d, cfg_d, prompt,
                                max_new, gamma)
    pos = prompt.shape[1]
    last = prompt[0, -1:].long()
    out, rounds = [], 0
    steps = torch.arange(gamma, device=dev)
    while len(out) < max_new:
        tok, drafts, qs = last, [], []
        for i in range(gamma):
            lg, _ = forward_with_cache(params_d, tok[None], d_cache,
                                       pos - 1 + i, cfg_d)
            q = torch.softmax(lg[0, -1].float() * inv_t, dim=-1)
            tok = torch.multinomial(q, 1, generator=generator)
            drafts.append(tok)
            qs.append(q)
        drafts, qs = torch.cat(drafts), torch.stack(qs)  # (gamma,), (gamma, V)
        lg, _ = forward_with_cache(params_t, torch.cat([last, drafts])[None],
                                   t_cache, pos - 1, cfg_t)
        ps = torch.softmax(lg[0].float() * inv_t, dim=-1)  # (gamma + 1, V)
        u = torch.rand(gamma, generator=generator, device=dev)
        p_d, q_d = ps[steps, drafts], qs[steps, drafts]
        n_acc = _first_false(u < torch.clamp(
            p_d / torch.clamp(q_d, min=1e-30), max=1.0))
        if n_acc < gamma:  # rejected: p(d) < q(d), so p - q has mass
            resid = torch.clamp(ps[n_acc] - qs[n_acc], min=0.0)
            corrected = torch.multinomial(resid / resid.sum(), 1,
                                          generator=generator)
        else:  # all accepted: a bonus token from the last position
            corrected = torch.multinomial(ps[gamma], 1, generator=generator)
        out += drafts[:n_acc].tolist() + corrected.tolist()
        last = corrected
        pos += n_acc + 1
        rounds += 1
    return torch.tensor([out[:max_new]], dtype=torch.int32,
                        device=dev), rounds
