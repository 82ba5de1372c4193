"""DPO preference finetuning (Rafailov et al., "Direct Preference
Optimization: Your Language Model is Secretly a Reward Model").

Counterpart of kfunca_tpu/models/dpo.py.  The loss over a (chosen,
rejected) completion pair:

    r_c = beta * (logp_pi(chosen)   - logp_ref(chosen))      # implicit
    r_r = beta * (logp_pi(rejected) - logp_ref(rejected))    # rewards
    L   = -(1-ls) * logsigmoid(r_c - r_r) - ls * logsigmoid(r_r - r_c)

with ls the label smoothing (0: standard DPO; > 0: conservative cDPO).
logp are sums of per-token log-likelihoods over the completion positions
(prompt and padding positions carry ignore_index, the SFT convention).
Sequence log-probs stream the LM head in vocab chunks (models/loss.py), so
the (B, S, V) logits never exist.  A step runs four trunk forwards
(policy and reference, chosen and rejected); the reference's run under
torch.no_grad(), where the JAX package uses stop_gradient, so they keep
no graph.  On the card each forward runs the flash kernels K1 (and the
policy's backward K2).

LoRA-DPO (make_lora_dpo_step): the reference model is the frozen base
itself, so one copy of the weights serves the policy (adapter-attached)
and the reference (plain) forwards; with B = 0 at step 0 the loss is
log 2 and every reward 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime.backend import resolve_device
from .lora import attach_lora, frozen
from .loss import chunked_softmax_xent
from .train import (
    OptConfig, apply_update, check_params_device, value_and_grad_aux,
)
from .transformer import (
    TransformerConfig, _plain_mm, hidden_states, lm_head_weight,
)


def _token_logps(params, tokens, targets, cfg: TransformerConfig,
                 vocab_chunk: int | None):
    """(B, S) fp32 log p(safe target | context), `targets` already made
    safe (every id in [0, vocab)); vocab_chunk None takes full logits."""
    x = hidden_states(params, tokens, cfg)
    b, s, dm = x.shape
    flat = x.reshape(-1, dm)
    t = targets.reshape(-1).long()
    if vocab_chunk is None:
        logits = _plain_mm(flat, lm_head_weight(params, x.dtype))
        logp = torch.log_softmax(logits.float(), dim=-1)
        tokl = logp.gather(-1, t[:, None])[:, 0]
    else:
        tokl = -chunked_softmax_xent(flat, lm_head_weight(params,
                                                          torch.float32),
                                     t, vocab_chunk)
    return tokl.reshape(b, s)


def sequence_logprobs(params, tokens, targets, cfg: TransformerConfig,
                      ignore_index: int = -100,
                      vocab_chunk: int | None = 4096):
    """(B,) fp32 sums of log p(target_t | context) over the positions whose
    target != ignore_index.  vocab_chunk streams the LM head (default);
    None materializes the full logits."""
    targets = torch.as_tensor(targets, device=tokens.device)
    mask = (targets != ignore_index).float()
    safe = torch.where(targets == ignore_index, 0, targets)
    return (_token_logps(params, tokens, safe, cfg, vocab_chunk)
            * mask).sum(dim=-1)


def dpo_loss(policy_params, ref_params, tok_c, tgt_c, tok_r, tgt_r,
             cfg: TransformerConfig, beta: float = 0.1,
             label_smoothing: float = 0.0, ignore_index: int = -100,
             vocab_chunk: int | None = 4096):
    """Mean DPO loss over the batch and the metrics {"reward_margin",
    "reward_acc", "chosen_reward", "rejected_reward"} (beta-scaled implicit
    rewards, detached scalars).  The reference forwards keep no graph."""
    def lp(p, tok, tgt):
        return sequence_logprobs(p, tok, tgt, cfg, ignore_index, vocab_chunk)

    pi_c = lp(policy_params, tok_c, tgt_c)
    pi_r = lp(policy_params, tok_r, tgt_r)
    with torch.no_grad():
        ref_c = lp(ref_params, tok_c, tgt_c)
        ref_r = lp(ref_params, tok_r, tgt_r)
    r_c = beta * (pi_c - ref_c)
    r_r = beta * (pi_r - ref_r)
    logits = r_c - r_r
    ls = label_smoothing
    loss = torch.mean(-(1.0 - ls) * F.logsigmoid(logits)
                      - ls * F.logsigmoid(-logits))
    metrics = {
        "reward_margin": logits.detach().mean(),
        "reward_acc": (logits.detach() > 0).float().mean(),
        "chosen_reward": r_c.detach().mean(),
        "rejected_reward": r_r.detach().mean(),
    }
    return loss, metrics


def _on(dev, *xs):
    return [torch.as_tensor(x).to(dev) for x in xs]


def make_dpo_step(ref_params, cfg: TransformerConfig,
                  oc: OptConfig = OptConfig(weight_decay=0.0),
                  beta: float = 0.1, label_smoothing: float = 0.0,
                  ignore_index: int = -100,
                  vocab_chunk: int | None = 4096, device=None):
    """Full-parameter DPO: step(params, opt_state, tok_c, tgt_c, tok_r,
    tgt_r) -> (params, opt_state, metrics), metrics["loss"] the objective;
    on `device` (default: the CUDA device).  ref_params are frozen (the
    usual recipe starts the policy as a copy of the SFT checkpoint); the
    update writes params and moments in place (models/train)."""
    dev = resolve_device(device)
    check_params_device(ref_params, dev)
    ref = frozen(ref_params)

    def step(params, opt_state, tok_c, tgt_c, tok_r, tgt_r):
        check_params_device(params, dev)
        batch = _on(dev, tok_c, tgt_c, tok_r, tgt_r)
        loss_v, metrics, grads = value_and_grad_aux(
            lambda p: dpo_loss(p, ref, *batch, cfg, beta, label_smoothing,
                               ignore_index, vocab_chunk), params)
        params, opt_state = apply_update(params, grads, opt_state, oc)
        return params, opt_state, {"loss": loss_v, **metrics}

    return step


def make_lora_dpo_step(base_params, cfg: TransformerConfig,
                       oc: OptConfig = OptConfig(weight_decay=0.0),
                       beta: float = 0.1, label_smoothing: float = 0.0,
                       ignore_index: int = -100,
                       vocab_chunk: int | None = 4096, device=None):
    """LoRA-DPO: step(adapters, opt_state, tok_c, tgt_c, tok_r, tgt_r) ->
    (adapters, opt_state, metrics).  The frozen base (fp or quantize_base's
    pairs) is the reference model, so there is one copy of the big
    weights; gradients and moments are the adapter's.  Build the state
    with init_opt_state(adapters["blocks"]).  At step 0 (B = 0) the loss
    is log 2 and every reward 0."""
    dev = resolve_device(device)
    check_params_device(base_params, dev)
    base = frozen(base_params)

    def step(adapters, opt_state, tok_c, tgt_c, tok_r, tgt_r):
        check_params_device(adapters["blocks"], dev)
        scale = adapters["scale"]
        batch = _on(dev, tok_c, tgt_c, tok_r, tgt_r)

        def loss_fn(blocks):
            policy = attach_lora(base, {"blocks": blocks, "scale": scale})
            return dpo_loss(policy, base, *batch, cfg, beta,
                            label_smoothing, ignore_index, vocab_chunk)

        loss_v, metrics, grads = value_and_grad_aux(loss_fn,
                                                    adapters["blocks"])
        blocks, opt_state = apply_update(adapters["blocks"], grads,
                                         opt_state, oc)
        return ({"blocks": blocks, "scale": scale}, opt_state,
                {"loss": loss_v, **metrics})

    return step
