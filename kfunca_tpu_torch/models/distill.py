"""Knowledge distillation: chunked-vocab forward KL against a teacher.

Counterpart of kfunca_tpu/models/distill.py.  The token objective is
Hinton's

    L = alpha * tau^2 * KL(p_T^tau || p_S^tau) + (1 - alpha) * CE(hard)

with p^tau = softmax(z / tau).  The KL needs both heads' full-vocab
distributions a token; chunked_kd_kl streams both heads together over
vocab chunks with one online pass,

    KL_i = lse_S - lse_T + sum_v p_T(v) * (z_T(v) - z_S(v)),

the weighted difference carried in the teacher's running-max domain like
an online logsumexp (rescaled by exp(m_old - m_new) when the max moves),
so its transient memory is O(N * chunk) a head whatever the vocabulary.
The backward recomputes each chunk's logits from the saved activations
and log-sum-exps and emits d z_S = (p_S - p_T) * g / tau, adding dx_S and
writing the student head's dW chunk by chunk.  The teacher gets no
gradient.  Plain torch, as the JAX package's is XLA (a lax.scan and a
custom_vjp); the trunk forwards run the flash kernels K1 and K2 on the
card.
"""

from __future__ import annotations

import torch

from ..runtime.backend import resolve_device
from .dpo import _on
from .lora import frozen
from .loss import chunked_softmax_xent
from .train import (
    OptConfig, apply_update, check_params_device, value_and_grad_aux,
)
from .transformer import (
    _masked_mean, _plain_mm, hidden_states, lm_head_weight,
)


def _chunk_logits_masked(x, w, base: int, chunk: int, inv_tau: float):
    """One chunk's fp32 temperature-scaled logits (N, chunk) of vocab
    columns [base, base + chunk) and their validity mask (1, chunk).
    Columns past the vocabulary are -inf and invalid: the caller zeroes
    their logit differences with the mask, since (-inf) - (-inf) is NaN."""
    v = w.shape[1]
    wi = w[:, base:base + chunk].to(x.dtype)
    logits = _plain_mm(x, wi) * inv_tau
    width = wi.shape[1]
    if width < chunk:
        pad = logits.new_full((x.shape[0], chunk - width), float("-inf"))
        logits = torch.cat([logits, pad], dim=1)
    col = torch.arange(chunk, device=x.device)[None, :] + base
    return logits, col < v


class _ChunkedKdKl(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_s, w_s, x_t, w_t, chunk, tau):
        n, v = x_s.shape[0], w_s.shape[1]
        if w_t.shape[1] != v:
            raise ValueError(f"student vocab {v} != teacher vocab "
                             f"{w_t.shape[1]}")
        inv_tau = 1.0 / tau

        def full(value):
            return torch.full((n,), value, dtype=torch.float32,
                              device=x_s.device)

        m_s, s_s, m_t, s_t, u = (full(float("-inf")), full(0.0),
                                 full(float("-inf")), full(0.0), full(0.0))
        for base in range(0, v, chunk):
            z_s, _ = _chunk_logits_masked(x_s, w_s, base, chunk, inv_tau)
            z_t, valid = _chunk_logits_masked(x_t, w_t, base, chunk, inv_tau)
            # student online lse
            mn_s = torch.maximum(m_s, z_s.max(dim=-1).values)
            s_s = s_s * torch.exp(m_s - mn_s) + torch.exp(
                z_s - mn_s[:, None]).sum(dim=-1)
            m_s = mn_s
            # teacher online lse and the weighted difference sum, in the
            # same running-max domain
            mn_t = torch.maximum(m_t, z_t.max(dim=-1).values)
            scale = torch.exp(m_t - mn_t)
            e_t = torch.exp(z_t - mn_t[:, None])
            diff = torch.where(valid, z_t - z_s, 0.0)
            s_t = s_t * scale + e_t.sum(dim=-1)
            u = u * scale + (e_t * diff).sum(dim=-1)
            m_t = mn_t
        lse_s = m_s + torch.log(s_s)
        lse_t = m_t + torch.log(s_t)
        ctx.save_for_backward(x_s, w_s, x_t, w_t, lse_s, lse_t)
        ctx.chunk, ctx.inv_tau = chunk, inv_tau
        return lse_s - lse_t + u / s_t

    @staticmethod
    def backward(ctx, g):
        x_s, w_s, x_t, w_t, lse_s, lse_t = ctx.saved_tensors
        chunk, inv_tau = ctx.chunk, ctx.inv_tau
        v = w_s.shape[1]
        gf = g.float() * inv_tau  # d KL / d z_s = p_s - p_t, z = x w / tau
        dx = torch.zeros(x_s.shape, dtype=torch.float32, device=x_s.device)
        dw = torch.empty(w_s.shape, dtype=w_s.dtype, device=w_s.device)
        for base in range(0, v, chunk):
            z_s, _ = _chunk_logits_masked(x_s, w_s, base, chunk, inv_tau)
            z_t, _ = _chunk_logits_masked(x_t, w_t, base, chunk, inv_tau)
            p_s = torch.exp(z_s - lse_s[:, None])  # padded: exp(-inf) == 0
            p_t = torch.exp(z_t - lse_t[:, None])
            width = min(chunk, v - base)
            dl = ((p_s - p_t) * gf[:, None])[:, :width].to(x_s.dtype)
            wi = w_s[:, base:base + width].to(x_s.dtype)
            dx += _plain_mm(dl, wi.t())
            dw[:, base:base + width] = _plain_mm(x_s.t(), dl).to(w_s.dtype)
        return dx.to(x_s.dtype), dw, None, None, None, None


def chunked_kd_kl(x_s, w_s, x_t, w_t, chunk: int = 4096, tau: float = 1.0):
    """Per-token KL(teacher^tau || student^tau) without full logits.

    x_s (N, D_s) student activations, w_s (D_s, V) its head; x_t (N, D_t)
    and w_t (D_t, V) the teacher's (the widths may differ, the vocabulary
    may not).  chunk: the vocab tile (transient memory 2 * N * chunk fp32
    a chunk); tau: the softmax temperature (the tau^2 loss scale is the
    caller's, distill_loss).  Returns kl (N,) fp32 >= 0, differentiable in
    x_s and w_s; the teacher's inputs get no gradient."""
    return _ChunkedKdKl.apply(x_s, w_s, x_t, w_t, int(chunk), float(tau))


def distill_loss(student_params, teacher_params, tokens, targets,
                 s_cfg, t_cfg, alpha: float = 0.5, tau: float = 1.0,
                 ignore_index: int = -100, vocab_chunk: int = 4096):
    """Mean KD objective over the unmasked positions and the metrics
    {"kd": mean tau^2-scaled KL, "ce": mean hard-target NLL}.  Student and
    teacher run their own trunks (any width and depth, one vocabulary);
    the teacher's forward keeps no graph."""
    x_s = hidden_states(student_params, tokens, s_cfg)
    with torch.no_grad():
        x_t = hidden_states(teacher_params, tokens, t_cfg)
        w_t = lm_head_weight(teacher_params, torch.float32)
    b, s, d_s = x_s.shape
    w_s = lm_head_weight(student_params, torch.float32)
    flat_s = x_s.reshape(b * s, d_s)
    flat_t = x_t.reshape(b * s, x_t.shape[-1])
    flat_tgt = targets.reshape(-1)
    kl = chunked_kd_kl(flat_s, w_s, flat_t, w_t, vocab_chunk, tau)
    kd = _masked_mean(kl, flat_tgt, ignore_index) * (tau * tau)
    # an ignored (negative) target hits no chunk: a finite nll, masked out
    nll = chunked_softmax_xent(flat_s, w_s, flat_tgt.clamp_min(0),
                               vocab_chunk)
    ce = _masked_mean(nll, flat_tgt, ignore_index)
    loss = alpha * kd + (1.0 - alpha) * ce
    return loss, {"kd": kd.detach(), "ce": ce.detach()}


def make_distill_step(teacher_params, t_cfg, s_cfg,
                      oc: OptConfig = OptConfig(), alpha: float = 0.5,
                      tau: float = 1.0, ignore_index: int = -100,
                      vocab_chunk: int = 4096, device=None):
    """step(params, opt_state, tokens, targets) -> (params, opt_state,
    metrics), metrics["loss"] the combined objective, on `device`
    (default: the CUDA device).  teacher_params are frozen; the update
    writes the student's params and moments in place (models/train)."""
    dev = resolve_device(device)
    check_params_device(teacher_params, dev)
    teacher = frozen(teacher_params)

    def step(params, opt_state, tokens, targets):
        check_params_device(params, dev)
        tokens, targets = _on(dev, tokens, targets)
        loss_v, metrics, grads = value_and_grad_aux(
            lambda p: distill_loss(p, teacher, tokens, targets, s_cfg,
                                   t_cfg, alpha, tau, ignore_index,
                                   vocab_chunk), params)
        params, opt_state = apply_update(params, grads, opt_state, oc)
        return params, opt_state, {"loss": loss_v, **metrics}

    return step
