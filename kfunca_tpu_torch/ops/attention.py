"""Causal attention with a gradient: flash forward (K1) and backward (K2).

Counterpart of kfunca_tpu/ops/attention.py: q (B, H, Sq, D), k/v
(B, Hkv, Skv, D), scale 1/sqrt(D), top-left aligned causal mask.
`causal_attention_fn(q, k, v)` is the same-heads, no-window form;
`make_flash_attention(window)` is the model-facing form with grouped kv
heads and a sliding window, cached per window.  Both run one
torch.autograd.Function whose forward launches K1 and saves
(q, k, v, out, lse) and whose backward launches K2
(ops/pallas_kernels/flash_attention.py).

Dispatch follows the tensors: on CUDA tensors the kernels run or the call
raises; on CPU tensors the kernels' plain versions run.  The JAX package
off the TPU runs the einsum oracle instead (`_sdpa_xla`, `_sdpa_xla_gqa`,
kept here under their JAX names as the numerics oracle).  The two differ
only on a row that attends no column (a window with Sq > Skv): the kernels
and their plain versions give out = 0 there, the oracle masks with
finfo.min and gives the mean of V.  A model never meets such a row
(Sq == Skv in training).

fp16 inputs ride the fp32 path: fp16 values embed exactly in fp32, so they
are widened before the kernel and the results narrowed after.

The eager-Tensor `causal_attention` with its AttentionGradFunction belongs
to the eager-Tensor slice of the port.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

from .pallas_kernels.flash_attention import (
    flash_attention_backward,
    flash_attention_fwd_stats,
    flash_attention_plain,
)

_plain = False  # set only inside plain_attention()


@contextlib.contextmanager
def plain_attention():
    """Route this module's attention through the kernels' plain versions
    (and their autograd gradient) whatever the device: the yardstick an
    end-to-end check holds the kernel path against.  No entry point of the
    package enters it."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def _sdpa_xla_gqa(q, k, v, window=None):
    """Einsum oracle with grouped kv heads and optional sliding window:
    scores accumulate in fp32, masked ones are finfo.min, the softmax
    weights are rounded to q's dtype before the second product."""
    h, hkv = q.shape[1], k.shape[1]
    sq, skv = q.shape[2], k.shape[2]
    group = h // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    row = torch.arange(sq, device=q.device)[:, None]
    col = torch.arange(skv, device=q.device)[None, :]
    ok = col <= row
    if window is not None:
        ok = ok & (col > row - window)
    s = torch.where(ok, s, torch.finfo(acc).min)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).to(acc), v.to(acc))
    return out.to(q.dtype)


def _sdpa_xla(q, k, v):
    """Reference-path causal SDPA (numerics oracle), same heads, no window."""
    return _sdpa_xla_gqa(q, k, v, None)


class _FlashAttention(torch.autograd.Function):
    """forward: K1 with statistics; backward: K2 from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_attention_fwd_stats(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, g, out, lse,
                                              window=ctx.window)
        return dq, dk, dv, None


def _apply(q, k, v, window):
    if _plain:
        return flash_attention_plain(q, k, v, window)[0]
    if q.dtype == torch.float16:
        out = _FlashAttention.apply(q.float(), k.float(), v.float(), window)
        return out.to(torch.float16)
    return _FlashAttention.apply(q, k, v, window)


def causal_attention_fn(q, k, v):
    """Differentiable causal attention, k/v with q's heads, no window."""
    if k.shape != q.shape[:2] + k.shape[2:3] + q.shape[3:] or v.shape != k.shape:
        raise ValueError(
            f"causal_attention_fn takes k, v with q's batch, heads and head "
            f"dim; got q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} (grouped kv heads: make_flash_attention)")
    return _apply(q, k, v, None)


@functools.lru_cache(maxsize=None)
def make_flash_attention(window: int | None = None):
    """Differentiable causal flash attention fn(q, k, v) with grouped kv
    heads (H % Hkv == 0) and sliding-window masking; one function object
    per window."""

    def fn(q, k, v):
        return _apply(q, k, v, window)

    return fn
