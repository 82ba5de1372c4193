"""Memory-efficient chunked-vocab cross-entropy.

Counterpart of kfunca_tpu/models/loss.py.  The standard LM loss
(models/transformer.py loss_fn) materializes the fp32 logits (N, V) and a
second copy for log-softmax's backward; at a 32k-128k vocabulary that
tensor dwarfs every activation of the model.  This module streams the LM
head instead:

  forward:  a loop over vocab chunks of the head weight; per chunk the fp32
            logits (N, C) are folded into a running online logsumexp (m, s)
            and the target column is gathered when it falls in the chunk.
            Peak extra memory is O(N*C), independent of V.
  backward: each chunk's logits are recomputed from the saved (x, lse),
            d_logits = (softmax - onehot) * g, dx is accumulated in fp32
            and the chunk's dW is written.  One extra head matmul, the same
            recompute-for-memory trade as flash attention.

Plain PyTorch: the JAX package wrote no kernel here either (a lax.scan and
a custom_vjp).
"""

from __future__ import annotations

import torch

from .transformer import _plain_mm as _mm_f32  # a @ b with an fp32 result


def _chunk_logits(x, w, base, chunk):
    """fp32 logits of vocab columns [base, base + chunk); columns past the
    vocabulary are -inf.  The matmul runs in the activation dtype with fp32
    accumulation, the contract of the unchunked head."""
    v = w.shape[1]
    wi = w[:, base : base + chunk].to(x.dtype)
    logits = _mm_f32(x, wi)
    if wi.shape[1] < chunk:
        pad = logits.new_full((x.shape[0], chunk - wi.shape[1]), float("-inf"))
        logits = torch.cat([logits, pad], dim=1)
    return logits, min(chunk, v - base)


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        n = x.shape[0]
        v = w.shape[1]
        targets = targets.long()
        m = x.new_full((n,), float("-inf"), dtype=torch.float32)
        s = x.new_zeros((n,), dtype=torch.float32)
        tl = x.new_zeros((n,), dtype=torch.float32)
        for base in range(0, v, chunk):
            logits, _ = _chunk_logits(x, w, base, chunk)
            mn = torch.maximum(m, logits.max(dim=-1).values)
            # m == -inf on the first chunk: exp(-inf - mn) == 0
            s = s * torch.exp(m - mn) + torch.exp(logits - mn[:, None]).sum(-1)
            m = mn
            loc = targets - base
            hit = (loc >= 0) & (loc < chunk)
            val = logits.gather(1, loc.clamp(0, chunk - 1)[:, None])[:, 0]
            tl = tl + torch.where(hit, val, 0.0)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.chunk = chunk
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        v = w.shape[1]
        gf = g.float()
        dx = x.new_zeros(x.shape, dtype=torch.float32)
        dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        cols = torch.arange(chunk, device=x.device)[None, :]
        for base in range(0, v, chunk):
            logits, width = _chunk_logits(x, w, base, chunk)
            p = torch.exp(logits - lse[:, None])  # padded cols: exp(-inf) == 0
            loc = targets - base
            hit = (loc >= 0) & (loc < chunk)
            onehot = (loc[:, None] == cols) & hit[:, None]
            dl = ((p - onehot.float()) * gf[:, None]).to(x.dtype)[:, :width]
            wi = w[:, base : base + width].to(x.dtype)
            # dx in fp32 (accumulator); dW per chunk in fp32, then the
            # head's storage dtype
            dx += _mm_f32(dl, wi.t())
            dw[:, base : base + width] = _mm_f32(x.t(), dl).to(w.dtype)
        return dx.to(x.dtype), dw, None, None


def chunked_softmax_xent(x, w, targets, chunk: int = 4096):
    """Per-token negative log-likelihood without materializing full logits.

    x: (N, D) activations (any float dtype; the matmul accumulates in fp32)
    w: (D, V) LM head weight (cast per chunk like the unchunked path)
    targets: (N,) integer class ids in [0, V); a negative id hits no chunk,
        so its nll is the row's (finite) logsumexp
    chunk: vocab tile width; peak transient memory is N*chunk fp32.

    Returns nll (N,) fp32 == -log_softmax(x @ w)[targets]."""
    return _ChunkedXent.apply(x, w, targets, int(chunk))


def vocab_parallel_nll(xs, heads, targets, mesh, chunk: int | None = None):
    """Per-token NLL over a head whose vocabulary is split over tp, one list
    entry a held rank: xs (N, D) the replicated activations (entered
    through parallel/collectives.copy), heads the (D, V / tp) column
    shards, rank t holding vocabulary [t V/tp, (t+1) V/tp), targets (N,)
    global ids.  Each rank takes the logsumexp of its slice (streamed in
    vocab chunks of `chunk` when given, as chunked_softmax_xent) and the
    target's logit where its slice holds it; a max and a sum all-reduce
    over tp combine them:

        lse = M + log(sum_t exp(lse_t - M)),   nll = lse - sum_t logit_t.

    Differentiable: the sums are Megatron's g (identity backward), so each
    rank's slice gets softmax - onehot."""
    from ..parallel import collectives as cc

    lses, tls = [], []
    for r, x, w, t in zip(mesh.ranks, xs, heads, targets):
        vl = w.shape[1]
        loc = t - mesh.index(r, "tp") * vl
        hit = (loc >= 0) & (loc < vl)
        safe = loc.clamp(0, vl - 1)
        if chunk is None:
            logits = _mm_f32(x, w.to(x.dtype))
            lses.append(torch.logsumexp(logits, dim=-1))
            val = logits.gather(1, safe[:, None])[:, 0]
        else:
            lses.append(chunked_softmax_xent(x, w, torch.full_like(t, -1),
                                             chunk))
            cols = w[:, safe].to(x.dtype).t()  # (N, D): each row's target
            val = (x.float() * cols.float()).sum(dim=-1)
        tls.append(torch.where(hit, val, 0.0))
    m = cc.all_reduce([l.detach() for l in lses], mesh, "tp", "max")
    s = cc.reduce([torch.exp(l - mi) for l, mi in zip(lses, m)], mesh)
    tl = cc.reduce(tls, mesh)
    return [mi + torch.log(si) - ti for mi, si, ti in zip(m, s, tl)]
