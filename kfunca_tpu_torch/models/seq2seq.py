"""What the encoder-decoder models (t5.py, whisper.py) share: the held ranks
of a mesh, unscaled fp32 attention, and the self- and cross-attention K/V
of a forward or a cached generation.

Every function of those models runs over `Ranks`: a plain param tree is
one rank holding everything (a 1 x 1 LocalMesh, whose collectives return
their inputs), a ShardedParams the ranks of a (dp, tp) mesh, each with
its whole heads.  A model gives the helpers here its own kv_heads(y, a,
cfg) -> (k, v), the (B, H, T, head_dim) heads of y under an attention
param dict `a` (T5's carry no bias, Whisper's v does).
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel import collectives as cc
from ..parallel.mesh import LocalMesh, ShardedParams

NEG = -1e30  # the masked score: where(mask, s, NEG) before the softmax


class Ranks:
    """The param trees of the held ranks, their mesh, and the config of a
    rank's heads: a plain tree is one rank (a 1 x 1 mesh, whose collectives
    are no-ops) holding all heads; a ShardedParams is its mesh's ranks."""

    def __init__(self, params, cfg):
        self.cfg = cfg
        if isinstance(params, ShardedParams):
            tp = params.mesh.tp
            if cfg.n_heads % tp:
                raise ValueError(f"tp {tp} does not divide the {cfg.n_heads} "
                                 f"heads")
            self.mesh, self.ps = params.mesh, params.local
            self.lcfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp)
        else:
            self.mesh = LocalMesh(1, 1, params["embed"].device)
            self.ps, self.lcfg = [params], cfg
        self.device = self.mesh.device

    def tensor(self, x):
        """An input (array or tensor) on the ranks' device."""
        return torch.as_tensor(x).to(self.device)

    def inputs(self, *xs):
        """Each input on the ranks' device; None stays None."""
        return [None if x is None else self.tensor(x) for x in xs]

    def layers(self, key: str):
        """Each layer's params of the stack `key`, as a list over ranks."""
        return [list(ps) for ps in zip(*(t[key] for t in self.ps))]


def split_heads(x, cfg):
    """(B, T, H * d) -> (B, H, T, d) with cfg.n_heads heads."""
    b, s, _ = x.shape
    return x.reshape(b, s, cfg.n_heads, -1).transpose(1, 2)


def merge_heads(x):
    """(B, H, T, d) -> (B, T, H * d)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def attend(q, k, v, bias, mask):
    """fp32 attention WITHOUT the 1/sqrt(d) scale: q/k/v (B, H, T, d), bias
    (H, Tq, Tk) fp32 or None, mask broadcasting to (B, H, Tq, Tk) (True =
    attend) or None."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if bias is not None:
        s = s + bias[None]
    if mask is not None:
        s = torch.where(mask, s, NEG)
    prob = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", prob, v.float())


def kv_of(r: Ranks, inputs, kv_heads):
    """kv(i, a) of attention whose keys and values come from `inputs` (one
    a rank: the normed inputs for self-attention, the encoder output for
    cross-attention), entered through the column-parallel copy."""
    inputs = cc.copy(inputs, r.mesh)
    return lambda i, a: kv_heads(inputs[i], a, r.lcfg)


def new_caches(r: Ranks, batch: int, max_len: int, head_dim: int, dtype):
    """Zero self-attention caches, a list over the held ranks of a dict
    of (B, the rank's heads, max_len, head_dim) "k" and "v" a layer."""
    shape = (batch, r.lcfg.n_heads, max_len, head_dim)
    return [[{"k": torch.zeros(shape, dtype=dtype, device=r.device),
              "v": torch.zeros(shape, dtype=dtype, device=r.device)}
             for _ in t["decoder"]] for t in r.ps]


def cached_kv(r: Ranks, ys, caches, li: int, pos: int, kv_heads):
    """kv of one new token at `pos`: its K/V written into each rank's
    layer-li cache (in place), the cache up to pos read back."""
    ys = cc.copy(ys, r.mesh)

    def kv(i, a):
        k, v = caches[i][li]["k"], caches[i][li]["v"]
        k[:, :, pos:pos + 1], v[:, :, pos:pos + 1] = kv_heads(ys[i], a,
                                                              r.lcfg)
        return k[:, :, :pos + 1], v[:, :, :pos + 1]

    return kv


def fixed_kv(r: Ranks, encs, kv_heads):
    """Each decoder layer's cross-attention kv over the encoder output,
    computed once for a whole generation."""
    out = []
    for ps in r.layers("decoder"):
        kvs = [kv_heads(e, p["cross"], r.lcfg) for e, p in zip(encs, ps)]
        out.append(lambda i, a, kvs=kvs: kvs[i])
    return out
