"""CLIP-style dual-encoder contrastive training (image <-> text).

Counterpart of kfunca_tpu/models/clip.py, with its parameter layout
(models/weights.clip_params_from_jax carries a JAX pytree across):

  * the ViT patch encoder (mean-pooled) and the causal text trunk (the
    final position of transformer.hidden_states: on the card its attention
    is K1 forward and K2 backward), each projected to embed_dim and
    L2-normalized;
  * symmetric InfoNCE over the batch: logits = exp(logit_scale) * I @ T^T
    against the diagonal both ways, logit_scale a learned log-temperature
    (init log(1 / 0.07)) clamped at log(100);
  * `clip_loss_sharded` over the dp axis of a parallel/mesh.py mesh: each
    rank's embeddings are all-gathered as the negatives
    (parallel/collectives.all_gather, whose backward reduce-scatters their
    gradients to the ranks that made them), each rank contrasts its local
    rows against the global set, labels offset by its dp index.  The
    global (B, B) logit matrix is never formed on one rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..parallel import collectives as cc
from ..runtime.backend import resolve_device
from .mamba import _linear
from .transformer import (TransformerConfig, hidden_states, init_params,
                          rank_batches)
from .vision import ViTConfig, _vit_params, vit_encode

MAX_LOGIT_SCALE = math.log(100.0)  # CLIP clamp: temperature >= 1/100


@dataclass(frozen=True)
class ClipConfig:
    """The JAX package's ClipConfig, field for field."""

    vit: ViTConfig = ViTConfig()
    text: TransformerConfig = TransformerConfig(
        vocab_size=512, d_model=256, n_heads=4, n_layers=4, d_ff=512)
    embed_dim: int = 128


def init_clip_params(seed: int, cfg: ClipConfig, device=None,
                     dtype=torch.float32):
    """Random params with the JAX laws: the ViT, the text trunk
    (transformer.init_params, seeded with seed + 1), the two heads and
    logit_scale = log(1 / 0.07), on `device` (default: the CUDA device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "vit": _vit_params(gen, cfg.vit, dtype),
        "text": init_params(seed + 1, cfg.text, dev, dtype),
        "img_head": _linear(gen, cfg.vit.d_model, cfg.embed_dim, dtype),
        "txt_head": _linear(gen, cfg.text.d_model, cfg.embed_dim, dtype),
        "logit_scale": torch.tensor(math.log(1.0 / 0.07),
                                    dtype=torch.float32, device=dev),
    }


def _normalize(x):
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-8)


def encode_image(params, images, cfg: ClipConfig):
    """(B, H, W, C) -> unit-norm (B, embed_dim) fp32."""
    feats = vit_encode(params["vit"], images, cfg.vit)  # (B, N, dv)
    pooled = feats.float().mean(dim=1)
    return _normalize(pooled @ params["img_head"].float())


def encode_text(params, tokens, cfg: ClipConfig):
    """(B, T) integers -> unit-norm (B, embed_dim) fp32, from the final
    position's trunk state (the causal summary of the sequence)."""
    x = hidden_states(params["text"], tokens, cfg.text)  # (B, T, dt)
    return _normalize(x[:, -1].float() @ params["txt_head"].float())


def _scale(params):
    return torch.exp(torch.clamp(params["logit_scale"].float(),
                                 max=MAX_LOGIT_SCALE))


def _xent_rows(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None])[:, 0]


def clip_loss(params, images, tokens, cfg: ClipConfig):
    """Single-device symmetric InfoNCE; returns (loss, metrics): the
    image-to-text accuracy and the clamped scale, both detached."""
    img = encode_image(params, images, cfg)
    txt = encode_text(params, tokens, cfg)
    scale = _scale(params)
    logits = scale * (img @ txt.t())
    labels = torch.arange(img.shape[0], device=img.device)
    li = _xent_rows(logits, labels).mean()  # image -> text
    lt = _xent_rows(logits.t(), labels).mean()  # text -> image
    loss = 0.5 * (li + lt)
    acc = (torch.argmax(logits, dim=-1) == labels).float().mean()
    return loss, {"acc_i2t": acc.detach(), "logit_scale": scale.detach()}


def clip_loss_sharded(params, images, tokens, cfg: ClipConfig, mesh):
    """Global-batch InfoNCE over the dp axis of a mesh: a list over the mesh's
    held ranks, each the global loss (clip_loss's on the concatenated
    batch).

    images / tokens: under a LocalMesh the global batch (split into dp
    stripes) or the list of the held ranks' stripes; under a
    GroupMesh this process's stripe.  params: one tree, the replica every
    held rank computes with.  Each rank's loss back-propagates its own
    rows' share of the global mean (the all-gather's backward brings the
    other ranks' gradients of its embeddings home), so under a LocalMesh
    autograd over all the returned losses gives the global gradient, and
    under a GroupMesh the sum of the ranks' gradients does (the data-
    parallel all-reduce)."""
    ims, tks = rank_batches(mesh, images), rank_batches(mesh, tokens)
    imgs = [encode_image(params, im, cfg) for im in ims]  # (b, e) local
    txts = [encode_text(params, tk, cfg) for tk in tks]
    img_all = cc.all_gather(imgs, mesh, "dp", 0)
    txt_all = cc.all_gather(txts, mesh, "dp", 0)
    scale = _scale(params)
    n = mesh.dp
    shares = []
    for r, img, txt, ia, ta in zip(mesh.ranks, imgs, txts, img_all, txt_all):
        b = img.shape[0]
        labels = mesh.index(r, "dp") * b + torch.arange(b, device=img.device)
        # local rows against global columns: (b, B_global)
        li = _xent_rows(scale * (img @ ta.t()), labels)
        lt = _xent_rows(scale * (txt @ ia.t()), labels)
        shares.append((0.5 * (li + lt)).mean() / n)
    total = cc.all_reduce([s.detach() for s in shares], mesh, "dp")
    return [s + (t - s).detach() for s, t in zip(shares, total)]


def make_clip_train_step(cfg: ClipConfig, oc=None, device=None):
    """step(params, opt_state, images, tokens) -> (params, opt_state,
    metrics) on `device` (default: the CUDA device): {"loss", "acc_i2t",
    "logit_scale"}; the update is in place (models/train.py)."""
    from .train import (OptConfig, apply_update, check_params_device,
                        value_and_grad_aux)

    dev = resolve_device(device)
    oc = oc or OptConfig(lr=1e-4, weight_decay=0.0)

    def step(params, opt_state, images, tokens):
        check_params_device(params, dev)
        images = torch.as_tensor(images).to(dev)
        tokens = torch.as_tensor(tokens).to(dev)
        loss, metrics, grads = value_and_grad_aux(
            lambda p: clip_loss(p, images, tokens, cfg), params)
        params, opt_state = apply_update(params, grads, opt_state, oc)
        return params, opt_state, {"loss": loss, **metrics}

    return step
