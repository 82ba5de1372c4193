"""Vision encoder and the multimodal (image-prefixed) language model.

Counterpart of kfunca_tpu/models/vision.py: a ViT-style patch encoder and
an image-prefixed causal LM over the port's transformer blocks, with the
JAX package's parameter layout (models/weights.vit_params_from_jax and
multimodal_params_from_jax carry a JAX pytree across).

  * The patch embedding is a block reshape and one matmul (non-overlapping
    patches are exactly that), no conv.
  * The encoder's attention is bidirectional, an fp32 einsum-softmax
    (`encoder_attention`), as the JAX package makes it: the encoder's S is
    short, and the causal flash kernels serve the decoder.
  * The multimodal decoder is a prefix design: the projected patch
    features are prepended to the token embeddings and the whole sequence
    runs through transformer._block, whose attention is causal (the prefix
    attends causally too, the flash kernels' mask): on the card K1 forward
    and K2 backward (ops/attention.py).  The logits are the text
    positions'.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..runtime.backend import resolve_device
from .mamba import _linear
from .transformer import (_DTYPES, TransformerConfig, _block, _plain_mm,
                          init_params, rms_norm)


@dataclass(frozen=True)
class ViTConfig:
    """The JAX package's ViTConfig, field for field."""

    image_size: int = 64
    patch_size: int = 8
    channels: int = 3
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 512
    dtype: str = "bfloat16"

    @property
    def n_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image {self.image_size} is not a multiple of "
                             f"the patch {self.patch_size}")
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def encoder_block_params(gen, d_model, d_ff, dtype=torch.float32):
    """One pre-norm encoder block (RMSNorm gains 1, matrices
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))) drawn from `gen` on its device."""
    dev = gen.device

    def ones():
        return torch.ones((d_model,), dtype=dtype, device=dev)

    return {"attn_norm": ones(),
            "wqkv": _linear(gen, d_model, 3 * d_model, dtype),
            "wo": _linear(gen, d_model, d_model, dtype),
            "mlp_norm": ones(),
            "w_gate": _linear(gen, d_model, d_ff, dtype),
            "w_up": _linear(gen, d_model, d_ff, dtype),
            "w_down": _linear(gen, d_ff, d_model, dtype)}


def _vit_params(gen, cfg: ViTConfig, dtype):
    dev = gen.device
    return {
        "patch_proj": _linear(gen, cfg.patch_dim, cfg.d_model, dtype),
        "pos_embed": (torch.randn((cfg.n_patches, cfg.d_model),
                                  generator=gen, device=dev) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "blocks": [encoder_block_params(gen, cfg.d_model, cfg.d_ff, dtype)
                   for _ in range(cfg.n_layers)],
    }


def init_vit_params(seed: int, cfg: ViTConfig, device=None,
                    dtype=torch.float32):
    """Random ViT params with the JAX init_vit_params laws (positions
    N(0, 0.02^2)), drawn from a torch.Generator seeded with `seed` on
    `device` (default: the CUDA device)."""
    dev = resolve_device(device)
    return _vit_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                       dtype)


def patchify(images, cfg: ViTConfig):
    """(B, H, W, C) -> (B, N, patch_dim) by a pure block reshape, patches
    in row-major order, each (row, column, channel) within."""
    b, hh, ww, c = images.shape
    p = cfg.patch_size
    gh, gw = hh // p, ww // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def encoder_attention(q, k, v, mask=None):
    """Bidirectional attention over (B, H, S, hd): fp32 scores (scaled by
    1/sqrt(hd)) and softmax, the weighted sum in fp32.  `mask` (B, S) bool
    marks the valid keys (None: all); a masked score is -1e30, the JAX
    package's fill."""
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        sc = sc.masked_fill(~mask.bool()[:, None, None, :], -1e30)
    prob = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", prob, v.float())


def split_heads(qkv, n_heads):
    """(B, S, 3 * d) fused projection -> q, k, v each (B, H, S, hd)."""
    b, s, w = qkv.shape
    qkv = qkv.reshape(b, s, 3, n_heads, w // (3 * n_heads))
    return (qkv[:, :, i].transpose(1, 2) for i in range(3))


def merge_heads(attn):
    """(B, H, S, hd) -> (B, S, H * hd)."""
    b, h, s, hd = attn.shape
    return attn.transpose(1, 2).reshape(b, s, h * hd)


def _encoder_block(x, p, cfg, mask=None):
    """Bidirectional attention + SwiGLU MLP, pre-norm.  `mask` (B, S) bool
    marks the valid key positions (None: all valid): padding keys take no
    attention (models/encoder.py's text path; the ViT passes no mask)."""
    y = rms_norm(x, p["attn_norm"])
    qkv = _plain_mm(y, p["wqkv"]).to(y.dtype)
    attn = encoder_attention(*split_heads(qkv, cfg.n_heads), mask)
    attn = merge_heads(attn.to(x.dtype))
    x = x + _plain_mm(attn, p["wo"]).to(x.dtype)

    y = rms_norm(x, p["mlp_norm"])
    gate = _plain_mm(y, p["w_gate"])
    up = _plain_mm(y, p["w_up"])
    act = (F.silu(gate) * up).to(y.dtype)
    return x + _plain_mm(act, p["w_down"]).to(x.dtype)


def vit_encode(params, images, cfg: ViTConfig):
    """images (B, H, W, C) float -> patch features (B, N, d_model)."""
    x = patchify(images, cfg).to(cfg.act_dtype)
    x = _plain_mm(x, params["patch_proj"]).to(cfg.act_dtype)
    x = x + params["pos_embed"].to(x.dtype)
    for p in params["blocks"]:
        x = _encoder_block(x, p, cfg)
    return rms_norm(x, params["final_norm"])


# -- multimodal: the image-prefixed causal LM ---------------------------------


@dataclass(frozen=True)
class MultimodalConfig:
    """The JAX package's MultimodalConfig: a ViTConfig and the text
    trunk's TransformerConfig."""

    vit: ViTConfig = ViTConfig()
    text: TransformerConfig = TransformerConfig(
        vocab_size=512, d_model=256, n_heads=4, n_layers=4, d_ff=512)


def init_multimodal_params(seed: int, cfg: MultimodalConfig, device=None,
                           dtype=torch.float32):
    """Random params with the JAX laws: the ViT, the text trunk
    (transformer.init_params, seeded with seed + 1) and the image
    projection, on `device` (default: the CUDA device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "vit": _vit_params(gen, cfg.vit, dtype),
        "text": init_params(seed + 1, cfg.text, dev, dtype),
        "img_proj": _linear(gen, cfg.vit.d_model, cfg.text.d_model, dtype),
    }


def multimodal_forward(params, images, tokens, cfg: MultimodalConfig):
    """images (B, H, W, C), tokens (B, T) -> fp32 logits (B, T, vocab) over
    the text positions (the image prefix's logits are dropped)."""
    tcfg = cfg.text
    feats = vit_encode(params["vit"], images, cfg.vit)  # (B, N, dv)
    prefix = _plain_mm(feats, params["img_proj"]).to(tcfg.act_dtype)
    tok_emb = params["text"]["embed"][tokens.long()].to(tcfg.act_dtype)
    x = torch.cat([prefix, tok_emb], dim=1)  # (B, N + T, dt)
    for p in params["text"]["blocks"]:
        x = _block(x, p, tcfg)
    x = rms_norm(x, params["text"]["final_norm"])
    n = cfg.vit.n_patches
    return _plain_mm(x[:, n:], params["text"]["embed"].t())


def multimodal_loss(params, images, tokens, targets, cfg: MultimodalConfig):
    """Mean next-token NLL over every text position."""
    logits = multimodal_forward(params, images, tokens, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()
