"""HF ViT checkpoints: the original pre-norm LayerNorm / GELU ViT.

Counterpart of kfunca_tpu/models/hf_vision.py.  The native ViT
(models/vision.py) is RMSNorm / SwiGLU without a CLS token; this module
carries HF `ViTModel`'s architecture so its checkpoints load: a CLS token
and learned positions over N + 1 slots, pre-norm LayerNorm blocks with
biased qkv and output projections, the exact (erf) GELU MLP, a final
LayerNorm and the tanh CLS pooler.  The conv patch embedding is imported
as a matmul (a stride-p patch conv is a block reshape and a matmul): the
weight (d, C, p, p) is reordered to (p * p * C, d), `_patchify`'s pixel
order.  `from_hf_vit` reads a checkpoint directory itself (models/hf.py's
readers) or takes a model instance.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..runtime.backend import resolve_device
from .encoder import strip_prefix
from .hf import _Reader, is_checkpoint_path, read_hf_dir
from .transformer import _DTYPES, _plain_mm, layer_norm
from .vision import encoder_attention, merge_heads, patchify, split_heads


@dataclass(frozen=True)
class HFViTConfig:
    """The JAX package's HFViTConfig, field for field."""

    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    norm_eps: float = 1e-12
    dtype: str = "float32"

    @property
    def n_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image {self.image_size} is not a multiple of "
                             f"the patch {self.patch_size}")
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# (B, H, W, C) -> (B, N, p * p * C), pixel-major (row, column, channel)
# within a patch: the order the imported conv weight is transposed into
_patchify = patchify


def _hf_vit_block(x, p, cfg: HFViTConfig):
    """Pre-norm HF ViT block: LN -> biased MHA -> + x; LN -> GELU MLP -> +."""
    y = layer_norm(x, p["attn_norm"], p["attn_norm_b"], cfg.norm_eps)
    qkv = (_plain_mm(y, p["wqkv"]) + p["bqkv"].float()).to(y.dtype)
    attn = merge_heads(encoder_attention(*split_heads(qkv, cfg.n_heads))
                       .to(x.dtype))
    o = _plain_mm(attn, p["wo"]) + p["bo"].float()
    x = x + o.to(x.dtype)

    y = layer_norm(x, p["mlp_norm"], p["mlp_norm_b"], cfg.norm_eps)
    hdn = _plain_mm(y, p["w_fc"]) + p["b_fc"].float()
    act = F.gelu(hdn, approximate="none").to(y.dtype)
    out = _plain_mm(act, p["w_proj"]) + p["b_proj"].float()
    return x + out.to(x.dtype)


def hf_vit_encode(params, images, cfg: HFViTConfig):
    """images (B, H, W, C) float -> (B, N + 1, d), HF ViTModel's
    last_hidden_state (slot 0 is the CLS token)."""
    x = _patchify(images.to(cfg.act_dtype), cfg)
    x = _plain_mm(x, params["patch_w"]) + params["patch_b"].float()
    cls = params["cls"].float().expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    x = (x + params["pos_embed"].float()).to(cfg.act_dtype)
    for p in params["blocks"]:
        x = _hf_vit_block(x, p, cfg)
    return layer_norm(x, params["final_norm"], params["final_norm_b"],
                      cfg.norm_eps)


def hf_vit_pooled(params, images, cfg: HFViTConfig):
    """HF ViTModel.pooler_output: tanh(dense(CLS hidden)), fp32."""
    x = hf_vit_encode(params, images, cfg)
    cls = x[:, 0].float()
    return torch.tanh(cls @ params["pooler_w"].float()
                      + params["pooler_b"].float())


def from_hf_vit(model_or_path, dtype: str = "float32", device=None):
    """(params, cfg) from a checkpoint directory (read without
    transformers) or a transformers ViTModel (or a wrapper exposing .vit),
    fp32 on `device` (default: the CUDA device).  The conv patch
    projection (d, C, p, p) becomes a (p * p * C, d) matmul in _patchify's
    (row, column, channel) pixel order."""
    dev = resolve_device(device)
    if is_checkpoint_path(model_or_path):
        hc, sd = read_hf_dir(model_or_path)
    else:
        hf = getattr(model_or_path, "vit", model_or_path)
        hc, sd = hf.config.to_dict(), hf.state_dict()
    sd = strip_prefix(sd, "vit.")
    if hc.get("hidden_act", "gelu") != "gelu":
        raise NotImplementedError(f"ViT activation {hc['hidden_act']!r}")
    if not hc.get("qkv_bias", True):
        raise NotImplementedError("qkv_bias=False ViT variants")
    cfg = HFViTConfig(
        image_size=hc["image_size"], patch_size=hc["patch_size"],
        channels=hc["num_channels"], d_model=hc["hidden_size"],
        n_heads=hc["num_attention_heads"], n_layers=hc["num_hidden_layers"],
        d_ff=hc["intermediate_size"], norm_eps=float(hc["layer_norm_eps"]),
        dtype=dtype)

    r = _Reader(sd, dev)  # fp32 on dev; W transposes HF (out, in)
    A, W = r.A, r.W
    pw = A("embeddings.patch_embeddings.projection.weight")  # (d, C, p, p)
    params = {
        "patch_w": pw.permute(2, 3, 1, 0).reshape(
            cfg.patch_size * cfg.patch_size * cfg.channels,
            cfg.d_model).contiguous(),
        "patch_b": A("embeddings.patch_embeddings.projection.bias"),
        "cls": A("embeddings.cls_token").reshape(1, cfg.d_model),
        "pos_embed": A("embeddings.position_embeddings")[0],
        "final_norm": A("layernorm.weight"),
        "final_norm_b": A("layernorm.bias"),
        "blocks": [],
    }
    if "pooler.dense.weight" in sd:
        params["pooler_w"] = W("pooler.dense.weight")
        params["pooler_b"] = A("pooler.dense.bias")
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        qkv = [p + f"attention.attention.{n}" for n in
               ("query", "key", "value")]
        params["blocks"].append({
            "wqkv": torch.cat([W(n + ".weight") for n in qkv], dim=1),
            "bqkv": torch.cat([A(n + ".bias") for n in qkv]),
            "wo": W(p + "attention.output.dense.weight"),
            "bo": A(p + "attention.output.dense.bias"),
            "attn_norm": A(p + "layernorm_before.weight"),
            "attn_norm_b": A(p + "layernorm_before.bias"),
            "w_fc": W(p + "intermediate.dense.weight"),
            "b_fc": A(p + "intermediate.dense.bias"),
            "w_proj": W(p + "output.dense.weight"),
            "b_proj": A(p + "output.dense.bias"),
            "mlp_norm": A(p + "layernorm_after.weight"),
            "mlp_norm_b": A(p + "layernorm_after.bias"),
        })
    return params, cfg
