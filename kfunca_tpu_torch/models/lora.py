"""LoRA and QLoRA finetuning: low-rank adapters trained on a frozen base.

Counterpart of kfunca_tpu/models/lora.py.  Every targeted weight W
(d_in, d_out) gains a delta scale * A @ B with A (d_in, r) Gaussian /
sqrt(r) and B (r, d_out) zeros, so the adapted model starts at the base
model; scale is alpha / r (1.0 without alpha).  The adapted forward adds
(x @ A) @ B * scale in fp32 to each base product (transformer._lora_delta)
and never materializes W + A @ B.  Gradients, optimizer moments and updates
cover the adapter blocks only: the train step differentiates with respect
to those leaves, and the base leaves, used detached, get no cotangent.

QLoRA: quantize_base turns the frozen base's block matrices into (intN,
scale) pairs (int8 per column, or int4 in groups along k, packed two a
byte as ops/quant keeps them).  The training forward dequantizes each pair
to the activation dtype per product and saves only the pair for the
backward (transformer._DequantMm), so no full-precision copy of the base
outlives a product.

Workflow:
    ad = init_lora(torch.Generator("cuda").manual_seed(0), cfg, rank=8)
    step = make_lora_train_step(params, cfg, OptConfig(weight_decay=0.0))
    opt = init_opt_state(ad["blocks"])
    ad, opt, loss = step(ad, opt, tokens, targets)
    merged = merge_lora(params, ad)          # plain params: generate, to_hf
    lora_id = srv.register_lora(to_serving(ad))   # multi-LoRA serving

MoE blocks: adapters target the attention matrices (wqkv, wo) only; the
routed experts and the router stay frozen, as in the JAX package.

The work is plain torch (the JAX package computes it with XLA too: the two
skinny fp32 products a target); the kernels on this path are the
attention's, K1 and K2, under every adapted forward.
"""

from __future__ import annotations

import math

import torch

from ..ops.quant import quantize_cols, quantize_cols_int4
from ..runtime.backend import resolve_device
from ..utils.errors import check
from ..utils.tree import tree_map
from .train import (
    OptConfig, _value_and_grad, apply_update, check_params_device,
)
from .serve import _w4_group
from .transformer import TransformerConfig, loss_fn, loss_fn_chunked

# target name -> (d_in, d_out)
_TARGET_DIMS = {
    "wqkv": lambda cfg: (cfg.d_model, cfg.qkv_out),
    "wo": lambda cfg: (cfg.d_model, cfg.d_model),
    "w_gate": lambda cfg: (cfg.d_model, cfg.d_ff),
    "w_up": lambda cfg: (cfg.d_model, cfg.d_ff),
    "w_down": lambda cfg: (cfg.d_ff, cfg.d_model),
}

# the frozen base's matrices that quantize_base turns into (intN, scale)
_QUANTIZED = ("wqkv", "wo", "w_gate", "w_up", "w_down", "w_fc", "w_proj")


def init_lora(generator, cfg: TransformerConfig, rank: int = 8,
              targets: tuple = ("wqkv",), alpha: float | None = None):
    """Adapter tree {"blocks": [{target: {"A", "B"}}], "scale": float},
    fp32 on the generator's device (a torch.Generator, whose device the
    caller picks: the card, or "cpu").  A is drawn layer by layer, target
    by target in the order given; B is zeros, so the delta starts at 0.
    scale is 1.0 without alpha, else alpha / rank."""
    for t in targets:
        check(t in _TARGET_DIMS, f"unknown LoRA target {t!r} "
              f"(supported: {sorted(_TARGET_DIMS)})")
        if cfg.n_experts and t in ("w_gate", "w_up", "w_down"):
            raise NotImplementedError(
                "LoRA on MoE expert MLPs is not supported; target the "
                "attention matrices (wqkv, wo) on MoE configs")
    dev = generator.device
    scale = 1.0 if alpha is None else alpha / rank
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {}
        for t in targets:
            d_in, d_out = _TARGET_DIMS[t](cfg)
            a = torch.randn((d_in, rank), generator=generator, device=dev)
            blk[t] = {"A": a / math.sqrt(rank),
                      "B": torch.zeros((rank, d_out), device=dev)}
        blocks.append(blk)
    return {"blocks": blocks, "scale": scale}


def attach_lora(params, adapters):
    """params whose blocks carry a "lora" entry ({target: {"A", "B",
    "scale"}}) that the forward's hooks read (transformer._lora_delta).
    Shallow: the base tensors are shared, not copied."""
    scale = adapters["scale"]
    out = dict(params)
    out["blocks"] = [
        {**blk, "lora": {t: {**ab, "scale": scale} for t, ab in ad.items()}}
        for blk, ad in zip(params["blocks"], adapters["blocks"])]
    return out


@torch.no_grad()
def merge_lora(params, adapters):
    """The adapters folded into plain params: W <- W + scale * A @ B, added
    in fp32 and cast to W's dtype.  For dense generation, HF export, or
    serving without adapter slots."""
    scale = adapters["scale"]
    out = dict(params)
    blocks = []
    for blk, ad in zip(params["blocks"], adapters["blocks"]):
        blk = dict(blk)
        for t, ab in ad.items():
            delta = scale * (ab["A"].float() @ ab["B"].float())
            blk[t] = (blk[t].float() + delta).to(blk[t].dtype)
        blocks.append(blk)
    out["blocks"] = blocks
    return out


def to_serving(adapters):
    """Per-layer [{"A", "B"}] for InferenceServer.register_lora, which
    takes wqkv adapters only; the scale is folded into B so that the
    server's unscaled (x @ A) @ B is the training forward's delta."""
    targets = sorted({t for blk in adapters["blocks"] for t in blk})
    check("wqkv" in targets, "serving adapters require the 'wqkv' target")
    if targets != ["wqkv"]:
        raise NotImplementedError(
            "InferenceServer.register_lora supports wqkv-only adapters; "
            f"got targets {targets} — merge_lora instead")
    s = adapters["scale"]
    return [{"A": ad["wqkv"]["A"].detach(),
             "B": ad["wqkv"]["B"].detach().float() * s}
            for ad in adapters["blocks"]]


@torch.no_grad()
def quantize_base(params, bits: int = 8):
    """QLoRA: the frozen base's block matrices (wqkv, wo, w_gate, w_up,
    w_down, w_fc, w_proj, and every routed expert's three) as (intN,
    scale) pairs: int8 per column (ops/quant.quantize_cols) or int4 in
    groups of up to 128 along k (quantize_cols_int4, packed two a byte).
    Embeddings, norms, a MoE block's router and shared expert, and the
    head stay as they are.  Train adapters over it with
    make_lora_train_step (or make_lora_dpo_step); merge trained adapters
    onto the original fp params (merge_lora) to serve or export them."""
    if bits == 8:
        quant = quantize_cols
    elif bits == 4:
        def quant(w):
            return quantize_cols_int4(w, group=_w4_group(w.shape[0]))
    else:
        raise ValueError(f"unsupported bits {bits} (8 or 4)")

    def qblk(blk):
        out = {}
        for k, v in blk.items():
            if k in _QUANTIZED:
                out[k] = quant(v)
            elif k == "experts":
                out[k] = [{n: quant(w) for n, w in ex.items()} for ex in v]
            else:
                out[k] = v
        return out

    out = dict(params)
    out["blocks"] = [qblk(b) for b in params["blocks"]]
    return out


def frozen(params):
    """The base params as the adapter steps use them: every leaf detached
    (the same storage, no gradient)."""
    return tree_map(lambda t: t.detach(), params)


def make_lora_train_step(base_params, cfg: TransformerConfig,
                         oc: OptConfig = OptConfig(weight_decay=0.0),
                         loss_chunk: int | None = None,
                         ignore_index: int | None = None, device=None):
    """Returns step(adapters, opt_state, tokens, targets) -> (adapters,
    opt_state, loss) on `device` (default: the CUDA device; raises without
    one).  The base params (fp, or quantize_base's pairs) are frozen: the
    gradient is taken with respect to the adapter blocks only, so grads,
    moments and updates are the adapter's size.  Build the optimizer state
    over the trainable sub-tree: init_opt_state(adapters["blocks"]).  The
    update writes the adapter tensors and moments in place (models/train).
    loss_chunk streams the LM head in vocab chunks of that width;
    ignore_index masks the positions whose target equals it."""
    dev = resolve_device(device)
    check_params_device(base_params, dev)
    base = frozen(base_params)

    def step(adapters, opt_state, tokens, tgts):
        check_params_device(adapters["blocks"], dev)
        scale = adapters["scale"]

        def loss(blocks, tokens, tgts):
            p = attach_lora(base, {"blocks": blocks, "scale": scale})
            if loss_chunk is None:
                return loss_fn(p, tokens, tgts, cfg,
                               ignore_index=ignore_index)
            return loss_fn_chunked(p, tokens, tgts, cfg, loss_chunk,
                                   ignore_index=ignore_index)

        tokens = torch.as_tensor(tokens).to(dev)
        tgts = torch.as_tensor(tgts).to(dev)
        loss_v, grads = _value_and_grad(loss, adapters["blocks"], tokens,
                                        tgts)
        blocks, opt_state = apply_update(adapters["blocks"], grads,
                                         opt_state, oc)
        return {"blocks": blocks, "scale": scale}, opt_state, loss_v

    return step
