"""Carry transformer parameters and optimizer state between the JAX
package and the port.

Both packages use one parameter layout (see models/transformer.py) and one
optimizer-state layout (see models/train.py), so a JAX pytree maps leaf for
leaf onto the port's dicts of tensors, and both can start a step from the
same (params, opt_state).  The conversion goes through numpy: the port
never imports JAX, and a caller holding JAX arrays passes them as they are
(each leaf goes through np.asarray) or as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import pack_int4
from ..runtime.backend import resolve_device
from ..utils.tree import tree_map
from .transformer import TransformerConfig


def _to_tensor(leaf, device, dtype):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # own, writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, cfg: TransformerConfig, device=None, dtype=None):
    """JAX params pytree (dicts and lists of arrays) -> the port's params on
    `device` (default: the CUDA device).  `dtype` recasts every float leaf
    (None keeps each leaf's dtype).  Checks the tree against `cfg`: an MHA
    block by its wqkv, an MLA block by its own projections."""
    dev = resolve_device(device)
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['blocks'])} blocks for a config of "
                         f"{cfg.n_layers} layers")
    if tuple(np.shape(tree["embed"])) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {np.shape(tree['embed'])} does not match "
                         f"the config")
    for blk in tree["blocks"]:
        for key, want in _attention_shapes(blk, cfg):
            _check_shape(blk, key, want)
    return tree_map(lambda x: _to_tensor(x, dev, dtype), tree)


def _attention_shapes(blk, cfg: TransformerConfig):
    """(key, shape) of each attention projection the config asks of a
    block."""
    if cfg.attention != "mla":
        return [("wqkv", (cfg.d_model, cfg.qkv_out))]
    from .mla import mla_dims

    h, qk, nope, rope, v_dim, d_c = mla_dims(cfg)
    if cfg.q_lora_rank:
        q = [("w_dq", (cfg.d_model, cfg.q_lora_rank)),
             ("w_uq", (cfg.q_lora_rank, h * qk))]
    else:
        q = [("w_q", (cfg.d_model, h * qk))]
    return q + [("w_dkv", (cfg.d_model, d_c + rope)),
                ("w_uk", (d_c, h * nope)), ("w_uv", (d_c, h * v_dim)),
                ("wo", (h * v_dim, cfg.d_model))]


def _check_shape(tree, key, want):
    if key not in tree:
        raise ValueError(f"the tree holds no {key} where the config needs "
                         f"one of {tuple(want)}")
    got = tuple(np.shape(tree[key]))
    if got != tuple(want):
        raise ValueError(f"{key} {got} does not match the config's "
                         f"{tuple(want)}")


def _check_mixer(blk, mcfg):
    di, r, n = mcfg.d_inner, mcfg.rank, mcfg.d_state
    for key, want in (("in_proj", (mcfg.d_model, 2 * di)),
                      ("conv_w", (mcfg.d_conv, di)),
                      ("x_proj", (di, r + 2 * n)), ("dt_proj", (r, di)),
                      ("A_log", (di, n)), ("out_proj", (di, mcfg.d_model))):
        _check_shape(blk, key, want)


def mamba_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_mamba_params pytree -> the port's Mamba params on
    `device` (default: the CUDA device); `dtype` recasts every float leaf
    (None keeps each leaf's dtype).  Checks the tree against the
    MambaConfig `cfg`."""
    dev = resolve_device(device)
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers for a config of "
                         f"{cfg.n_layers}")
    _check_shape(tree, "embed", (cfg.vocab_size, cfg.d_model))
    for layer in tree["layers"]:
        _check_mixer(layer, cfg)
    return tree_map(lambda x: _to_tensor(x, dev, dtype), tree)


def hybrid_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_hybrid_params pytree -> the port's hybrid params on
    `device` (default: the CUDA device), each block checked against the
    HybridConfig `cfg`'s layer kinds and widths."""
    dev = resolve_device(device)
    kinds = cfg.layer_kinds()
    if len(tree["blocks"]) != len(kinds):
        raise ValueError(f"{len(tree['blocks'])} blocks for a config of "
                         f"{len(kinds)} layers")
    _check_shape(tree, "embed", (cfg.vocab_size, cfg.d_model))
    for blk, kind in zip(tree["blocks"], kinds):
        _check_shape(blk, "w_gate", (cfg.d_model, cfg.d_ff))
        if kind == "attn":
            if "wqkv" not in blk:
                raise ValueError("an attention layer of the config holds no "
                                 "wqkv in the tree")
            _check_shape(blk, "wqkv", (cfg.d_model, cfg.tcfg.qkv_out))
        else:
            if "in_proj" not in blk:
                raise ValueError("an SSM layer of the config holds no "
                                 "in_proj in the tree")
            _check_mixer(blk, cfg.mcfg)
    return tree_map(lambda x: _to_tensor(x, dev, dtype), tree)


def moe_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_moe_params tree -> the port's MoE params on `device`
    (default: the CUDA device), checked against the MoEConfig `cfg`."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    for key, want in (("router", (d, e)), ("w_in", (e, d, f)),
                      ("w_out", (e, f, d))):
        _check_shape(tree, key, want)
    return tree_map(lambda x: _to_tensor(x, resolve_device(device), dtype),
                    tree)


def pipeline_lm_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX pipeline_lm.init_params tree -> the port's params on `device`,
    the stage-stacked (n_stages, layers a stage, ...) leaves kept as they
    are; checked against the PipelineMoEConfig `cfg`."""
    per = cfg.n_layers // cfg.n_stages
    lead = (cfg.n_stages, per)
    _check_shape(tree, "embed", (cfg.vocab_size, cfg.d_model))
    st = tree["stages"]
    _check_shape(st, "wqkv", lead + (cfg.d_model, 3 * cfg.d_model))
    _check_shape(st["moe"], "w_in", lead + (cfg.n_experts, cfg.d_model,
                                            cfg.d_ff))
    return tree_map(lambda x: _to_tensor(x, resolve_device(device), dtype),
                    tree)


def stacked_params_from_jax(tree, device=None, dtype=None):
    """Any JAX tree of arrays (stage-stacked pipeline params, say) -> the
    same tree of tensors on `device`, leaf for leaf."""
    return tree_map(lambda x: _to_tensor(x, resolve_device(device), dtype),
                    tree)


def decode_params_from_jax(tree, device=None):
    """A JAX `quantize_decode_params` pytree -> the port's decode params on
    `device` (default: the CUDA device): quantized weights are
    (intN array, fp32 scales) tuples there and here.  int8 pairs cross as
    they are.  numpy has no int4, so the caller hands jnp.int4 weights over
    widened (`w.astype(jnp.int8)`); a pair whose scales are 2-D group
    scales is such a widened int4 weight and is packed two values a byte
    (ops/quant.pack_int4).  Float leaves keep their dtype."""
    dev = resolve_device(device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            w, scale = (_to_tensor(leaf, "cpu", None) for leaf in x)
            if scale.ndim == 2:
                w = pack_int4(w.to(torch.int8))
            return w.to(dev), scale.to(dev)
        return _to_tensor(x, dev, None)

    return walk(tree)


def lora_from_jax(tree, device=None):
    """A JAX adapter tree ({"blocks": [{target: {"A", "B"}}], "scale"},
    kfunca_tpu/models/lora.init_lora's layout, or a LoRA step's output,
    whose scale is an array) -> the port's on `device` (default: the CUDA
    device): the blocks' A and B as fp32 tensors, the scale a float.  A
    quantize_base tree of the base goes through decode_params_from_jax
    (int4 weights widened to int8 first, as its docstring says)."""
    dev = resolve_device(device)
    blocks = tree_map(lambda x: _to_tensor(x, dev, torch.float32),
                      tree["blocks"])
    return {"blocks": blocks, "scale": float(np.asarray(tree["scale"]))}


def opt_state_from_jax(tree, device=None):
    """JAX optimizer state (init_opt_state's layout: "step", "m", "v", ...)
    -> the port's on `device` (default: the CUDA device), every leaf in its
    own dtype (int32 step, fp32 or bf16 moments, 0-dim dummies)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _to_tensor(x, dev, None), tree)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def tree_to_numpy(tree):
    """A tree of tensors (params, optimizer state) -> the same tree of
    numpy arrays (bf16 tensors widen exactly to float32, which numpy can
    hold)."""
    return tree_map(_to_numpy, tree)


params_to_numpy = tree_to_numpy  # the same walk, under the params' name


# -- Mamba-2 and the vision family: every leaf checked against the config --


def _check_tree(tree, want, path="params"):
    """Every leaf of `want` (a tree of shapes; a key ending in "?" may be
    absent) stands in `tree` with its shape, and `tree` holds nothing
    else."""
    if isinstance(want, tuple):
        got = tuple(np.shape(tree))
        if got != want:
            raise ValueError(f"{path} {got} does not match the config's "
                             f"{want}")
        return
    if isinstance(want, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(want):
            n = len(tree) if isinstance(tree, (list, tuple)) else "no list"
            raise ValueError(f"{path}: {n} entries for a config of "
                             f"{len(want)}")
        for i, (t, w) in enumerate(zip(tree, want)):
            _check_tree(t, w, f"{path}[{i}]")
        return
    keys = {k.rstrip("?") for k in want}
    extra = sorted(set(tree) - keys)
    if extra:
        raise ValueError(f"{path} holds {extra}, which the config has no "
                         f"place for")
    for k, w in want.items():
        name = k.rstrip("?")
        if name not in tree:
            if k.endswith("?"):
                continue
            raise ValueError(f"{path} holds no {name} where the config "
                             f"needs one")
        _check_tree(tree[name], w, f"{path}.{name}")


def _converted(tree, want, device, dtype):
    _check_tree(tree, want)
    dev = resolve_device(device)
    return tree_map(lambda x: _to_tensor(x, dev, dtype), tree)


def _encoder_block_shapes(d, f):
    return {"attn_norm": (d,), "wqkv": (d, 3 * d), "wo": (d, d),
            "mlp_norm": (d,), "w_gate": (d, f), "w_up": (d, f),
            "w_down": (f, d)}


def _bert_block_shapes(d, f):
    return {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo": (d, d), "bo": (d,),
            "attn_norm": (d,), "attn_norm_b": (d,), "w_fc": (d, f),
            "b_fc": (f,), "w_proj": (f, d), "b_proj": (d,),
            "mlp_norm": (d,), "mlp_norm_b": (d,)}


def _dense_text_shapes(cfg: TransformerConfig):
    """The shapes of a dense (no MoE, no MLA) transformer's params."""
    if cfg.n_experts or cfg.attention == "mla":
        raise ValueError("the text trunk of a vision-family model is dense: "
                         "no MoE, no MLA")
    d, f, lnorm = cfg.d_model, cfg.d_ff, cfg.norm == "layernorm"
    blk = {"attn_norm": (d,), "wqkv": (d, cfg.qkv_out), "wo": (d, d),
           "mlp_norm": (d,)}
    if cfg.qk_norm:
        blk.update(q_norm=(cfg.head_dim,), k_norm=(cfg.head_dim,))
    if lnorm:
        blk.update(attn_norm_b=(d,), mlp_norm_b=(d,))
    if cfg.proj_bias:
        blk.update(bqkv=(cfg.qkv_out,), bo=(d,))
    if cfg.mlp_type == "gelu":
        blk.update(w_fc=(d, f), w_proj=(f, d))
        if cfg.proj_bias:
            blk.update(b_fc=(f,), b_proj=(d,))
    else:
        blk.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    shapes = {"embed": (cfg.vocab_size, d), "final_norm": (d,),
              "lm_head?": (d, cfg.vocab_size),
              "blocks": [dict(blk) for _ in range(cfg.n_layers)]}
    if cfg.pos == "learned":
        shapes["pos_embed"] = (cfg.max_seq_len, d)
    if lnorm:
        shapes["final_norm_b"] = (d,)
    return shapes


def _vit_shapes(cfg):
    d = cfg.d_model
    return {"patch_proj": (cfg.patch_dim, d), "pos_embed": (cfg.n_patches, d),
            "final_norm": (d,),
            "blocks": [_encoder_block_shapes(d, cfg.d_ff)
                       for _ in range(cfg.n_layers)]}


def mamba2_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_mamba2_params pytree -> the port's Mamba-2 params on
    `device` (default: the CUDA device), every leaf checked against the
    Mamba2Config `cfg`; `dtype` recasts every float leaf."""
    d, h, di = cfg.d_model, cfg.n_heads, cfg.d_inner
    layer = {"norm": (d,), "in_proj": (d, cfg.proj_out),
             "conv_w": (cfg.d_conv, cfg.conv_dim), "conv_b": (cfg.conv_dim,),
             "dt_bias": (h,), "A_log": (h,), "D": (h,), "mixer_norm": (di,),
             "out_proj": (di, d)}
    want = {"embed": (cfg.vocab_size, d), "final_norm": (d,),
            "layers": [dict(layer) for _ in range(cfg.n_layers)]}
    return _converted(tree, want, device, dtype)


def vit_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_vit_params pytree -> the port's ViT params, every leaf
    checked against the ViTConfig `cfg`."""
    return _converted(tree, _vit_shapes(cfg), device, dtype)


def multimodal_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_multimodal_params pytree -> the port's, every leaf
    checked against the MultimodalConfig `cfg`."""
    want = {"vit": _vit_shapes(cfg.vit), "text": _dense_text_shapes(cfg.text),
            "img_proj": (cfg.vit.d_model, cfg.text.d_model)}
    return _converted(tree, want, device, dtype)


def encoder_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_encoder_params (either arch) or from_hf_bert pytree -> the
    port's, every leaf checked against the EncoderConfig `cfg`."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.arch == "bert":
        want = {"embed": (cfg.vocab_size, d), "pos_embed": (cfg.max_seq_len, d),
                "embed_norm": (d,), "embed_norm_b": (d,),
                "pooler_w?": (d, d), "pooler_b?": (d,),
                "blocks": [_bert_block_shapes(d, f)
                           for _ in range(cfg.n_layers)]}
        if cfg.type_vocab:
            want["type_embed"] = (cfg.type_vocab, d)
    else:
        want = {"embed": (cfg.vocab_size, d), "pos_embed": (cfg.max_seq_len, d),
                "final_norm": (d,),
                "blocks": [_encoder_block_shapes(d, f)
                           for _ in range(cfg.n_layers)]}
    return _converted(tree, want, device, dtype)


def hf_vit_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX from_hf_vit pytree -> the port's, every leaf checked against
    the HFViTConfig `cfg`."""
    d = cfg.d_model
    want = {"patch_w": (cfg.patch_size ** 2 * cfg.channels, d),
            "patch_b": (d,), "cls": (1, d), "pos_embed": (cfg.n_patches + 1, d),
            "final_norm": (d,), "final_norm_b": (d,),
            "pooler_w?": (d, d), "pooler_b?": (d,),
            "blocks": [_bert_block_shapes(d, cfg.d_ff)
                       for _ in range(cfg.n_layers)]}
    return _converted(tree, want, device, dtype)


def clip_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_clip_params pytree -> the port's, every leaf checked
    against the ClipConfig `cfg` (logit_scale a 0-dim leaf)."""
    want = {"vit": _vit_shapes(cfg.vit), "text": _dense_text_shapes(cfg.text),
            "img_head": (cfg.vit.d_model, cfg.embed_dim),
            "txt_head": (cfg.text.d_model, cfg.embed_dim),
            "logit_scale": ()}
    return _converted(tree, want, device, dtype)


def dit_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_dit_params pytree -> the port's, every leaf checked
    against the DiTConfig `cfg`."""
    d, pd = cfg.d_model, cfg.patch_dim
    blk = {"wqkv": (d, 3 * d), "wo": (d, d), "w_fc": (d, cfg.d_ff),
           "w_proj": (cfg.d_ff, d), "ada": (d, 6 * d), "ada_b": (6 * d,)}
    want = {"patch_proj": (pd, d), "pos_embed": (cfg.n_patches, d),
            "t_mlp1": (256, d), "t_mlp1_b": (d,), "t_mlp2": (d, d),
            "t_mlp2_b": (d,), "y_embed": (cfg.n_classes + 1, d),
            "final_ada": (d, 2 * d), "final_ada_b": (2 * d,),
            "final_proj": (d, pd), "final_proj_b": (pd,),
            "blocks": [dict(blk) for _ in range(cfg.n_layers)]}
    return _converted(tree, want, device, dtype)


def t5_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_t5_params or from_hf_t5 pytree -> the port's, every leaf
    checked against the T5Config `cfg`."""
    d, inner, f = cfg.d_model, cfg.inner_dim, cfg.d_ff
    attn = {"wq": (d, inner), "wk": (d, inner), "wv": (d, inner),
            "wo": (inner, d)}
    mlp = ({"wi_0": (d, f), "wi_1": (d, f), "wo": (f, d)}
           if cfg.mlp_type == "gated-gelu" else {"wi": (d, f), "wo": (f, d)})
    want = {"embed": (cfg.vocab_size, d),
            "enc_rel_bias": (cfg.rel_buckets, cfg.n_heads),
            "dec_rel_bias": (cfg.rel_buckets, cfg.n_heads),
            "enc_final_norm": (d,), "dec_final_norm": (d,),
            "encoder": [{"attn_norm": (d,), "attn": dict(attn),
                         "mlp_norm": (d,), "mlp": dict(mlp)}
                        for _ in range(cfg.n_enc_layers)],
            "decoder": [{"attn_norm": (d,), "attn": dict(attn),
                         "cross_norm": (d,), "cross": dict(attn),
                         "mlp_norm": (d,), "mlp": dict(mlp)}
                        for _ in range(cfg.n_dec_layers)]}
    if not cfg.tied_head:
        want["lm_head"] = (d, cfg.vocab_size)
    return _converted(tree, want, device, dtype)


def whisper_params_from_jax(tree, cfg, device=None, dtype=None):
    """A JAX init_whisper_params or from_hf_whisper pytree -> the port's,
    every leaf checked against the WhisperConfig `cfg`."""
    d, f = cfg.d_model, cfg.d_ff
    attn = {"wq": (d, d), "bq": (d,), "wk": (d, d), "wv": (d, d),
            "bv": (d,), "wo": (d, d), "bo": (d,)}
    mlp = {"fc1": (d, f), "fc1_b": (f,), "fc2": (f, d), "fc2_b": (d,)}

    def block(cross):
        blk = {"attn": dict(attn), "mlp": dict(mlp)}
        for name in ("attn_norm", "mlp_norm") + (("cross_norm",) if cross
                                                 else ()):
            blk[name] = blk[name + "_b"] = (d,)
        if cross:
            blk["cross"] = dict(attn)
        return blk

    want = {"conv1_w": (3, cfg.n_mels, d), "conv1_b": (d,),
            "conv2_w": (3, d, d), "conv2_b": (d,),
            "enc_pos": (cfg.max_source_positions, d),
            "embed": (cfg.vocab_size, d),
            "dec_pos": (cfg.max_target_positions, d),
            "enc_final_norm": (d,), "enc_final_norm_b": (d,),
            "dec_final_norm": (d,), "dec_final_norm_b": (d,),
            "encoder": [block(False) for _ in range(cfg.n_enc_layers)],
            "decoder": [block(True) for _ in range(cfg.n_dec_layers)]}
    return _converted(tree, want, device, dtype)
