"""Hugging Face checkpoints <-> the port's transformer params.

Counterpart of kfunca_tpu/models/hf.py: `config_from_hf`, `params_from_hf`,
`to_hf` and `from_hf`, for the same families (Llama, Mistral, Qwen2/3,
Gemma, Mixtral, Qwen3-MoE, DeepSeek-V3, GPT-2, GPT-NeoX) with the same key
maps, transposes (HF Linear weights are (out, in), ours (in, out); GPT-2's
Conv1D is already (in, out)), fused wqkv, GPT-NeoX's per-head QKV
de-interleave, MoE expert and shared-expert keys and MLA's kv_b_proj
split, and the same NotImplementedErrors.  MoE and MLA configs load into
TransformerConfig and params, which the port's forward, train steps,
generate and servers take (MLA models serve through mla_serve.MLAServer).

`from_hf(path)` reads a checkpoint directory itself, without transformers
or safetensors (a serving machine need not have them): config.json with `json`,
then model.safetensors or the shards that model.safetensors.index.json
lists, through the reader below (an 8-byte little-endian header length, a
JSON header of dtype / shape / byte range per tensor, then the raw bytes;
tensors are made with torch.frombuffer, which takes BF16 directly), or
pytorch_model.bin (and its sharded index) through torch.load with
weights_only=True.  A raw config.json lacks the defaults that transformers'
config classes fill in, which the JAX package sees through getattr;
HF_CONFIG_DEFAULTS holds them per model_type (transformers 4.57.6).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..runtime.backend import resolve_device
from .transformer import TransformerConfig

# The defaults transformers 4.57.6's config classes give the keys that
# config_from_hf reads, where config.json may leave them out.  Keys whose
# default is derived from other keys (Llama's head_dim and
# num_key_value_heads) are left to config_from_hf's own fallbacks, which
# derive them the same way.  A model_type not listed takes
# PretrainedConfig's tie_word_embeddings=True.
_MOE_QWEN = dict(num_experts_per_tok=8, moe_intermediate_size=768,
                 norm_topk_prob=False, num_experts=128, mlp_only_layers=[],
                 decoder_sparse_step=1)
HF_CONFIG_DEFAULTS = {
    "llama": dict(max_position_embeddings=2048, rope_theta=10000.0,
                  rms_norm_eps=1e-6, rope_scaling=None,
                  tie_word_embeddings=False),
    "mistral": dict(max_position_embeddings=131072, rope_theta=10000.0,
                    rms_norm_eps=1e-6, head_dim=None, num_key_value_heads=8,
                    sliding_window=4096, tie_word_embeddings=False),
    "qwen2": dict(max_position_embeddings=32768, rope_theta=10000.0,
                  rms_norm_eps=1e-6, rope_scaling=None, num_key_value_heads=32,
                  sliding_window=None, use_sliding_window=False,
                  tie_word_embeddings=False),
    "qwen3": dict(max_position_embeddings=32768, rope_theta=10000.0,
                  rms_norm_eps=1e-6, rope_scaling=None, head_dim=128,
                  num_key_value_heads=32, sliding_window=None,
                  use_sliding_window=False, tie_word_embeddings=False),
    "gemma": dict(max_position_embeddings=8192, rope_theta=10000.0,
                  rms_norm_eps=1e-6, head_dim=256, num_key_value_heads=16,
                  tie_word_embeddings=True),
    "gpt2": dict(activation_function="gelu_new", n_inner=None,
                 n_positions=1024, layer_norm_epsilon=1e-5,
                 tie_word_embeddings=True),
    "gpt_neox": dict(hidden_act="gelu", max_position_embeddings=2048,
                     rotary_emb_base=10000, rotary_pct=0.25,
                     layer_norm_eps=1e-5, use_parallel_residual=True,
                     tie_word_embeddings=False),
    "mixtral": dict(max_position_embeddings=131072, rope_theta=1e6,
                    rms_norm_eps=1e-5, num_experts_per_tok=2, head_dim=None,
                    num_key_value_heads=8, sliding_window=None,
                    num_local_experts=8, tie_word_embeddings=False),
    "qwen3_moe": dict(max_position_embeddings=32768, rope_theta=10000.0,
                      rms_norm_eps=1e-6, rope_scaling=None,
                      num_key_value_heads=4, sliding_window=None,
                      use_sliding_window=False, tie_word_embeddings=False,
                      **_MOE_QWEN),
    "deepseek_v3": dict(max_position_embeddings=4096, rope_theta=10000.0,
                        rms_norm_eps=1e-6, rope_scaling=None,
                        attention_bias=False, q_lora_rank=1536,
                        kv_lora_rank=512, qk_nope_head_dim=128,
                        qk_rope_head_dim=64, v_head_dim=128,
                        rope_interleave=True, n_routed_experts=256,
                        num_experts_per_tok=8, n_shared_experts=1,
                        moe_intermediate_size=2048, norm_topk_prob=True,
                        routed_scaling_factor=2.5, n_group=8, topk_group=4,
                        first_k_dense_replace=3, tie_word_embeddings=False),
}
# The same for the families with loaders of their own (models/mamba.py,
# mamba2.py, encoder.py, hf_vision.py, t5.py, whisper.py): the keys their
# config readers take a default for ("auto" is MambaConfig's derived dt
# rank).
FAMILY_CONFIG_DEFAULTS = {
    "mamba": dict(state_size=16, conv_kernel=4, expand=2,
                  time_step_rank="auto", layer_norm_epsilon=1e-5),
    "mamba2": dict(num_heads=128, head_dim=64, state_size=128, n_groups=8,
                   conv_kernel=4, expand=2, chunk_size=256,
                   layer_norm_epsilon=1e-5),
    "bert": dict(hidden_act="gelu", max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12),
    "vit": dict(image_size=224, patch_size=16, num_channels=3,
                hidden_act="gelu", layer_norm_eps=1e-12, qkv_bias=True),
    # num_decoder_layers has no default of its own: absent, it is
    # num_layers (models/t5.config_from_hf_t5)
    "t5": dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
               num_layers=6, num_heads=8, relative_attention_num_buckets=32,
               relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
               feed_forward_proj="relu", tie_word_embeddings=True,
               pad_token_id=0, eos_token_id=1),
    "whisper": dict(vocab_size=51865, num_mel_bins=80, d_model=384,
                    encoder_layers=4, encoder_attention_heads=6,
                    decoder_layers=4, decoder_attention_heads=6,
                    encoder_ffn_dim=1536, decoder_ffn_dim=1536,
                    max_source_positions=1500, max_target_positions=448,
                    activation_function="gelu", scale_embedding=False,
                    tie_word_embeddings=True, pad_token_id=50256,
                    bos_token_id=50256, eos_token_id=50256,
                    decoder_start_token_id=50257),
}


def with_config_defaults(raw: dict) -> dict:
    """config.json's dict with the config class's defaults under it."""
    mt = raw.get("model_type")
    return {**HF_CONFIG_DEFAULTS.get(mt, FAMILY_CONFIG_DEFAULTS.get(mt, {})),
            **raw}


def config_from_hf(hf_config, dtype: str = "bfloat16") -> TransformerConfig:
    """Map a transformers config object (or a plain dict) onto
    TransformerConfig, as the JAX package does; NotImplementedError for
    shapes the block structure cannot represent."""
    get = (hf_config.get if isinstance(hf_config, dict)
           else lambda k, d=None: getattr(hf_config, k, d))
    mt = get("model_type")
    if mt == "gpt_neox":
        act = get("hidden_act", "gelu")
        if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh", "gelu_fast"):
            raise NotImplementedError(f"GPT-NeoX activation {act!r}")
        return TransformerConfig(
            vocab_size=get("vocab_size"), d_model=get("hidden_size"),
            n_heads=get("num_attention_heads"),
            n_layers=get("num_hidden_layers"), d_ff=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 2048), dtype=dtype,
            rope_theta=float(get("rotary_emb_base", 10000.0)),
            rope_pct=float(get("rotary_pct", 1.0)),
            norm_eps=float(get("layer_norm_eps", 1e-5)),
            norm="layernorm", pos="rope", mlp_type="gelu", proj_bias=True,
            parallel_residual=bool(get("use_parallel_residual", True)),
            gelu_exact=act == "gelu")
    if mt == "gpt2":
        act = get("activation_function", "gelu_new")
        if act not in ("gelu_new", "gelu_pytorch_tanh"):
            raise NotImplementedError(
                f"GPT-2 activation {act!r} not supported (tanh-GELU only)")
        d = get("n_embd")
        return TransformerConfig(
            vocab_size=get("vocab_size"), d_model=d, n_heads=get("n_head"),
            n_layers=get("n_layer"), d_ff=get("n_inner") or 4 * d,
            max_seq_len=get("n_positions", 1024), dtype=dtype,
            norm_eps=float(get("layer_norm_epsilon", 1e-5)),
            norm="layernorm", pos="learned", mlp_type="gelu", proj_bias=True)
    if mt == "deepseek_v3":
        # MLA attention with low-rank q/kv latents and a decoupled rope key;
        # sigmoid-routed MoE with shared experts and group-limited routing
        if get("rope_scaling"):
            raise NotImplementedError(
                "deepseek_v3 yarn rope_scaling not supported")
        if get("attention_bias"):
            raise NotImplementedError("deepseek_v3 attention_bias")
        return TransformerConfig(
            vocab_size=get("vocab_size"), d_model=get("hidden_size"),
            n_heads=get("num_attention_heads"),
            n_layers=get("num_hidden_layers"), d_ff=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 4096), dtype=dtype,
            rope_theta=float(get("rope_theta", 10000.0)),
            norm_eps=float(get("rms_norm_eps", 1e-6)), attention="mla",
            q_lora_rank=get("q_lora_rank") or 0,
            kv_lora_rank=get("kv_lora_rank"),
            qk_nope_head_dim=get("qk_nope_head_dim"),
            qk_rope_head_dim=get("qk_rope_head_dim"),
            v_head_dim=get("v_head_dim"),
            rope_interleave=bool(get("rope_interleave", True)),
            n_experts=get("n_routed_experts") or 0,
            moe_top_k=get("num_experts_per_tok") or 8,
            n_shared_experts=get("n_shared_experts") or 0,
            moe_d_ff=get("moe_intermediate_size"), moe_score="sigmoid",
            moe_norm_topk=bool(get("norm_topk_prob", True)),
            moe_routed_scale=float(get("routed_scaling_factor", 1.0)),
            moe_n_group=get("n_group") or 1,
            moe_topk_group=get("topk_group") or 1, moe_score_bias=True,
            moe_first_dense=get("first_k_dense_replace") or 0)
    d_model = get("hidden_size")
    n_heads = get("num_attention_heads")
    head_dim = get("head_dim") or d_model // n_heads
    if head_dim != d_model // n_heads:
        raise NotImplementedError(
            f"custom head_dim {head_dim} != hidden_size/num_heads "
            f"{d_model // n_heads} is not supported")
    if mt == "gemma":
        # sqrt(d) embedding scale, (1 + w) RMSNorm, GeGLU, tied head; the
        # param layout is Llama's
        return TransformerConfig(
            vocab_size=get("vocab_size"), d_model=d_model, n_heads=n_heads,
            n_layers=get("num_hidden_layers"), d_ff=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 8192), dtype=dtype,
            rope_theta=float(get("rope_theta", 10000.0)),
            norm_eps=float(get("rms_norm_eps", 1e-6)),
            n_kv_heads=get("num_key_value_heads") or n_heads,
            norm="rms_offset", mlp_type="geglu", embed_scale=True)
    rope_scaling, rope_type = 1.0, "linear"
    rs = get("rope_scaling")
    if rs:
        kind = rs.get("rope_type", rs.get("type"))
        if kind != "linear":
            raise NotImplementedError(
                f"rope_scaling type {kind!r} not supported (linear only)")
        rope_scaling = float(rs["factor"])
    window = get("sliding_window")
    if window is not None and get("use_sliding_window") is False:
        window = None  # Qwen2-style gate: configured but disabled
    # Mixtral (num_local_experts) or Qwen3-MoE (num_experts); other
    # families that publish num_experts carry shared experts or per-head
    # norms this map lacks, so they fail loudly
    n_experts = get("num_local_experts") or 0
    if not n_experts and get("num_experts"):
        if mt != "qwen3_moe":
            raise NotImplementedError(
                f"MoE model_type {mt!r} with num_experts is not supported "
                "(shared-expert layouts like qwen2_moe/olmoe are not "
                "mapped); supported MoE families: mixtral "
                "(num_local_experts), qwen3_moe")
        n_experts = get("num_experts")
    if mt == "qwen3_moe" and (get("mlp_only_layers")
                              or get("decoder_sparse_step", 1) != 1):
        raise NotImplementedError(
            "qwen3_moe heterogeneous dense/sparse layer patterns")
    return TransformerConfig(
        qk_norm=mt in ("qwen3", "qwen3_moe"), n_experts=n_experts,
        moe_top_k=get("num_experts_per_tok") or 2,
        moe_d_ff=get("moe_intermediate_size"),
        moe_norm_topk=bool(get("norm_topk_prob", True)),
        vocab_size=get("vocab_size"), d_model=d_model, n_heads=n_heads,
        n_layers=get("num_hidden_layers"), d_ff=get("intermediate_size"),
        max_seq_len=get("max_position_embeddings", 2048), dtype=dtype,
        rope_theta=float(get("rope_theta", 10000.0)),
        norm_eps=float(get("rms_norm_eps", 1e-6)),
        rope_scaling=rope_scaling, rope_scaling_type=rope_type,
        n_kv_heads=get("num_key_value_heads") or n_heads,
        attention_window=window)


# -- state dict -> params -------------------------------------------------


class _Reader:
    """fp32 tensors on `device` from a state dict of torch tensors or
    arrays: A(name) as stored, W(name) transposed (HF (out, in) -> ours
    (in, out)).  A 16-bit tensor moves to the device before it widens."""

    def __init__(self, sd, device):
        self.sd, self.device = sd, device

    def __contains__(self, name):
        return name in self.sd

    def A(self, name):
        t = self.sd[name]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.asarray(t, np.float32))
        return t.detach().to(self.device).float().contiguous()

    def W(self, name):
        return self.A(name).t().contiguous()


def _deinterleave_qkv(w, cfg: TransformerConfig, axis: int):
    """GPT-NeoX packs query_key_value per head ([q_h0|k_h0|v_h0|q_h1|...]);
    ours packs per projection ([q all heads|k|v]).  Reorders `axis`."""
    h, hd = cfg.n_heads, cfg.head_dim
    pre = list(w.shape[:axis])
    w = w.reshape(*pre, h, 3, hd).movedim(axis + 1, axis)
    return w.reshape(*pre, 3 * h * hd).contiguous()


def _params_neox(r: _Reader, cfg: TransformerConfig):
    """gpt_neox.{embed_in, layers.N.*, final_layer_norm} + embed_out."""
    params = {"embed": r.A("embed_in.weight"),
              "final_norm": r.A("final_layer_norm.weight"),
              "final_norm_b": r.A("final_layer_norm.bias"),
              "lm_head": r.W("embed_out.weight"), "blocks": []}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        params["blocks"].append({
            "attn_norm": r.A(p + "input_layernorm.weight"),
            "attn_norm_b": r.A(p + "input_layernorm.bias"),
            "wqkv": _deinterleave_qkv(
                r.W(p + "attention.query_key_value.weight"), cfg, 1),
            "bqkv": _deinterleave_qkv(
                r.A(p + "attention.query_key_value.bias"), cfg, 0),
            "wo": r.W(p + "attention.dense.weight"),
            "bo": r.A(p + "attention.dense.bias"),
            "mlp_norm": r.A(p + "post_attention_layernorm.weight"),
            "mlp_norm_b": r.A(p + "post_attention_layernorm.bias"),
            "w_fc": r.W(p + "mlp.dense_h_to_4h.weight"),
            "b_fc": r.A(p + "mlp.dense_h_to_4h.bias"),
            "w_proj": r.W(p + "mlp.dense_4h_to_h.weight"),
            "b_proj": r.A(p + "mlp.dense_4h_to_h.bias"),
        })
    return params


def _params_gpt2(r: _Reader, cfg: TransformerConfig):
    """transformer.{wte, wpe, h.N.*, ln_f}; Conv1D weights are (in, out)
    already, and the head is always the tied wte."""
    params = {"embed": r.A("wte.weight"), "pos_embed": r.A("wpe.weight"),
              "final_norm": r.A("ln_f.weight"),
              "final_norm_b": r.A("ln_f.bias"), "blocks": []}
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        params["blocks"].append({
            "attn_norm": r.A(p + "ln_1.weight"),
            "attn_norm_b": r.A(p + "ln_1.bias"),
            "wqkv": r.A(p + "attn.c_attn.weight"),
            "bqkv": r.A(p + "attn.c_attn.bias"),
            "wo": r.A(p + "attn.c_proj.weight"),
            "bo": r.A(p + "attn.c_proj.bias"),
            "mlp_norm": r.A(p + "ln_2.weight"),
            "mlp_norm_b": r.A(p + "ln_2.bias"),
            "w_fc": r.A(p + "mlp.c_fc.weight"),
            "b_fc": r.A(p + "mlp.c_fc.bias"),
            "w_proj": r.A(p + "mlp.c_proj.weight"),
            "b_proj": r.A(p + "mlp.c_proj.bias"),
        })
    return params


def _swiglu(r: _Reader, p: str, gate: str, up: str, down: str):
    return {"w_gate": r.W(p + gate), "w_up": r.W(p + up),
            "w_down": r.W(p + down)}


def _mla_attention(r: _Reader, p: str, cfg: TransformerConfig) -> dict:
    """DeepSeek latent attention; kv_b_proj packs [k_nope | v] per head."""
    h = cfg.n_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    v_dim = cfg.v_head_dim or (nope + rope)
    d_c = cfg.kv_lora_rank
    blk = {}
    if cfg.q_lora_rank:
        blk["w_dq"] = r.W(p + "self_attn.q_a_proj.weight")
        blk["q_norm"] = r.A(p + "self_attn.q_a_layernorm.weight")
        blk["w_uq"] = r.W(p + "self_attn.q_b_proj.weight")
    else:
        blk["w_q"] = r.W(p + "self_attn.q_proj.weight")
    blk["w_dkv"] = r.W(p + "self_attn.kv_a_proj_with_mqa.weight")
    blk["kv_norm"] = r.A(p + "self_attn.kv_a_layernorm.weight")
    wkv = r.W(p + "self_attn.kv_b_proj.weight").reshape(d_c, h, nope + v_dim)
    blk["w_uk"] = wkv[..., :nope].reshape(d_c, h * nope)
    blk["w_uv"] = wkv[..., nope:].reshape(d_c, h * v_dim)
    return blk


def params_from_hf(state_dict, cfg: TransformerConfig,
                   tied: bool | None = None, device=None):
    """An HF Llama-family, GPT-2 or GPT-NeoX state dict (torch tensors or
    arrays, any float dtype) -> the port's params, fp32 on `device` (the
    card by default).  `tied`: whether the LM head is the embedding (None:
    tied when the dict has no lm_head.weight)."""
    dev = resolve_device(device)
    if cfg.pos == "learned":  # GPT-2 layout
        return _params_gpt2(_Reader({k.removeprefix("transformer."): v
                                     for k, v in state_dict.items()}, dev),
                            cfg)
    if cfg.parallel_residual:  # GPT-NeoX / Pythia layout
        return _params_neox(_Reader({k.removeprefix("gpt_neox."): v
                                     for k, v in state_dict.items()}, dev),
                            cfg)
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    for k in sd:
        if k.endswith((".o_proj.bias", ".gate_proj.bias", ".up_proj.bias",
                       ".down_proj.bias")):
            raise NotImplementedError(f"bias not supported ({k})")
    r = _Reader(sd, dev)
    params = {"embed": r.A("embed_tokens.weight"),
              "final_norm": r.A("norm.weight"), "blocks": []}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        blk = {"attn_norm": r.A(p + "input_layernorm.weight"),
               "wo": r.W(p + "self_attn.o_proj.weight"),
               "mlp_norm": r.A(p + "post_attention_layernorm.weight")}
        if cfg.attention == "mla":
            blk.update(_mla_attention(r, p, cfg))
        else:
            blk["wqkv"] = torch.cat(
                [r.W(p + f"self_attn.{n}_proj.weight") for n in "qkv"], dim=1)
        if p + "mlp.gate.weight" in r:
            # DeepSeek / Qwen3-MoE: mlp.{gate, experts.N.*_proj,
            # shared_experts.*}; dense layers fall through below
            blk["router"] = r.W(p + "mlp.gate.weight")
            if p + "mlp.gate.e_score_correction_bias" in r:
                blk["router_bias"] = r.A(
                    p + "mlp.gate.e_score_correction_bias")
            blk["experts"] = [
                _swiglu(r, p + f"mlp.experts.{e}.", "gate_proj.weight",
                        "up_proj.weight", "down_proj.weight")
                for e in range(cfg.n_experts)]
            if p + "mlp.shared_experts.gate_proj.weight" in r:
                blk["shared"] = _swiglu(
                    r, p + "mlp.shared_experts.", "gate_proj.weight",
                    "up_proj.weight", "down_proj.weight")
        elif cfg.n_experts and p + "block_sparse_moe.gate.weight" in r:
            # Mixtral: block_sparse_moe.{gate, experts.N.w1/w3/w2}
            blk["router"] = r.W(p + "block_sparse_moe.gate.weight")
            blk["experts"] = [
                _swiglu(r, p + f"block_sparse_moe.experts.{e}.", "w1.weight",
                        "w3.weight", "w2.weight")
                for e in range(cfg.n_experts)]
        else:
            blk.update(_swiglu(r, p + "mlp.", "gate_proj.weight",
                               "up_proj.weight", "down_proj.weight"))
        if cfg.qk_norm:  # Qwen3: per-head (head_dim,) q/k norm gains
            blk["q_norm"] = r.A(p + "self_attn.q_norm.weight")
            blk["k_norm"] = r.A(p + "self_attn.k_norm.weight")
        if p + "self_attn.q_proj.bias" in r:  # Qwen2-family QKV bias
            blk["bqkv"] = torch.cat(
                [r.A(p + f"self_attn.{n}_proj.bias") for n in "qkv"])
        params["blocks"].append(blk)
    if tied is None:
        tied = "lm_head.weight" not in state_dict
    if not tied:
        params["lm_head"] = _Reader(state_dict, dev).W("lm_head.weight")
    return params


# -- params -> state dict -------------------------------------------------


def to_hf(params, cfg: TransformerConfig) -> dict:
    """The inverse of params_from_hf: the port's params -> an HF state dict
    of fp32 CPU tensors (loadable into the family's *ForCausalLM with
    load_state_dict).  Tied Llama-family params emit no lm_head.weight."""

    def A(x):
        return x.detach().float().cpu().contiguous()

    def T(x):  # ours (in, out) -> HF (out, in)
        return x.detach().float().cpu().t().contiguous()

    if cfg.parallel_residual:  # GPT-NeoX / Pythia layout
        h, hd = cfg.n_heads, cfg.head_dim

        def IW(x):  # ours (in, 3D per projection) -> HF (3D per head, in)
            x = x.detach().float().cpu().reshape(-1, 3, h, hd)
            return x.movedim(1, 2).reshape(-1, 3 * h * hd).t().contiguous()

        def IB(x):
            x = x.detach().float().cpu().reshape(3, h, hd)
            return x.movedim(0, 1).reshape(-1).contiguous()

        sd = {"gpt_neox.embed_in.weight": A(params["embed"]),
              "gpt_neox.final_layer_norm.weight": A(params["final_norm"]),
              "gpt_neox.final_layer_norm.bias": A(params["final_norm_b"]),
              "embed_out.weight": T(params["lm_head"])}
        for i, blk in enumerate(params["blocks"]):
            p = f"gpt_neox.layers.{i}."
            sd.update({
                p + "input_layernorm.weight": A(blk["attn_norm"]),
                p + "input_layernorm.bias": A(blk["attn_norm_b"]),
                p + "attention.query_key_value.weight": IW(blk["wqkv"]),
                p + "attention.query_key_value.bias": IB(blk["bqkv"]),
                p + "attention.dense.weight": T(blk["wo"]),
                p + "attention.dense.bias": A(blk["bo"]),
                p + "post_attention_layernorm.weight": A(blk["mlp_norm"]),
                p + "post_attention_layernorm.bias": A(blk["mlp_norm_b"]),
                p + "mlp.dense_h_to_4h.weight": T(blk["w_fc"]),
                p + "mlp.dense_h_to_4h.bias": A(blk["b_fc"]),
                p + "mlp.dense_4h_to_h.weight": T(blk["w_proj"]),
                p + "mlp.dense_4h_to_h.bias": A(blk["b_proj"]),
            })
        return sd

    if cfg.pos == "learned":  # GPT-2 layout: Conv1D weights, no transpose
        sd = {"transformer.wte.weight": A(params["embed"]),
              "transformer.wpe.weight": A(params["pos_embed"]),
              "transformer.ln_f.weight": A(params["final_norm"]),
              "transformer.ln_f.bias": A(params["final_norm_b"]),
              "lm_head.weight": A(params["embed"])}  # tied
        names = {"ln_1.weight": "attn_norm", "ln_1.bias": "attn_norm_b",
                 "attn.c_attn.weight": "wqkv", "attn.c_attn.bias": "bqkv",
                 "attn.c_proj.weight": "wo", "attn.c_proj.bias": "bo",
                 "ln_2.weight": "mlp_norm", "ln_2.bias": "mlp_norm_b",
                 "mlp.c_fc.weight": "w_fc", "mlp.c_fc.bias": "b_fc",
                 "mlp.c_proj.weight": "w_proj", "mlp.c_proj.bias": "b_proj"}
        for i, blk in enumerate(params["blocks"]):
            for hf, ours in names.items():
                sd[f"transformer.h.{i}.{hf}"] = A(blk[ours])
        return sd

    h = cfg.n_heads
    sd = {"model.embed_tokens.weight": A(params["embed"]),
          "model.norm.weight": A(params["final_norm"])}
    for i, blk in enumerate(params["blocks"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = A(blk["attn_norm"])
        if cfg.attention == "mla":
            nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
            v_dim = cfg.v_head_dim or (nope + rope)
            d_c = cfg.kv_lora_rank
            if "w_dq" in blk:
                sd[p + "self_attn.q_a_proj.weight"] = T(blk["w_dq"])
                sd[p + "self_attn.q_a_layernorm.weight"] = A(blk["q_norm"])
                sd[p + "self_attn.q_b_proj.weight"] = T(blk["w_uq"])
            else:
                sd[p + "self_attn.q_proj.weight"] = T(blk["w_q"])
            sd[p + "self_attn.kv_a_proj_with_mqa.weight"] = T(blk["w_dkv"])
            sd[p + "self_attn.kv_a_layernorm.weight"] = A(blk["kv_norm"])
            wkv = torch.cat([blk["w_uk"].reshape(d_c, h, nope),
                             blk["w_uv"].reshape(d_c, h, v_dim)], dim=-1)
            sd[p + "self_attn.kv_b_proj.weight"] = T(
                wkv.reshape(d_c, h * (nope + v_dim)))
        else:
            hkv, hd = cfg.kv_heads, cfg.head_dim
            cuts = (0, h * hd, (h + hkv) * hd, (h + 2 * hkv) * hd)
            for j, n in enumerate("qkv"):
                sd[p + f"self_attn.{n}_proj.weight"] = T(
                    blk["wqkv"][:, cuts[j]:cuts[j + 1]])
                if "bqkv" in blk:
                    sd[p + f"self_attn.{n}_proj.bias"] = A(
                        blk["bqkv"][cuts[j]:cuts[j + 1]])
        if "q_norm" in blk and cfg.qk_norm:
            sd[p + "self_attn.q_norm.weight"] = A(blk["q_norm"])
            sd[p + "self_attn.k_norm.weight"] = A(blk["k_norm"])
        sd[p + "self_attn.o_proj.weight"] = T(blk["wo"])
        sd[p + "post_attention_layernorm.weight"] = A(blk["mlp_norm"])
        if "experts" in blk and (cfg.attention == "mla" or cfg.qk_norm
                                 or "shared" in blk or "router_bias" in blk):
            # DeepSeek / Qwen3-MoE layout
            sd[p + "mlp.gate.weight"] = T(blk["router"])
            if "router_bias" in blk:
                sd[p + "mlp.gate.e_score_correction_bias"] = A(
                    blk["router_bias"])
            experts = [(f"mlp.experts.{e}.", ex)
                       for e, ex in enumerate(blk["experts"])]
            if "shared" in blk:
                experts.append(("mlp.shared_experts.", blk["shared"]))
            for ep, ex in experts:
                sd[p + ep + "gate_proj.weight"] = T(ex["w_gate"])
                sd[p + ep + "up_proj.weight"] = T(ex["w_up"])
                sd[p + ep + "down_proj.weight"] = T(ex["w_down"])
        elif "experts" in blk:  # Mixtral layout
            sd[p + "block_sparse_moe.gate.weight"] = T(blk["router"])
            for e, ex in enumerate(blk["experts"]):
                ep = p + f"block_sparse_moe.experts.{e}."
                sd[ep + "w1.weight"] = T(ex["w_gate"])
                sd[ep + "w3.weight"] = T(ex["w_up"])
                sd[ep + "w2.weight"] = T(ex["w_down"])
        else:
            sd[p + "mlp.gate_proj.weight"] = T(blk["w_gate"])
            sd[p + "mlp.up_proj.weight"] = T(blk["w_up"])
            sd[p + "mlp.down_proj.weight"] = T(blk["w_down"])
    if "lm_head" in params:
        sd["lm_head.weight"] = T(params["lm_head"])
    return sd


# -- checkpoint files ------------------------------------------------------

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path) -> dict:
    """{name: CPU tensor} from one .safetensors file.  The tensors are
    views of one buffer holding the file (a misaligned one is copied)."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        n = int.from_bytes(head, "little")
        if n > size - 8:
            raise ValueError(
                f"{path}: header of {n} bytes past the file's end")
        header = json.loads(f.read(n))
        data = bytearray(size - 8 - n)
        if f.readinto(memoryview(data)) != len(data):
            raise ValueError(f"{path}: truncated")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise NotImplementedError(
                f"{path}: {name} has dtype {info['dtype']}")
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        item = torch.empty((), dtype=dtype).element_size()
        count = int(np.prod(shape, dtype=np.int64))
        if hi - lo != count * item or not 0 <= lo <= hi <= len(data):
            raise ValueError(f"{path}: {name}'s byte range {lo}..{hi} does "
                             f"not hold {shape} {info['dtype']}")
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        elif lo % item == 0:
            t = torch.frombuffer(data, dtype=dtype, count=count, offset=lo)
        else:
            t = torch.frombuffer(bytearray(data[lo:hi]), dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def read_checkpoint(path) -> dict:
    """The state dict of a checkpoint directory: model.safetensors, the
    shards of model.safetensors.index.json, pytorch_model.bin or the
    shards of pytorch_model.bin.index.json (the first that exists)."""
    for single, index, read in (
            ("model.safetensors", "model.safetensors.index.json",
             read_safetensors),
            ("pytorch_model.bin", "pytorch_model.bin.index.json",
             lambda p: torch.load(p, map_location="cpu", weights_only=True))):
        if os.path.exists(os.path.join(path, single)):
            return read(os.path.join(path, single))
        if os.path.exists(os.path.join(path, index)):
            with open(os.path.join(path, index)) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            sd = {}
            for shard in shards:
                sd.update(read(os.path.join(path, shard)))
            return sd
    raise FileNotFoundError(f"{path}: no model.safetensors, "
                            "pytorch_model.bin or index of their shards")


def is_checkpoint_path(model_or_path) -> bool:
    """Whether a from_hf* argument names a directory (else it is a model
    instance)."""
    return isinstance(model_or_path, (str, bytes)) or hasattr(
        model_or_path, "__fspath__")


def read_hf_dir(path) -> tuple[dict, dict]:
    """(config.json with its config class's defaults under it, the state
    dict) of a checkpoint directory, through the readers above: neither
    transformers nor safetensors is imported.  Every from_hf* loader of
    the port reads a directory so."""
    path = os.fsdecode(path)
    with open(os.path.join(path, "config.json")) as f:
        raw = with_config_defaults(json.load(f))
    return raw, read_checkpoint(path)


def from_hf(model_or_path, dtype: str = "bfloat16", device=None):
    """(params, cfg) from a checkpoint directory or a transformers model
    instance (anything with .config and .state_dict()).  `dtype` is the
    activation dtype; params are fp32 on `device` (the card by default),
    the master-weight convention of both packages."""
    dev = resolve_device(device)
    if is_checkpoint_path(model_or_path):
        raw, state_dict = read_hf_dir(model_or_path)
        cfg = config_from_hf(raw, dtype=dtype)
        tied = bool(raw.get("tie_word_embeddings", True))
    else:
        hf_cfg = model_or_path.config
        cfg = config_from_hf(hf_cfg, dtype=dtype)
        tied = bool(getattr(hf_cfg, "tie_word_embeddings", False))
        state_dict = model_or_path.state_dict()
    return params_from_hf(state_dict, cfg, tied=tied, device=dev), cfg
