"""Port parity: Hugging Face checkpoint import and export
(kfunca_tpu_torch/models/hf.py) against the JAX package's models/hf.py.

The same transformers configs and the same random HF state dicts (tiny
models built with the transformers installed here) go through both
packages: configs must agree field for field, params and to_hf's state
dicts bit for bit, every refusal with the same message.  The port reads
checkpoint directories itself (no transformers, no safetensors); its reader
is held against transformers' own loading of the committed golden
checkpoints, and the golden tokens must come out of the port's generate
and InferenceServer(device="cpu").  These tests need transformers, so
they run on the CPU only.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import transformers
from transformers import AutoConfig, AutoModelForCausalLM

from kfunca_tpu.models import hf as jhf
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import hf as thf
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.generate import generate
from kfunca_tpu_torch.models.serve import InferenceServer
from kfunca_tpu_torch.utils.tree import tree_leaves

FIXDIR = Path(__file__).parent / "fixtures"
EAGER = dict(attn_implementation="eager")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: one intra-op thread runs them faster than
    many, and leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fields(cfg):
    return dataclasses.asdict(cfg)


def _golden(name):
    return json.loads((FIXDIR / "golden_tokens.json").read_text())[name]


# -- config_from_hf ------------------------------------------------------------

TINY = dict(vocab_size=128, hidden_size=64, num_attention_heads=4,
            num_hidden_layers=2, intermediate_size=96)
CONFIGS = {
    "llama": ("llama", dict(TINY, num_key_value_heads=2)),
    "llama_rope_linear": ("llama", dict(
        TINY, rope_scaling={"rope_type": "linear", "factor": 2.0})),
    "mistral": ("mistral", dict(TINY, sliding_window=32)),
    "qwen2": ("qwen2", dict(TINY, num_key_value_heads=2)),
    "qwen2_window": ("qwen2", dict(TINY, num_key_value_heads=2,
                                   use_sliding_window=True,
                                   sliding_window=16)),
    "qwen3": ("qwen3", dict(TINY, num_key_value_heads=2, head_dim=16)),
    "gemma": ("gemma", dict(TINY, num_key_value_heads=1, head_dim=16)),
    "gpt2": ("gpt2", dict(vocab_size=128, n_embd=64, n_head=4, n_layer=2,
                          n_positions=64)),
    "gpt_neox": ("gpt_neox", dict(TINY, rotary_pct=0.5)),
    "gpt_neox_tanh": ("gpt_neox", dict(TINY, hidden_act="gelu_new",
                                       use_parallel_residual=False)),
    "mixtral": ("mixtral", dict(TINY, num_local_experts=4)),
    "qwen3_moe": ("qwen3_moe", dict(TINY, head_dim=16, num_experts=8,
                                    moe_intermediate_size=32)),
    "deepseek_v3": ("deepseek_v3", dict(
        TINY, q_lora_rank=0, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
        first_k_dense_replace=1, n_group=2, topk_group=1)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_from_hf_matches_jax(name):
    """A transformers config object and its plain dict: both packages map
    them to the same TransformerConfig, field for field."""
    mt, kw = CONFIGS[name]
    hc = AutoConfig.for_model(mt, **kw)
    got = thf.config_from_hf(hc, dtype="float32")
    assert _fields(got) == _fields(jhf.config_from_hf(hc, dtype="float32"))
    raw = {"model_type": mt, **kw}
    assert _fields(thf.config_from_hf(raw)) == _fields(
        jhf.config_from_hf(raw))


REFUSALS = {
    "neox_relu": {"model_type": "gpt_neox", "hidden_act": "relu", **TINY},
    "gpt2_relu": {"model_type": "gpt2", "activation_function": "relu",
                  "n_embd": 64},
    "deepseek_yarn": {"model_type": "deepseek_v3", "rope_scaling": {
        "type": "yarn", "factor": 4.0}, **TINY},
    "deepseek_bias": {"model_type": "deepseek_v3", "attention_bias": True,
                      **TINY},
    "custom_head_dim": {"model_type": "llama", "head_dim": 32, **TINY},
    "rope_dynamic": {"model_type": "llama", "rope_scaling": {
        "type": "dynamic", "factor": 2.0}, **TINY},
    "qwen2_moe": {"model_type": "qwen2_moe", "num_experts": 8, **TINY},
    "qwen3_moe_dense_layers": {"model_type": "qwen3_moe", "num_experts": 8,
                               "mlp_only_layers": [0], **TINY},
    "qwen3_moe_sparse_step": {"model_type": "qwen3_moe", "num_experts": 8,
                              "decoder_sparse_step": 2, **TINY},
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_config_refusals_match_jax(name):
    raw = REFUSALS[name]
    with pytest.raises(NotImplementedError) as want:
        jhf.config_from_hf(raw)
    with pytest.raises(NotImplementedError) as got:
        thf.config_from_hf(raw)
    assert str(got.value) == str(want.value)


# config.json at sizes where each family's defaulted head_dim holds
# (Qwen3's 128, Gemma's 256), every defaulted key left out
STRUCTURE = dict(vocab_size=64, hidden_size=512, num_attention_heads=4,
                 num_hidden_layers=1, intermediate_size=64)


@pytest.mark.parametrize("mt", sorted(thf.HF_CONFIG_DEFAULTS))
def test_config_defaults_table_matches_transformers(mt):
    """A config.json that omits every key the table defaults gives, through
    the table, the TransformerConfig and tied flag that the JAX package
    gets from the same file through AutoConfig."""
    if mt == "gpt2":
        raw = dict(model_type=mt, vocab_size=64, n_embd=512, n_head=4,
                   n_layer=1)
    elif mt == "gemma":
        raw = dict(STRUCTURE, model_type=mt, num_attention_heads=2)
    else:
        raw = dict(STRUCTURE, model_type=mt)
    assert not set(raw) & set(thf.HF_CONFIG_DEFAULTS[mt]) - {"model_type"}
    hc = AutoConfig.for_model(**raw)
    merged = thf.with_config_defaults(raw)
    assert _fields(thf.config_from_hf(merged)) == _fields(
        jhf.config_from_hf(hc))
    assert merged["tie_word_embeddings"] == hc.tie_word_embeddings


def test_config_defaults_leave_given_keys_and_unknown_families():
    raw = {"model_type": "mistral", "sliding_window": None, **TINY}
    assert thf.with_config_defaults(raw)["sliding_window"] is None
    assert thf.with_config_defaults({"model_type": "opt"}) == {
        "model_type": "opt"}
    assert transformers.__version__ == "4.57.6"  # the table's source


# -- params_from_hf / to_hf ------------------------------------------------------

MODELS = {
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(TINY, num_key_value_heads=2, tie_word_embeddings=False)),
    "llama_tied": ("LlamaConfig", "LlamaForCausalLM",
                   dict(TINY, tie_word_embeddings=True)),
    "qwen2_bias": ("Qwen2Config", "Qwen2ForCausalLM",
                   dict(TINY, num_key_value_heads=2)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM",
              dict(TINY, num_key_value_heads=2, head_dim=16)),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(TINY, num_key_value_heads=1, head_dim=16)),
    "gpt2": ("GPT2Config", "GPT2LMHeadModel",
             dict(vocab_size=128, n_embd=64, n_head=4, n_layer=2,
                  n_positions=64)),
    "gpt_neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM",
                 dict(TINY, rotary_pct=0.25, tie_word_embeddings=False)),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(TINY, num_key_value_heads=2, num_local_experts=4)),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                  dict(TINY, head_dim=16, num_experts=4,
                       moe_intermediate_size=32, num_key_value_heads=2)),
    "deepseek_v3": ("DeepseekV3Config", "DeepseekV3ForCausalLM",
                    dict(TINY, q_lora_rank=32, kv_lora_rank=16,
                         qk_nope_head_dim=16, qk_rope_head_dim=8,
                         v_head_dim=16, n_routed_experts=4,
                         num_experts_per_tok=2, n_shared_experts=1,
                         moe_intermediate_size=32, first_k_dense_replace=1,
                         n_group=2, topk_group=1, num_key_value_heads=4,
                         rope_scaling=None)),
    "deepseek_v3_direct_q": ("DeepseekV3Config", "DeepseekV3ForCausalLM",
                             dict(TINY, q_lora_rank=None, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16, n_routed_experts=4,
                                  num_experts_per_tok=2, n_shared_experts=1,
                                  moe_intermediate_size=32,
                                  first_k_dense_replace=1, n_group=2,
                                  topk_group=1, rope_scaling=None)),
}


@pytest.fixture(scope="module")
def hf_models():
    """One tiny random transformers model a family, with random norm gains
    and biases (a freshly built model has them at 1 and 0)."""
    out = {}
    for name, (cfg_cls, model_cls, kw) in MODELS.items():
        hc = getattr(transformers, cfg_cls)(**kw, **EAGER)
        torch.manual_seed(len(name))
        model = getattr(transformers, model_cls)(hc).eval()
        with torch.no_grad():
            for pname, p in model.named_parameters():
                if p.ndim == 1:
                    p.uniform_(-0.5, 1.5)
        out[name] = model
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_params_from_hf_and_to_hf_match_jax(hf_models, name):
    model = hf_models[name]
    cfg_t = thf.config_from_hf(model.config, dtype="float32")
    cfg_j = jhf.config_from_hf(model.config, dtype="float32")
    tied = bool(getattr(model.config, "tie_word_embeddings", False))
    sd = model.state_dict()
    want = jhf.params_from_hf(sd, cfg_j, tied=tied)
    got = thf.params_from_hf(sd, cfg_t, tied=tied, device="cpu")
    a, b = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, got)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, want))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == torch.float32 and x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    sd_t, sd_j = thf.to_hf(got, cfg_t), jhf.to_hf(want, cfg_j)
    assert sorted(sd_t) == sorted(sd_j)
    for k in sd_t:
        assert torch.equal(sd_t[k], sd_j[k]), k
        assert torch.equal(sd_t[k], sd[k].float()), k  # the HF original


def test_from_hf_of_a_model_instance_matches_jax(hf_models):
    for name in ("llama", "gpt2", "qwen2_bias"):
        model = hf_models[name]
        got, cfg_t = thf.from_hf(model, dtype="float32", device="cpu")
        want, cfg_j = jhf.from_hf(model, dtype="float32")
        assert _fields(cfg_t) == _fields(cfg_j)
        for x, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_moe_and_mla_load_but_the_forward_waits(hf_models):
    """MoE and MLA checkpoints load into TransformerConfig and params, and
    (the forward no longer waits) the port's forward over its from_hf load
    gives the JAX forward's logits over the JAX package's load, and
    transformers' own: Mixtral, Qwen3-MoE and DeepSeek-V3 with a low-rank
    and a direct query.  fp32: 1e-4 (sums in other orders; the random
    routers leave no near tie between experts).  Two of the module's tiny
    models keep family defaults that transformers' own forward cannot run
    (Qwen3-MoE's 8 experts a token over 4, DeepSeek-V3's 128 kv heads over
    4 heads, which its eager attention repeats 0 times): their twins here
    take 2 experts a token and 4 kv heads, which neither package reads
    otherwise."""
    tokens = np.random.default_rng(2).integers(0, 128, (2, 12))
    twins = {"qwen3_moe": dict(num_experts_per_tok=2),
             "deepseek_v3_direct_q": dict(num_key_value_heads=4)}
    for name in ("mixtral", "qwen3_moe", "deepseek_v3",
                 "deepseek_v3_direct_q"):
        model = hf_models[name]
        if name in twins:
            cfg_cls, model_cls, kw = MODELS[name]
            torch.manual_seed(9)
            model = getattr(transformers, model_cls)(getattr(
                transformers, cfg_cls)(**{**kw, **twins[name]},
                                       **EAGER)).eval()
        params, cfg = thf.from_hf(model, dtype="float32", device="cpu")
        assert "router" in params["blocks"][-1]
        got = ttf.forward(params, torch.from_numpy(tokens), cfg).numpy()
        params_j, cfg_j = jhf.from_hf(model, dtype="float32")
        want = np.asarray(jtf.forward(params_j, jnp.asarray(
            tokens, jnp.int32), cfg_j))
        with torch.no_grad():
            hf_logits = model(torch.from_numpy(tokens)).logits.numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(got, hf_logits, atol=1e-4, err_msg=name)


# -- the golden checkpoints ----------------------------------------------------


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def golden(request):
    name = request.param
    path = FIXDIR / f"golden_{name}"
    params, cfg = thf.from_hf(path, dtype="float32", device="cpu")
    return dict(name=name, path=path, params=params, cfg=cfg,
                g=_golden(name))


def test_golden_checkpoint_generate_and_serve_token_exact(golden):
    g, params, cfg = golden["g"], golden["params"], golden["cfg"]
    out = generate(params, torch.tensor([g["prompt"]]), cfg,
                   max_new=len(g["golden"]))
    assert out[0].tolist() == g["golden"]
    srv = InferenceServer(params, cfg, batch_slots=2, page_size=8,
                          n_pages=16, max_pages_per_seq=4, device="cpu")
    assert not srv.fused_pool  # kv widths of 32 and 64: split pools (K6)
    rid = srv.submit(g["prompt"], max_new=len(g["golden"]))
    assert srv.run()[rid] == g["golden"]


def test_golden_checkpoint_logits_match_jax_from_hf(golden):
    """The port's forward over its own load of the file, against the JAX
    package's forward over its transformers load: 1e-4 (fp32 sums in
    another order)."""
    params_j, cfg_j = jhf.from_hf(str(golden["path"]), dtype="float32")
    assert _fields(golden["cfg"]) == _fields(cfg_j)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 24))
    want = np.asarray(jtf.forward(params_j, jnp.asarray(tokens, jnp.int32),
                                  cfg_j))
    got = ttf.forward(golden["params"], torch.from_numpy(tokens),
                      golden["cfg"]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_reader_matches_transformers_state_dict(golden):
    """Every tensor the port reads from the file equals, bit for bit, the
    one transformers loads; a tied head the file leaves out (golden_gpt2's
    lm_head) is the embedding."""
    sd = thf.read_checkpoint(golden["path"])
    model = AutoModelForCausalLM.from_pretrained(golden["path"])
    ref = model.state_dict()
    assert set(sd) <= set(ref)
    for k, v in sd.items():
        assert v.dtype == ref[k].dtype and torch.equal(v, ref[k]), k
    if golden["name"] == "gpt2":
        assert "lm_head.weight" not in sd and "lm_head" not in golden["params"]


# -- checkpoint files ------------------------------------------------------------


def _save_shards(sd, path, n_shards, dtype):
    """transformers-style shards of `sd` in `dtype` and their index."""
    from safetensors.torch import save_file

    names = sorted(sd)
    path.mkdir(parents=True, exist_ok=True)
    weight_map = {}
    for i in range(n_shards):
        shard = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        part = names[i::n_shards]
        save_file({k: sd[k].to(dtype).contiguous() for k in part},
                  str(path / shard))
        weight_map.update({k: shard for k in part})
    if n_shards == 1:
        os.replace(path / shard, path / "model.safetensors")
    else:
        (path / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {}, "weight_map": weight_map}))


@pytest.mark.parametrize("layout", ["sharded_bf16", "single_f16",
                                    "torch_bin"])
def test_checkpoint_layouts_load(hf_models, tmp_path, layout):
    """A bf16 checkpoint in two shards with an index, an fp16 single file,
    and pytorch_model.bin: from_hf gives the params of the rounded state
    dict, widened to fp32 exactly."""
    model = hf_models["llama"]
    sd = model.state_dict()
    raw = {k: v for k, v in model.config.to_dict().items()
           if k in ("model_type", "vocab_size", "hidden_size",
                    "num_attention_heads", "num_key_value_heads",
                    "num_hidden_layers", "intermediate_size",
                    "rms_norm_eps", "tie_word_embeddings")}
    dtype = {"sharded_bf16": torch.bfloat16, "single_f16": torch.float16,
             "torch_bin": torch.bfloat16}[layout]
    if layout == "torch_bin":
        tmp_path.mkdir(exist_ok=True)
        torch.save({k: v.to(dtype) for k, v in sd.items()},
                   tmp_path / "pytorch_model.bin")
    else:
        _save_shards(sd, tmp_path, 2 if layout == "sharded_bf16" else 1,
                     dtype)
    (tmp_path / "config.json").write_text(json.dumps(raw))
    got, cfg = thf.from_hf(tmp_path, dtype="bfloat16", device="cpu")
    cfg_want = thf.config_from_hf(model.config, dtype="bfloat16")
    assert _fields(cfg) == _fields(cfg_want)
    want = thf.params_from_hf({k: v.to(dtype) for k, v in sd.items()},
                              cfg_want, tied=False, device="cpu")
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert x.dtype == torch.float32 and torch.equal(x, y)


def test_tied_checkpoint_without_a_head(hf_models, tmp_path):
    """A tied Llama-family checkpoint stores the head once: the file lacks
    lm_head.weight and the params carry no "lm_head"."""
    model = hf_models["llama_tied"]
    sd = {k: v for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    _save_shards(sd, tmp_path, 1, torch.float32)
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "llama", **TINY, "tie_word_embeddings": True}))
    params, cfg = thf.from_hf(tmp_path, dtype="float32", device="cpu")
    assert "lm_head" not in params
    want, _ = jhf.from_hf(model, dtype="float32")
    for x, y in zip(tree_leaves(params), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_reader_refuses_broken_files(tmp_path):
    bad = tmp_path / "model.safetensors"
    bad.write_bytes((10 ** 6).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="past the file's end"):
        thf.read_safetensors(bad)
    header = json.dumps({"w": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 12]}}).encode()
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(12))
    with pytest.raises(ValueError, match="byte range"):
        thf.read_safetensors(bad)
    header = json.dumps({"w": {"dtype": "F8_E4M3", "shape": [4],
                               "data_offsets": [0, 4]}}).encode()
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(4))
    with pytest.raises(NotImplementedError, match="F8_E4M3"):
        thf.read_safetensors(bad)
    with pytest.raises(FileNotFoundError):
        thf.read_checkpoint(tmp_path / "nowhere")
