"""The port stands alone: kfunca_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and the port's entry points refuse to run on the
CPU unless the caller asks for it."""

import ast
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

import numpy as np

from kfunca_tpu_torch.models import (
    data, eval as evaluation, generate, serve, train, trainer, transformer,
    weights)
from kfunca_tpu_torch.runtime import backend
from kfunca_tpu_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "kfunca_tpu_torch"
SMALL = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=512, max_seq_len=256, dtype="float32")


def _foreign(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "kfunca_tpu")


def test_importing_the_port_loads_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    no jax, jaxlib or kfunca_tpu module in sys.modules."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "import kfunca_tpu_torch as pkg",
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "for want in ('models.serve', 'models.train', 'models.trainer',",
        "             'models.loss', 'models.data', 'models.eval',",
        "             'ops.attention', 'ops.pallas_kernels.flash_attention',",
        "             'ops.pallas_kernels.paged_attention', 'ops.quant',",
        "             'models.generate', 'models.weights',",
        "             'utils.checkpoint', 'core.dtype', 'core.storage',",
        "             'core.overlap', 'core.materialize', 'core.iterator',",
        "             'core.tensor', 'core.dispatch', 'ops.elementwise',",
        "             'ops.reduce', 'ops.gemm', 'ops.shape_ops', 'ops.index',",
        "             'ops.sort', 'ops.pallas_kernels.elementwise',",
        "             'ops.pallas_kernels.reduce', 'ops.pallas_kernels.welford',",
        "             'ops.pallas_kernels.matmul', 'runtime.launcher',",
        "             'runtime.allocator', 'utils.errors', 'utils.compare',",
        "             'utils.device_info', 'utils.profiling', 'models.mamba',",
        "             'models.mamba_serve', 'models.hybrid',",
        "             'ops.pallas_kernels.ssm_scan',",
        "             'ops.pallas_kernels.bitonic_sort', 'runtime._native',",
        "             'runtime.autotune', 'ops.pallas_kernels.ring_hop',",
        "             'parallel', 'parallel.ring_attention', 'models.hf',",
        "             'models.tokenizer', 'models.api_server',",
        "             'models.speculative', 'parallel.mesh',",
        "             'parallel.collectives', 'parallel.multihost',",
        "             'models.mla', 'models.mla_serve', 'models.lora',",
        "             'models.dpo', 'models.rlhf', 'models.distill',",
        "             'models.mamba2', 'models.vision', 'models.encoder',",
        "             'models.hf_vision', 'models.clip', 'models.dit',",
        "             'models.t5', 'models.whisper', 'models.audio',",
        "             'models.seq2seq', 'utils.orbax_format'):",
        "    assert 'kfunca_tpu_torch.' + want in names, (want, names)",
        "print(sorted(m for m in sys.modules",
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'kfunca_tpu')))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_import_in_the_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if _foreign(m)]
    assert bad == []


def test_orbax_interop_needs_no_orbax(tmp_path):
    """save_orbax / load_orbax read and write orbax's format themselves: no
    module of the port, and not chip_smoke.py, names orbax, tensorstore or
    zstandard, and a round trip in a fresh interpreter loads none of them
    (nor JAX)."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("orbax", "tensorstore", "zstandard")]
    assert bad == []
    code = "\n".join([
        "import sys, torch",
        "from kfunca_tpu_torch.utils import checkpoint",
        "tree = {'w': torch.arange(6.).reshape(2, 3).bfloat16(), 'step': 4}",
        f"checkpoint.save_orbax({str(tmp_path / 'c')!r}, tree)",
        f"got = checkpoint.load_orbax({str(tmp_path / 'c')!r}, tree, "
        "device='cpu')",
        "assert torch.equal(got['w'], tree['w']) and got['step'] == 4",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('orbax', 'tensorstore', 'zstandard', 'jax',",
        "              'kfunca_tpu')))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_every_source_the_port_builds_lies_in_the_port():
    """The CUDA kernels (csrc/*.cu, nvcc) and the native core (csrc/core.cpp,
    g++) build from the port's own sources into the port's build/: nothing
    is read or written under kfunca_tpu/."""
    from kfunca_tpu_torch.runtime import _kernels, _native

    sources = sorted(_kernels.CSRC.glob("*.cu")) + [_native.SRC]
    assert {"bitonic_sort.cu", "ssm_scan.cu", "matmul.cu", "ring_hop.cu",
            "core.cpp"} <= {
        p.name for p in sources}
    for src in sources:
        assert src.exists() and src.resolve().is_relative_to(PORT / "csrc"), src
    for lib in [_kernels.library_path(p.stem) for p in sources[:-1]] + [
            _native.library_path()]:
        assert lib.resolve().is_relative_to(PORT / "build"), lib


def test_an_edited_header_renames_every_library(monkeypatch, tmp_path):
    """K1/K2 and K12 include csrc/attention_wgmma.cuh, which includes
    attention_tile.cuh and hopper.cuh: a library's name hashes every header
    under csrc/, so an edited header rebuilds them."""
    from kfunca_tpu_torch.runtime import _kernels

    for name in ("flash_attention.cu", "ring_hop.cu"):
        assert '#include "attention_wgmma.cuh"' in (
            PORT / "csrc" / name).read_text()
    shared = (PORT / "csrc" / "attention_wgmma.cuh").read_text()
    for header in ("attention_tile.cuh", "hopper.cuh"):
        assert f'#include "{header}"' in shared
    (tmp_path / "a.cu").write_text("source")
    (tmp_path / "tile.cuh").write_text("one")
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    first = _kernels.library_path("a")
    assert _kernels.library_path("a") == first
    (tmp_path / "tile.cuh").write_text("two")
    assert _kernels.library_path("a") != first


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device="cpu")
    for call in (lambda: backend.resolve_device(),
                 lambda: transformer.init_params(0, cfg),
                 lambda: generate.init_kv_cache(cfg, 1, 8),
                 lambda: weights.params_from_jax(
                     weights.params_to_numpy(params), cfg),
                 lambda: serve.InferenceServer(params, cfg),
                 lambda: train.make_train_step(cfg),
                 lambda: train.init_opt_state(params),
                 lambda: weights.opt_state_from_jax({"step": np.int32(0)}),
                 lambda: trainer.Trainer(
                     cfg, trainer.TrainerConfig(str(tmp_path), 1)),
                 lambda: evaluation.evaluate(params, cfg, []),
                 lambda: evaluation.perplexity(params, cfg, np.zeros(600)),
                 lambda: data.TokenDataset(np.zeros(64, np.int32), 8, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.iterdir())  # the refused Trainer made nothing
    srv = serve.InferenceServer(params, cfg, device="cpu")
    assert srv.device == torch.device("cpu")
    backend.sync(srv.device)  # nothing to wait for on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        backend.resolve_device("meta")


def test_checkpoint_loader_imports_neither_transformers_nor_safetensors(
        tmp_path):
    """from_hf, from_hf_mamba, from_hf_mamba2, from_hf_bert and from_hf_vit
    read a checkpoint directory with the port's own readers: loading the
    golden checkpoints and one-layer checkpoints of the four families (in
    their HF layouts, written here) in a fresh interpreter leaves no
    transformers or safetensors module behind, and no module of the slice
    names them (or JAX) in its source."""
    from kfunca_tpu_torch.models import hf as thf

    dirs = {k: str(v) for k, v in _family_checkpoints(tmp_path).items()}
    code = "\n".join([
        "import sys",
        "from kfunca_tpu_torch.models import (api_server, encoder, hf,",
        "                                     hf_vision, mamba, mamba2,",
        "                                     speculative, tokenizer)",
        "for name in ('llama', 'gpt2'):",
        "    params, cfg = hf.from_hf(f'tests/fixtures/golden_{name}',",
        "                             dtype='float32', device='cpu')",
        f"dirs = {dirs!r}",
        "mamba.from_hf_mamba(dirs['mamba'], device='cpu')",
        "mamba2.from_hf_mamba2(dirs['mamba2'], device='cpu')",
        "encoder.from_hf_bert(dirs['bert'], device='cpu')",
        "hf_vision.from_hf_vit(dirs['vit'], device='cpu')",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('transformers', 'safetensors', 'jax', 'kfunca_tpu')))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert thf.is_checkpoint_path(tmp_path) and not thf.is_checkpoint_path(
        object())
    for name in ("hf", "tokenizer", "api_server", "speculative", "mamba",
                 "mamba2", "encoder", "hf_vision"):
        mods = set(_imports(PORT / "models" / f"{name}.py"))
        assert not {m for m in mods if m.split(".")[0] in (
            "transformers", "safetensors", "jax", "kfunca_tpu")}, name


def _write_checkpoint(path, config: dict, tensors: dict):
    """config.json and a model.safetensors of fp32 tensors, written with
    the file format's own layout (an 8-byte header length, a JSON header,
    the raw bytes)."""
    import json

    path.mkdir()
    (path / "config.json").write_text(json.dumps(config))
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr, np.float32)
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [off, off + arr.nbytes]}
        blobs.append(arr.tobytes())
        off += arr.nbytes
    head = json.dumps(header).encode()
    with open(path / "model.safetensors", "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))
    return path


def _family_checkpoints(tmp_path) -> dict:
    """One-layer checkpoints of the four families in their HF layouts."""
    rng = np.random.default_rng(0)

    def r(*shape):
        return rng.normal(0, 0.1, shape).astype(np.float32)

    d, v = 8, 16
    out = {}
    m = "backbone.layers.0.mixer."
    out["mamba"] = _write_checkpoint(
        tmp_path / "mamba",
        dict(model_type="mamba", vocab_size=v, hidden_size=d,
             num_hidden_layers=1, state_size=4, time_step_rank=2),
        {"backbone.embeddings.weight": r(v, d),
         "backbone.norm_f.weight": r(d),
         "backbone.layers.0.norm.weight": r(d),
         m + "in_proj.weight": r(32, d), m + "conv1d.weight": r(16, 1, 4),
         m + "conv1d.bias": r(16), m + "x_proj.weight": r(10, 16),
         m + "dt_proj.weight": r(16, 2), m + "dt_proj.bias": r(16),
         m + "A_log": r(16, 4), m + "D": r(16), m + "out_proj.weight": r(d, 16)})
    conv = 16 + 2 * 4  # d_inner + 2 * groups * state
    out["mamba2"] = _write_checkpoint(
        tmp_path / "mamba2",
        dict(model_type="mamba2", vocab_size=v, hidden_size=d,
             num_hidden_layers=1, num_heads=2, head_dim=8, state_size=4,
             n_groups=1, chunk_size=4),
        {"backbone.embeddings.weight": r(v, d),
         "backbone.norm_f.weight": r(d),
         "backbone.layers.0.norm.weight": r(d),
         m + "in_proj.weight": r(16 + conv + 2, d),
         m + "conv1d.weight": r(conv, 1, 4), m + "conv1d.bias": r(conv),
         m + "dt_bias": r(2), m + "A_log": r(2), m + "D": r(2),
         m + "norm.weight": r(16), m + "out_proj.weight": r(d, 16)})
    enc = {}
    for n in ("query", "key", "value"):
        enc[f"attention.self.{n}"] = (d, d)
    enc.update({"attention.output.dense": (d, d), "intermediate.dense": (16, d),
                "output.dense": (d, 16)})
    bert = {"embeddings.word_embeddings.weight": r(v, d),
            "embeddings.position_embeddings.weight": r(8, d),
            "embeddings.token_type_embeddings.weight": r(2, d),
            "embeddings.LayerNorm.weight": r(d),
            "embeddings.LayerNorm.bias": r(d)}
    for k, shape in enc.items():
        bert[f"encoder.layer.0.{k}.weight"] = r(*shape)
        bert[f"encoder.layer.0.{k}.bias"] = r(shape[0])
    for k in ("attention.output.LayerNorm", "output.LayerNorm"):
        bert[f"encoder.layer.0.{k}.weight"] = r(d)
        bert[f"encoder.layer.0.{k}.bias"] = r(d)
    out["bert"] = _write_checkpoint(
        tmp_path / "bert",
        dict(model_type="bert", vocab_size=v, hidden_size=d,
             num_hidden_layers=1, num_attention_heads=2,
             intermediate_size=16, max_position_embeddings=8), bert)
    vit = {"embeddings.patch_embeddings.projection.weight": r(d, 3, 4, 4),
           "embeddings.patch_embeddings.projection.bias": r(d),
           "embeddings.cls_token": r(1, 1, d),
           "embeddings.position_embeddings": r(1, 5, d),
           "layernorm.weight": r(d), "layernorm.bias": r(d)}
    for k, shape in enc.items():
        k = k.replace("attention.self", "attention.attention")
        vit[f"encoder.layer.0.{k}.weight"] = r(*shape)
        vit[f"encoder.layer.0.{k}.bias"] = r(shape[0])
    for k in ("layernorm_before", "layernorm_after"):
        vit[f"encoder.layer.0.{k}.weight"] = r(d)
        vit[f"encoder.layer.0.{k}.bias"] = r(d)
    out["vit"] = _write_checkpoint(
        tmp_path / "vit",
        dict(model_type="vit", hidden_size=d, num_hidden_layers=1,
             num_attention_heads=2, intermediate_size=16, image_size=8,
             patch_size=4), vit)
    return out


def test_from_hf_mamba_reads_a_directory_as_the_model(tmp_path):
    """The directory a MambaForCausalLM saves gives the params of the
    model instance itself."""
    transformers = pytest.importorskip("transformers")
    from kfunca_tpu_torch.models import mamba

    torch.manual_seed(0)
    model = transformers.MambaForCausalLM(transformers.MambaConfig(
        vocab_size=64, hidden_size=16, num_hidden_layers=2, state_size=4,
        expand=2, conv_kernel=4)).eval()
    model.save_pretrained(tmp_path)
    a, ca = mamba.from_hf_mamba(tmp_path, dtype="float32", device="cpu")
    b, cb = mamba.from_hf_mamba(model, dtype="float32", device="cpu")
    assert ca == cb
    assert a.keys() == b.keys() and len(a["layers"]) == 2
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_the_vision_family_slice_loads_no_jax():
    """models/mamba2.py, vision.py, encoder.py, hf_vision.py, clip.py and
    dit.py, imported alone in a fresh interpreter, load no jax, jaxlib or
    kfunca_tpu module (nor transformers), and name none in their source."""
    names = ("mamba2", "vision", "encoder", "hf_vision", "clip", "dit")
    code = ("import sys; "
            + "; ".join(f"import kfunca_tpu_torch.models.{n}" for n in names)
            + "; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'kfunca_tpu', "
            "'transformers')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for name in names:
        assert not [m for m in _imports(PORT / "models" / f"{name}.py")
                    if m and (_foreign(m) or m.startswith("transformers"))]


def test_vision_family_entry_points_refuse_the_cpu_unless_asked(
        monkeypatch, tmp_path):
    """The inits, the train steps, ddim_sample, the from_hf_* loaders and
    the converters take the card by default and raise without one; asked
    for the CPU each runs (generate where its params live)."""
    from kfunca_tpu_torch.models import (clip, dit, encoder, hf_vision,
                                         mamba2, vision)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dirs = _family_checkpoints(tmp_path)
    m2 = mamba2.Mamba2Config(vocab_size=32, d_model=8, n_layers=1,
                             n_heads=2, head_dim=8, d_state=4,
                             chunk_size=4, dtype="float32")
    vit = vision.ViTConfig(image_size=8, patch_size=4, d_model=8, n_heads=2,
                           n_layers=1, d_ff=16, dtype="float32")
    text = transformer.TransformerConfig(vocab_size=32, d_model=8, n_heads=2,
                                         n_layers=1, d_ff=16, max_seq_len=16,
                                         dtype="float32")
    mm = vision.MultimodalConfig(vit=vit, text=text)
    cc = clip.ClipConfig(vit=vit, text=text, embed_dim=4)
    enc = encoder.EncoderConfig(vocab_size=32, d_model=8, n_heads=2,
                                n_layers=1, d_ff=16, max_seq_len=8,
                                dtype="float32")
    bert = encoder.EncoderConfig(vocab_size=32, d_model=8, n_heads=2,
                                 n_layers=1, d_ff=16, max_seq_len=8,
                                 dtype="float32", arch="bert", type_vocab=2)
    dc = dit.DiTConfig(image_size=4, patch_size=2, channels=2, d_model=8,
                       n_heads=2, n_layers=1, d_ff=16, n_classes=3,
                       timesteps=10, dtype="float32")
    dp = dit.init_dit_params(0, dc, device="cpu")
    for call in (lambda: mamba2.init_mamba2_params(0, m2),
                 lambda: mamba2.init_mamba2_state(m2, 1),
                 lambda: mamba2.make_mamba2_train_step(m2),
                 lambda: mamba2.from_hf_mamba2(dirs["mamba2"]),
                 lambda: vision.init_vit_params(0, vit),
                 lambda: vision.init_multimodal_params(0, mm),
                 lambda: encoder.init_encoder_params(0, enc),
                 lambda: encoder.init_encoder_params(0, bert),
                 lambda: encoder.make_mlm_train_step(enc),
                 lambda: encoder.from_hf_bert(dirs["bert"]),
                 lambda: hf_vision.from_hf_vit(dirs["vit"]),
                 lambda: clip.init_clip_params(0, cc),
                 lambda: clip.make_clip_train_step(cc),
                 lambda: dit.init_dit_params(0, dc),
                 lambda: dit.make_dit_train_step(dc),
                 lambda: dit.alphas_bar(dc),
                 lambda: dit.ddim_sample(dp, torch.Generator(), [0], dc, 2),
                 lambda: weights.dit_params_from_jax(
                     weights.tree_to_numpy(dp), dc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    cpu = torch.Generator()
    tok = np.zeros((2, 8), np.int32)
    p = mamba2.init_mamba2_params(0, m2, device="cpu")
    mamba2.make_mamba2_train_step(m2, device="cpu")(
        p, train.init_opt_state(p, device="cpu"), tok, tok)
    assert mamba2.generate(p, torch.zeros((1, 3), dtype=torch.int64), m2,
                           2).shape == (1, 2)
    for cfg in (enc, bert):
        p = encoder.init_encoder_params(0, cfg, device="cpu")
        encoder.make_mlm_train_step(cfg, device="cpu")(
            p, train.init_opt_state(p, device="cpu"), cpu, tok)
    images = np.zeros((2, 8, 8, 3), np.float32)
    p = clip.init_clip_params(0, cc, device="cpu")
    _, _, m = clip.make_clip_train_step(cc, device="cpu")(
        p, train.init_opt_state(p, device="cpu"), images, tok)
    assert np.isfinite(float(m["loss"]))
    p = vision.init_multimodal_params(0, mm, device="cpu")
    assert vision.multimodal_forward(p, torch.from_numpy(images),
                                     torch.from_numpy(tok), mm).shape == (
        2, 8, 32)
    dit.make_dit_train_step(dc, device="cpu")(
        dp, train.init_opt_state(dp, device="cpu"), cpu,
        np.zeros((2, 4, 4, 2), np.float32), np.zeros(2, np.int64))
    assert dit.ddim_sample(dp, cpu, [0, 1], dc, 2, 2.0, device="cpu").shape \
        == (2, 4, 4, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator"):
        dit.ddim_sample(dp, cpu, [0], dc, 2, device="cuda:0")
    for load, name in ((mamba2.from_hf_mamba2, "mamba2"),
                       (encoder.from_hf_bert, "bert"),
                       (hf_vision.from_hf_vit, "vit")):
        params, _ = load(dirs[name], device="cpu")
        assert {t.device.type for t in tree_leaves(params)} == {"cpu"}


def _seq2seq_checkpoints(tmp_path) -> dict:
    """One-layer T5 (tied, relu) and Whisper checkpoints in their HF
    layouts, as save_pretrained leaves them (no tied copies)."""
    rng = np.random.default_rng(1)

    def r(*shape):
        return rng.normal(0, 0.1, shape).astype(np.float32)

    d, v, inner, f = 8, 16, 8, 16
    t5 = {"shared.weight": r(v, d), "encoder.final_layer_norm.weight": r(d),
          "decoder.final_layer_norm.weight": r(d)}
    for stack, subs in (("encoder", ("SelfAttention",)),
                        ("decoder", ("SelfAttention", "EncDecAttention"))):
        b = f"{stack}.block.0.layer"
        t5[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = r(32, 2)
        for i, sub in enumerate(subs):
            t5[f"{b}.{i}.layer_norm.weight"] = r(d)
            for n in ("q", "k", "v"):
                t5[f"{b}.{i}.{sub}.{n}.weight"] = r(inner, d)
            t5[f"{b}.{i}.{sub}.o.weight"] = r(d, inner)
        m = len(subs)
        t5[f"{b}.{m}.layer_norm.weight"] = r(d)
        t5[f"{b}.{m}.DenseReluDense.wi.weight"] = r(f, d)
        t5[f"{b}.{m}.DenseReluDense.wo.weight"] = r(d, f)
    wh = {"model.encoder.conv1.weight": r(d, 4, 3),
          "model.encoder.conv1.bias": r(d),
          "model.encoder.conv2.weight": r(d, d, 3),
          "model.encoder.conv2.bias": r(d),
          "model.encoder.embed_positions.weight": r(4, d),
          "model.decoder.embed_tokens.weight": r(v, d),
          "model.decoder.embed_positions.weight": r(8, d)}
    for stack, atts in (("encoder", ("self_attn",)),
                        ("decoder", ("self_attn", "encoder_attn"))):
        lp = f"model.{stack}.layers.0"
        for norm in ("final_layer_norm",) + tuple(
                f"{a}_layer_norm" for a in atts):
            wh[f"{lp}.{norm}.weight"], wh[f"{lp}.{norm}.bias"] = r(d), r(d)
        wh[f"model.{stack}.layer_norm.weight"] = r(d)
        wh[f"model.{stack}.layer_norm.bias"] = r(d)
        for a in atts:
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                wh[f"{lp}.{a}.{n}.weight"] = r(d, d)
                if n != "k_proj":
                    wh[f"{lp}.{a}.{n}.bias"] = r(d)
        wh[f"{lp}.fc1.weight"], wh[f"{lp}.fc1.bias"] = r(f, d), r(f)
        wh[f"{lp}.fc2.weight"], wh[f"{lp}.fc2.bias"] = r(d, f), r(d)
    return {
        "t5": _write_checkpoint(
            tmp_path / "t5", dict(model_type="t5", vocab_size=v, d_model=d,
                                  d_kv=4, d_ff=f, num_layers=1, num_heads=2),
            t5),
        "whisper": _write_checkpoint(
            tmp_path / "whisper",
            dict(model_type="whisper", vocab_size=v, num_mel_bins=4,
                 d_model=d, encoder_layers=1, encoder_attention_heads=2,
                 decoder_layers=1, decoder_attention_heads=2,
                 encoder_ffn_dim=f, decoder_ffn_dim=f,
                 max_source_positions=4, max_target_positions=8), wh),
    }


def test_the_seq2seq_slice_loads_no_jax_and_no_transformers(tmp_path):
    """models/t5.py, whisper.py and audio.py (with seq2seq.py, which the
    first two share), imported alone in a fresh interpreter whose
    transformers import is blocked, read T5 and Whisper
    directories (config.json over FAMILY_CONFIG_DEFAULTS: the decoder's
    layers default to the encoder's, the head is tied) and run; no jax,
    jaxlib, kfunca_tpu, transformers or safetensors module is loaded, and
    none is named in their source."""
    dirs = {k: str(v) for k, v in _seq2seq_checkpoints(tmp_path).items()}
    code = "\n".join([
        "import sys",
        "sys.modules['transformers'] = None  # any import of it raises",
        "import torch",
        "from kfunca_tpu_torch.models import audio, t5, whisper",
        f"dirs = {dirs!r}",
        "p, c = t5.from_hf_t5(dirs['t5'], dtype='float32', device='cpu')",
        "assert (c.n_dec_layers, c.tied_head, c.rel_buckets) == (1, True, 32)",
        "tok = torch.tensor([[3, 4, 5]])",
        "assert t5.t5_generate(p, tok, c, 3).shape == (1, 3)",
        "p, c = whisper.from_hf_whisper(dirs['whisper'], dtype='float32',",
        "                               device='cpu')",
        "assert (c.n_mels, c.d_ff, c.eos_id) == (4, 16, 50256)",
        "f = torch.zeros((1, 4, 8))",
        "assert whisper.whisper_forward(p, f, tok, c).shape == (1, 3, 16)",
        "assert audio.log_mel_spectrogram(torch.zeros(800)).shape == "
        "(1, 80, 5)",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('transformers', 'safetensors', 'jax', 'jaxlib',",
        "              'kfunca_tpu') and sys.modules[m] is not None))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for name in ("t5", "whisper", "audio", "seq2seq"):
        assert not [m for m in _imports(PORT / "models" / f"{name}.py")
                    if m and (_foreign(m) or m.startswith(
                        ("transformers", "safetensors")))]


def test_seq2seq_entry_points_refuse_the_cpu_unless_asked(monkeypatch,
                                                          tmp_path):
    """The inits, train steps, from_hf_* loaders, converters and the audio
    frontend (of an array) take the card by default and raise without one;
    asked for the CPU each runs."""
    from kfunca_tpu_torch.models import audio, t5, whisper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dirs = _seq2seq_checkpoints(tmp_path)
    tc = t5.T5Config(vocab_size=16, d_model=8, n_heads=2, d_kv=4, d_ff=16,
                     n_enc_layers=1, n_dec_layers=1, dtype="float32")
    wc = whisper.WhisperConfig(vocab_size=16, n_mels=4, d_model=8, n_heads=2,
                               n_enc_layers=1, n_dec_layers=1, d_ff=16,
                               max_source_positions=4,
                               max_target_positions=8, dtype="float32")
    tp = t5.init_t5_params(0, tc, device="cpu")
    wp = whisper.init_whisper_params(0, wc, device="cpu")
    for call in (lambda: t5.init_t5_params(0, tc),
                 lambda: t5.make_t5_train_step(tc),
                 lambda: t5.from_hf_t5(dirs["t5"]),
                 lambda: weights.t5_params_from_jax(
                     weights.tree_to_numpy(tp), tc),
                 lambda: whisper.init_whisper_params(0, wc),
                 lambda: whisper.make_whisper_train_step(wc),
                 lambda: whisper.sinusoidal_positions(4, 8),
                 lambda: whisper.from_hf_whisper(dirs["whisper"]),
                 lambda: weights.whisper_params_from_jax(
                     weights.tree_to_numpy(wp), wc),
                 lambda: audio.log_mel_spectrogram(np.zeros(800, np.float32)),
                 lambda: audio.whisper_features(np.zeros(800, np.float32),
                                                wc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    tok = np.array([[3, 4, 5, 6]], np.int32)
    _, _, loss = t5.make_t5_train_step(tc, device="cpu")(
        tp, train.init_opt_state(tp, device="cpu"), tok, tok)
    assert np.isfinite(float(loss))
    _, _, loss = whisper.make_whisper_train_step(wc, device="cpu")(
        wp, train.init_opt_state(wp, device="cpu"),
        np.zeros((1, 4, 8), np.float32), tok)
    assert np.isfinite(float(loss))
    for load, name in ((t5.from_hf_t5, "t5"),
                       (whisper.from_hf_whisper, "whisper")):
        params, _ = load(dirs[name], device="cpu")
        assert {t.device.type for t in tree_leaves(params)} == {"cpu"}
    assert audio.log_mel_spectrogram(np.zeros(800, np.float32),
                                     device="cpu").device.type == "cpu"
    tp["embed"] = tp["embed"].to("meta")
    with pytest.raises(ValueError, match="params are on"):
        t5.make_t5_train_step(tc, device="cpu")(
            tp, train.init_opt_state(wp, device="cpu"), tok, tok)


def test_slice_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """from_hf and params_from_hf load onto the card by default and raise
    without one; the HF reader itself needs no device."""
    from kfunca_tpu_torch.models import hf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    golden = ROOT / "tests" / "fixtures" / "golden_llama"
    sd = hf.read_checkpoint(golden)
    cfg = hf.config_from_hf(hf.with_config_defaults(
        __import__("json").loads((golden / "config.json").read_text())))
    for call in (lambda: hf.from_hf(golden),
                 lambda: hf.params_from_hf(sd, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params, _ = hf.from_hf(golden, dtype="float32", device="cpu")
    assert params["embed"].device.type == "cpu"


def test_mla_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """MLAServer and the latent cache lie on the card by default and raise
    without one; on the CPU, when asked, the server serves, and it refuses
    params on another device."""
    from kfunca_tpu_torch.models import mla, mla_serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.TransformerConfig(**dict(
        SMALL, n_kv_heads=None, attention="mla", kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=16, n_experts=4))
    params = transformer.init_params(0, cfg, device="cpu")
    for call in (lambda: mla_serve.MLAServer(params, cfg),
                 lambda: mla.init_mla_cache(cfg, 1, 8),
                 lambda: generate.init_kv_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    srv = mla_serve.MLAServer(params, cfg, max_seq_len=16, device="cpu")
    srv.submit([1, 2, 3], max_new=2)
    assert len(srv.run()[0]) == 2
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params are on"):
        mla_serve.MLAServer(params, cfg, device="cpu")


def test_the_mesh_rank_helpers_load_no_jax():
    """tests/torch_mesh_ranks.py and torch_ring_ranks.py run in spawned
    children that must not need JAX: imported alone they load none."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import torch_mesh_ranks, torch_ring_ranks; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'kfunca_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_mesh_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """A LocalMesh lies on the card by default and raises without one; a
    mesh on the CPU, when asked, serves and trains, and a step refuses
    params on another device."""
    from kfunca_tpu_torch.parallel import mesh as meshlib
    from kfunca_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: meshlib.LocalMesh(1, 2),
                 lambda: meshlib.make_mesh(dp=1, tp=2),
                 lambda: multihost.make_multihost_mesh(dp=2, tp=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device="cpu")
    mesh = meshlib.LocalMesh(1, 2, "cpu")
    srv = serve.InferenceServer(params, cfg, mesh=mesh)  # the mesh's device
    assert srv.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.InferenceServer(params, cfg, mesh=mesh, device="cuda")
    sp = meshlib.shard_params(params, mesh, cfg=cfg)
    step = train.make_sharded_train_step(cfg, mesh)
    tokens = np.zeros((1, 8), np.int32)
    opt = train.init_opt_state(sp)
    step(sp, opt, tokens, tokens)
    sp.local[1]["embed"] = sp.local[1]["embed"].to("meta")
    with pytest.raises(ValueError, match="params are on"):
        step(sp, opt, tokens, tokens)


def test_server_checks_params_device():
    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device="cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params are on"):
        serve.InferenceServer(params, cfg, device="cpu")


def test_training_entry_points_check_params_device():
    """A step made for one device refuses params that live on another, as
    the server does."""
    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device="cpu")
    step = train.make_train_step(cfg, device="cpu")
    opt = train.init_opt_state(params, device="cpu")
    tokens = np.zeros((1, 8), np.int32)
    step(params, opt, tokens, tokens)  # the CPU, when asked, runs
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params are on"):
        step(params, opt, tokens, tokens)
    with pytest.raises(ValueError, match="params are on"):
        train.init_opt_state(params, device="cpu")
    with pytest.raises(ValueError, match="params are on"):
        evaluation.evaluate(params, cfg, [(tokens, tokens)], device="cpu")


def test_main_path_never_calls_the_library_attention():
    """scaled_dot_product_attention is chip_smoke.py's yardstick only."""
    hits = [str(f.relative_to(ROOT)) for f in sorted(PORT.rglob("*.py"))
            if "scaled_dot_product_attention" in f.read_text()]
    assert hits == []
    assert "scaled_dot_product_attention" in (ROOT / "chip_smoke.py").read_text()


def test_main_path_never_calls_the_library_int8_matmul():
    """`torch._int_mm` is chip_smoke.py's yardstick only, and no environment
    knob takes the int8 product off the port's own kernel: the eager GEMM's
    KFUNCA_GEMM_ENGINE is read in ops/gemm.py alone, which takes floating
    types only, and ops/quant.py reads no knob."""
    hits = [str(f.relative_to(ROOT)) for f in sorted(PORT.rglob("*.py"))
            if "_int_mm" in f.read_text()]
    assert hits == []
    assert "_int_mm" in (ROOT / "chip_smoke.py").read_text()
    readers = [str(f.relative_to(PORT)) for f in sorted(PORT.rglob("*.py"))
               if 'environ.get("KFUNCA_GEMM_ENGINE"' in f.read_text()]
    assert readers == ["ops/gemm.py"]
    assert "os.environ" not in (PORT / "ops" / "quant.py").read_text()
    import kfunca_tpu_torch as kfunca

    a = kfunca.from_numpy(np.ones((2, 2), np.int8), "cpu")
    with pytest.raises(RuntimeError, match="floating dtypes only"):
        kfunca.gemm(a, a)


def test_quantized_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device="cpu")
    tree = {"embed": np.zeros((2, 2), np.float32),
            "blocks": [{"wo": (np.zeros((2, 2), np.int8),
                               np.ones((2,), np.float32))}]}
    for call in (lambda: serve.InferenceServer(params, cfg, quantize_kv=True,
                                               quantize_weights=True),
                 lambda: weights.decode_params_from_jax(tree)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    got = weights.decode_params_from_jax(tree, device="cpu")
    assert isinstance(got["blocks"][0]["wo"], tuple)
    assert got["blocks"][0]["wo"][0].dtype == torch.int8
    # generate and beam_search run where their prompt and params live
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    assert generate.generate(params, prompt, cfg, 2).shape == (1, 2)
    assert generate.beam_search(params, prompt, cfg, 2, beam=2)[0].shape == (
        1, 2, 2)


def test_chip_smoke_fails_without_a_card():
    """With every card hidden, the script exits non-zero and prints no
    result line (on a machine with a card too)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_away_from_the_repo(tmp_path):
    """Copied into a directory of its own, the script fails for want of
    the port's package even where torch reports a card (faked here by a
    sitecustomize module on PYTHONPATH), and prints no result line."""
    alone, fake = tmp_path / "alone", tmp_path / "fake"
    alone.mkdir()
    fake.mkdir()
    (alone / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    (fake / "sitecustomize.py").write_text(
        "import torch\ntorch.cuda.is_available = lambda: True\n")
    env = {**os.environ, "PYTHONPATH": str(fake)}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "kfunca_tpu_torch" in out.stderr


def test_mamba_family_refuses_the_cpu_unless_asked(monkeypatch):
    """The Mamba and hybrid entry points take the card by default and raise
    without one; asked for the CPU they run the plain path, and the server
    and generate run where their params live."""
    from kfunca_tpu_torch.models import hybrid, mamba, mamba_serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc = mamba.MambaConfig(vocab_size=64, d_model=16, n_layers=1, d_state=4,
                           dtype="float32")
    hc = hybrid.HybridConfig(vocab_size=64, d_model=16, n_layers=2, d_ff=32,
                             n_heads=2, d_state=4, attn_every=2,
                             attn_offset=1, dtype="float32")
    mp = mamba.init_mamba_params(0, mc, device="cpu")
    hp = hybrid.init_hybrid_params(0, hc, device="cpu")
    for call in (lambda: mamba.init_mamba_params(0, mc),
                 lambda: mamba.init_mamba_state(mc, 1),
                 lambda: mamba.make_mamba_train_step(mc),
                 lambda: mamba.params_from_hf_mamba(
                     mamba.to_hf_mamba(mp, mc), mc),
                 lambda: weights.mamba_params_from_jax(
                     weights.tree_to_numpy(mp), mc),
                 lambda: hybrid.init_hybrid_params(0, hc),
                 lambda: hybrid.init_hybrid_state(hc, 1, 8),
                 lambda: hybrid.make_hybrid_train_step(hc),
                 lambda: weights.hybrid_params_from_jax(
                     weights.tree_to_numpy(hp), hc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    tokens = np.zeros((1, 8), np.int32)
    opt = train.init_opt_state(mp, device="cpu")
    mamba.make_mamba_train_step(mc, device="cpu")(mp, opt, tokens, tokens)
    prompt = torch.zeros((1, 3), dtype=torch.int64)
    assert mamba.generate(mp, prompt, mc, 2).shape == (1, 2)
    assert hybrid.generate(hp, prompt, hc, 2).shape == (1, 2)
    srv = mamba_serve.MambaServer(mp, mc, batch_slots=1)
    assert srv.device == torch.device("cpu")
    rid = srv.submit([1, 2], max_new=2)
    assert len(srv.run()[rid]) == 2
    mp["embed"] = mp["embed"].to("meta")
    with pytest.raises(ValueError, match="params are on"):
        mamba_serve.MambaServer(mp, mc)


def test_eager_api_refuses_the_cpu_unless_asked(monkeypatch):
    """`import kfunca_tpu_torch as kfunca`: every factory and benchmark
    takes the card by default (CUDA index 0) and raises without one; with
    "cpu" the same calls run the plain PyTorch path."""
    import kfunca_tpu_torch as kfunca

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = np.ones((2, 3), np.float32)
    for call in (lambda: kfunca.from_numpy(arr),
                 lambda: kfunca.from_numpy(arr, 0),
                 lambda: kfunca.empty((2, 3), kfunca.float),
                 lambda: kfunca.zeros([4], kfunca.int),
                 lambda: kfunca.empty_strided((2, 2), (1, 2), kfunca.half),
                 lambda: kfunca.from_torch(torch.ones(3)),
                 lambda: kfunca.from_torch(torch.ones(3), 0),
                 lambda: kfunca.from_storage_numpy(arr, (3,), (1,), 0),
                 lambda: kfunca.device_info(run_benchmarks=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    t = kfunca.from_numpy(arr, "cpu")
    assert t.device() == "cpu" and t.torch_device() == torch.device("cpu")
    assert (t + t).numpy().tolist() == (arr + arr).tolist()
    assert kfunca.empty_like(t).device() == "cpu"
    assert kfunca.from_torch(torch.ones(3), "cpu").device() == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        kfunca.from_numpy(arr, "meta")


def test_eager_surface_is_the_reference_surface_less_autotune():
    """The port's __all__ is kfunca_tpu/__init__.py's, `autotune` included
    now that runtime/autotune.py is ported (read from the source: this test
    imports no JAX)."""
    import kfunca_tpu_torch as kfunca

    tree = ast.parse((ROOT / "kfunca_tpu" / "__init__.py").read_text())
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and getattr(node.targets[0], "id", "") == "__all__")
    assert sorted(kfunca.__all__) == sorted(ref)
    for name in kfunca.__all__:
        assert hasattr(kfunca, name), name
    from kfunca_tpu_torch.runtime.autotune import autotune

    assert kfunca.autotune is autotune


def test_the_pipeline_slice_loads_no_jax():
    """parallel/pipeline.py, parallel/zero_bubble.py, models/moe.py,
    models/pipeline_lm.py and the spawned rank helper
    tests/torch_pipeline_ranks.py, imported alone in a fresh interpreter,
    load no jax, jaxlib or kfunca_tpu module."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import kfunca_tpu_torch.parallel.pipeline, "
            "kfunca_tpu_torch.parallel.zero_bubble, "
            "kfunca_tpu_torch.models.moe, "
            "kfunca_tpu_torch.models.pipeline_lm, "
            "torch_pipeline_ranks; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'kfunca_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for path in ("parallel/pipeline.py", "parallel/zero_bubble.py",
                 "models/moe.py", "models/pipeline_lm.py"):
        assert not [m for m in _imports(PORT / path) if m and _foreign(m)]


def test_pipeline_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """The pipeline, zero-bubble, expert-parallel, pipeline_lm and
    tensor-parallel Mamba entry points run where their mesh lies, and a
    mesh lies on the card unless the CPU is asked for: without a card the
    defaults raise; asked for the CPU, each runs."""
    from kfunca_tpu_torch.models import mamba, moe, pipeline_lm
    from kfunca_tpu_torch.parallel import mesh as meshlib
    from kfunca_tpu_torch.parallel import pipeline, zero_bubble

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc = mamba.MambaConfig(vocab_size=64, d_model=16, n_layers=1, d_state=4,
                           dtype="float32")
    pc = pipeline_lm.PipelineMoEConfig(vocab_size=32, d_model=16,
                                       n_layers=2, d_ff=16, dtype="float32")
    ec = moe.MoEConfig(n_experts=4, d_model=8, d_ff=8)
    cpu = {k: meshlib.LocalMesh(axes=v, device="cpu") for k, v in (
        ("pp", {"pp": 2}), ("ep", {"ep": 2}),
        ("plm", {"dp": 1, "pp": 2, "tp": 1}))}
    for call in (lambda: meshlib.LocalMesh(axes={"pp": 2}),
                 lambda: meshlib.LocalMesh(axes={"ep": 4}),
                 lambda: moe.init_moe_params(0, ec),
                 lambda: pipeline_lm.init_params(0, pc),
                 lambda: pipeline_lm.make_train_step(pc, cpu["plm"],
                                                     device="cuda"),
                 lambda: mamba.make_sharded_mamba_train_step(
                     mc, meshlib.LocalMesh(1, 2, "cpu"), device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, each entry point runs
    layers = [{"w": torch.eye(4)} for _ in range(4)]
    sp = pipeline.stage_shards(pipeline.stack_stages(layers[:2], 2),
                               cpu["pp"])
    x = torch.ones((2, 1, 4))
    ys = pipeline.make_pipelined_forward(lambda p, h: h @ p["w"],
                                         cpu["pp"])(sp, x)
    assert torch.equal(ys[0], x)
    for make, st in ((zero_bubble.make_zb_train_step, sp),
                     (zero_bubble.make_zbv_train_step, pipeline.stage_shards(
                         zero_bubble.stack_stages_v(layers, 2), cpu["pp"]))):
        stage = (lambda p, h: h @ p["w"][0]) if st is sp else (
            lambda p, h: h @ p["w"])
        loss, grads = make(stage, lambda y, i: y.sum(), cpu["pp"],
                           n_micro=2)(st, x)
        assert float(loss) == 8.0 and grads[0]["w"].device.type == "cpu"
    ep = moe.shard_moe_params(moe.init_moe_params(0, ec, device="cpu"),
                              cpu["ep"])
    outs, _ = moe.make_moe_ffn_ep(cpu["ep"], ec)(torch.ones((2, 3, 8)), ep)
    assert outs[0].shape == (1, 3, 8)
    plm = pipeline_lm.shard_params(pipeline_lm.init_params(0, pc,
                                                           device="cpu"),
                                   cpu["plm"], pc)
    tokens = np.zeros((2, 4), np.int32)
    _, loss = pipeline_lm.make_train_step(pc, cpu["plm"])(plm, tokens, tokens)
    assert np.isfinite(float(loss))
    mp = mamba.shard_mamba_params(mamba.init_mamba_params(0, mc,
                                                          device="cpu"),
                                  meshlib.LocalMesh(1, 2, "cpu"))
    step = mamba.make_sharded_mamba_train_step(mc, mp.mesh)
    step(mp, train.init_opt_state(mp), tokens, tokens)


def test_the_finetuning_slice_loads_no_jax():
    """models/lora.py, dpo.py, rlhf.py and distill.py, imported alone in a
    fresh interpreter, load no jax, jaxlib or kfunca_tpu module, and name
    none in their source."""
    code = ("import sys; "
            "import kfunca_tpu_torch.models.lora, "
            "kfunca_tpu_torch.models.dpo, kfunca_tpu_torch.models.rlhf, "
            "kfunca_tpu_torch.models.distill; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'kfunca_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for name in ("lora", "dpo", "rlhf", "distill"):
        assert not [m for m in _imports(PORT / "models" / f"{name}.py")
                    if m and _foreign(m)]


def test_finetuning_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """The LoRA, DPO, GRPO and distillation steps and a multi-LoRA server
    run on the card by default: without one they raise; asked for the
    CPU, each takes a step."""
    from kfunca_tpu_torch.models import distill, dpo, lora, rlhf, serve
    from kfunca_tpu_torch.models import transformer as tf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tf.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                               n_layers=1, d_ff=16, max_seq_len=8,
                               dtype="float32")
    params = tf.init_params(0, cfg, device="cpu")
    for call in (lambda: lora.make_lora_train_step(params, cfg),
                 lambda: dpo.make_dpo_step(params, cfg),
                 lambda: dpo.make_lora_dpo_step(params, cfg),
                 lambda: rlhf.make_grpo_step(cfg),
                 lambda: distill.make_distill_step(params, cfg, cfg),
                 lambda: serve.InferenceServer(params, cfg, max_loras=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    ad = lora.init_lora(torch.Generator().manual_seed(0), cfg, rank=2)
    tokens = np.zeros((1, 4), np.int32)
    step = lora.make_lora_train_step(params, cfg, device="cpu")
    ad, _, loss = step(ad, train.init_opt_state(ad["blocks"], device="cpu"),
                       tokens, tokens)
    assert np.isfinite(float(loss))
    srv = serve.InferenceServer(params, cfg, max_loras=1, lora_rank=2,
                                device="cpu", batch_slots=1, n_pages=4)
    lid = srv.register_lora(lora.to_serving(ad))
    rid = srv.submit([1, 2], max_new=2, lora_id=lid)
    assert len(srv.run()[rid]) == 2
    steps = (dpo.make_lora_dpo_step(params, cfg, device="cpu"),
             distill.make_distill_step(params, cfg, cfg, device="cpu"))
    opt = train.init_opt_state(ad["blocks"], device="cpu")
    _, _, m = steps[0](ad, opt, tokens, tokens, tokens, tokens)
    assert np.isfinite(float(m["loss"]))
    student = tf.init_params(1, cfg, device="cpu")
    _, _, m = steps[1](student, train.init_opt_state(student, device="cpu"),
                       tokens, tokens)
    assert np.isfinite(float(m["loss"]))


EXAMPLES = PORT / "examples"
_EXAMPLE_NAMES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))


def test_every_jax_example_has_its_port():
    """kfunca_tpu_torch/examples/ holds one module for each script of
    examples/, under the same name, each with main(argv) and run(args)."""
    from kfunca_tpu_torch import examples

    assert len(_EXAMPLE_NAMES) == 14
    assert sorted(examples.NAMES) == _EXAMPLE_NAMES
    for name in _EXAMPLE_NAMES:
        source = (EXAMPLES / f"{name}.py").read_text()
        assert "def main(argv=None)" in source and "def run(args" in source
        assert 'if __name__ == "__main__":' in source


@pytest.mark.parametrize("name", _EXAMPLE_NAMES)
def test_example_names_no_jax_package_and_no_transformers(name):
    """An example imports torch, numpy and the port only: not jax, not the
    JAX package, not transformers or safetensors, and not the JAX
    example's own module (importing it imports jax)."""
    bad = [m for m in _imports(EXAMPLES / f"{name}.py")
           if m and (_foreign(m) or m.split(".")[0] in (
               "transformers", "safetensors", "examples"))]
    assert bad == []


def test_the_examples_load_no_jax_and_no_transformers(tmp_path):
    """Every example, imported in a fresh interpreter whose transformers
    import is blocked, leaves no jax, jaxlib, kfunca_tpu, transformers or
    safetensors module loaded; the hermetic checkpoints of serve_hf and
    serve_deepseek are written and read there too."""
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['transformers'] = None  # any import of it raises",
        "from kfunca_tpu_torch import examples",
        "for name in examples.NAMES:",
        "    importlib.import_module('kfunca_tpu_torch.examples.' + name)",
        "from kfunca_tpu_torch.examples import serve_deepseek, serve_hf",
        "from kfunca_tpu_torch.models.hf import from_hf",
        f"serve_hf.write_tiny_llama({str(tmp_path / 'llama')!r})",
        f"serve_deepseek.write_tiny_deepseek({str(tmp_path / 'ds')!r})",
        f"p, c = from_hf({str(tmp_path / 'llama')!r}, device='cpu')",
        "assert (c.n_layers, c.kv_heads, 'lm_head' in p) == (4, 2, True)",
        f"p, c = from_hf({str(tmp_path / 'ds')!r}, device='cpu')",
        "assert (c.attention, c.n_experts, c.moe_first_dense) == "
        "('mla', 8, 1)",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('transformers', 'safetensors', 'jax', 'jaxlib',",
        "              'kfunca_tpu') and sys.modules[m] is not None))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", _EXAMPLE_NAMES)
def test_example_refuses_the_cpu_unless_asked(monkeypatch, name, tmp_path):
    """Run with no flags, every example takes the card and raises without
    one, before it writes or trains anything."""
    import importlib

    mod = importlib.import_module(f"kfunca_tpu_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # tempfile caches its directory: set the cache, not only TMPDIR, so
    # that train_lm's default --ckpt and every mkdtemp land in tmp_path
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert tempfile.gettempdir() == str(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    assert not list(tmp_path.iterdir())
