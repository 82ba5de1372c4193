"""The port stands alone: kfunca_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and the port's entry points refuse to run on the
CPU unless the caller asks for it."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import numpy as np

from kfunca_tpu_torch.models import (
    data, eval as evaluation, generate, serve, train, trainer, transformer,
    weights)
from kfunca_tpu_torch.runtime import backend

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
        "             'utils.device_info', 'utils.profiling'):",
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
    """The port's __all__ is kfunca_tpu/__init__.py's, less `autotune`
    (read from the source: this test imports no JAX)."""
    import kfunca_tpu_torch as kfunca

    tree = ast.parse((ROOT / "kfunca_tpu" / "__init__.py").read_text())
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and getattr(node.targets[0], "id", "") == "__all__")
    assert sorted(kfunca.__all__) == sorted(n for n in ref if n != "autotune")
    for name in kfunca.__all__:
        assert hasattr(kfunca, name), name
    assert not hasattr(kfunca, "autotune")
