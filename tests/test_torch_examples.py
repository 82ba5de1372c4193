"""Port parity: the runnable examples #1-#9 (kfunca_tpu_torch/examples/:
serve_lm, train_lm, speculative_lm, serve_hf, serve_api, finetune_e2e,
align_lora_dpo, rl_grpo, serve_deepseek) against the JAX package's
examples/ and modules on the CPU, at sizes well under the defaults.

  * Data: the corpora are the JAX examples' strings, the batches the JAX
    TokenDataset's arrays, bit for bit.
  * Stages: the JAX init exported through models/weights.py starts each
    training example's run(args, ...); its losses over 2-3 steps equal the
    jitted JAX steps' on the same batches within the step tolerance of the
    port's training step (1e-5 x max(1, |loss|)), and its fp32 greedy
    tokens equal the JAX package's.  GRPO's rollouts are the port's draws:
    the JAX step replays them.
  * Whole runs: serve_lm, speculative_lm, serve_hf (hermetic, w8kv8, bf16,
    tp = 2), serve_api (one HTTP request on port 0) and serve_deepseek run
    through main([..., "--device", "cpu"]) and pass their own checks.
  * The hermetic checkpoints of serve_hf and serve_deepseek are read back
    by the JAX package's from_hf in tests/test_torch_examples_hf.py (the
    one file here that pays the transformers import).
"""

import dataclasses
import functools
import importlib
import importlib.util
import json
import tempfile
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import data as jdata
from kfunca_tpu.models import dpo as jdpo
from kfunca_tpu.models import generate as jgen
from kfunca_tpu.models import lora as jlora
from kfunca_tpu.models import rlhf as jrlhf
from kfunca_tpu.models import train as jtrain
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.examples import (align_lora_dpo, finetune_e2e, rl_grpo,
                                       serve_api, serve_deepseek, serve_hf,
                                       serve_lm, speculative_lm, train_lm)
from kfunca_tpu_torch.models import hf as thf
from kfunca_tpu_torch.models.weights import lora_from_jax, params_from_jax
from torch_parity import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
LOSS_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def jax_example(name):
    """The JAX example's module, loaded by path (for its data helpers)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_config(cfg):
    return jtf.TransformerConfig(**dataclasses.asdict(cfg))


def jax_init(cfg, seed=0):
    jcfg = jax_config(cfg)
    jp = jax.jit(jtf.init_params, static_argnums=1)(jax.random.PRNGKey(seed),
                                                     jcfg)
    return jcfg, jax.tree_util.tree_map(np.asarray, jp)


def losses_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_TOL * max(1.0, abs(w)), (got, want)


def greedy(jp, jcfg, prompt, n):
    return np.asarray(jgen.generate(jp, jnp.asarray(prompt, jnp.int32), jcfg,
                                    max_new=n))[0].tolist()


# -- data -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["finetune_e2e", "serve_api"])
def test_corpus_is_the_jax_examples(name):
    port = {"finetune_e2e": finetune_e2e, "serve_api": serve_api}[name]
    assert port.CORPUS == jax_example(name).CORPUS


def test_train_lm_batches_are_the_jax_datasets():
    base = train_lm.corpus(512)
    port = train_lm.TokenDataset(base.astype(np.int32), 32, 4, seed=1,
                                 device="cpu")
    ref = jdata.TokenDataset(base.astype(np.int32), 32, 4, seed=1)
    for _ in range(3):
        for a, b in zip(port.sample_batch(), ref.sample_batch()):
            np.testing.assert_array_equal(a, b)


def test_serve_prompts_are_the_jax_examples_draws():
    """serve_hf's prompts come from the JAX example's numpy stream."""
    rng = np.random.default_rng(0)
    want = [rng.integers(1, 512, (int(rng.integers(4, 12)),)).tolist()
            for _ in range(6)]
    cfg = thf.config_from_hf(serve_hf.TINY_LLAMA)
    assert serve_hf.prompts(cfg, 6) == want


# -- stages: losses and greedy tokens against the JAX modules ----------------


def test_train_lm_stages_match_jax(tmp_path):
    args = train_lm.parse(["--steps", "3", "--batch", "2", "--seq", "32",
                           "--d-model", "64", "--layers", "2", "--ckpt",
                           str(tmp_path / "lm.npz"), "--device", "cpu"])
    cfg = train_lm.config(args, CPU)
    assert cfg.dtype == "float32"
    jcfg, jp = jax_init(cfg)
    out = train_lm.run(args, params=params_from_jax(jp, cfg, device="cpu"))
    base = train_lm.corpus(cfg.vocab_size)
    ds = jdata.TokenDataset(base.astype(np.int32), 32, 2, seed=1)
    step = jax.jit(jtrain.make_train_step(jcfg, loss_chunk=256))
    opt, losses = jtrain.init_opt_state(jp), []
    for _ in range(3):
        jp, opt, loss = step(jp, opt, *ds.sample_batch())
        losses.append(float(loss))
    losses_close(out["losses"], losses)
    assert out["greedy"] == greedy(jp, jcfg, base[None, :8], 16)
    assert (tmp_path / "lm.npz").exists()


@functools.lru_cache(maxsize=None)
def _finetune_reference(algo, steps, batch, seq):
    """The JAX steps' losses over the same batches, and (adamw) the greedy
    tokens of the EMA params."""
    args = finetune_e2e.parse(["--algo", algo, "--steps", str(steps),
                               "--batch", str(batch), "--seq-len", str(seq),
                               "--device", "cpu"])
    tok = finetune_e2e.BPETokenizer.train(finetune_e2e.CORPUS, 384)
    ids = tok.encode(finetune_e2e.CORPUS)
    cfg = finetune_e2e.config(args, tok.vocab_size, CPU)
    jcfg, jp = jax_init(cfg)
    oc = jtrain.OptConfig(**dataclasses.asdict(finetune_e2e.opt_config(args)))
    step = jax.jit(jtrain.make_train_step(jcfg, oc, grad_accum=2))
    opt = jtrain.init_opt_state(jp, oc)
    it = iter(jdata.TokenDataset(np.asarray(ids), seq_len=seq,
                                 batch_size=batch, seed=0))
    losses = []
    for _ in range(steps):
        jp, opt, loss = step(jp, opt, *next(it))
        losses.append(float(loss))
    prompt = tok.encode("the little ship ")
    tokens = greedy(jtrain.ema_params(opt, dtype=jnp.float32), jcfg,
                    prompt[None], 24) if algo == "adamw" else None
    return args, cfg, jax_init(cfg)[1], losses, tokens


@pytest.mark.parametrize("algo", ["adamw", "sgd", "lion", "adafactor",
                                  "muon"])
def test_finetune_e2e_stages_match_jax(algo):
    args, cfg, jp0, losses, tokens = _finetune_reference(algo, 3, 4, 16)
    out = finetune_e2e.run(args, params=params_from_jax(jp0, cfg,
                                                        device="cpu"))
    losses_close(out["losses"], losses)
    assert all(out["done"])
    if tokens is not None:  # the served greedy request, EMA params
        assert out["greedy"] == tokens


def test_align_lora_dpo_stages_match_jax():
    args = align_lora_dpo.parse(["--sft-steps", "3", "--dpo-steps", "2",
                                 "--rank", "4", "--device", "cpu"])
    cfg = align_lora_dpo.CFG
    jcfg, jp = jax_init(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)  # closed over by the steps
    ad = jax.tree_util.tree_map(np.asarray, jlora.init_lora(
        jax.random.PRNGKey(1), jcfg, rank=4, targets=("wqkv",)))
    out = align_lora_dpo.run(args, base=params_from_jax(jp, cfg,
                                                        device="cpu"),
                             adapters=lora_from_jax(ad, device="cpu"))
    prompt, *pairs = align_lora_dpo.toy_data(cfg)
    (tok_c, tgt_c), (tok_r, tgt_r) = [tuple(map(jnp.asarray, p))
                                      for p in pairs]
    sft = jax.jit(jlora.make_lora_train_step(
        jp, jcfg, jtrain.OptConfig(lr=3e-2, weight_decay=0.0),
        ignore_index=-100))
    opt, losses = jtrain.init_opt_state(ad["blocks"]), []
    for _ in range(3):
        ad, opt, loss = sft(ad, opt, tok_c, tgt_c)
        losses.append(float(loss))
    losses_close(out["sft_losses"], losses)
    dpo = jax.jit(jdpo.make_lora_dpo_step(
        jp, jcfg, jtrain.OptConfig(lr=1e-2, weight_decay=0.0), beta=0.25,
        vocab_chunk=64))
    opt, metrics = jtrain.init_opt_state(ad["blocks"]), []
    for _ in range(2):
        ad, opt, m = dpo(ad, opt, tok_c, tgt_c, tok_r, tgt_r)
        metrics.append(m)
    losses_close([m["loss"] for m in out["dpo"]],
                 [float(m["loss"]) for m in metrics])
    losses_close([m["reward_margin"] for m in out["dpo"]],
                 [float(m["reward_margin"]) for m in metrics])
    assert out["base_tokens"] == greedy(jp, jcfg, prompt[:1], 6)
    assert out["tuned_tokens"] == greedy(jlora.merge_lora(jp, ad), jcfg,
                                         prompt[:1], 6)


def test_rl_grpo_steps_match_jax_on_the_ports_rollouts():
    """Each round's rollout (the port's draws) replayed through the JAX
    reference log-probs and the JAX GRPO step from the same init."""
    args = rl_grpo.parse(["--rounds", "2", "--group", "4", "--max-new", "5",
                          "--inner-epochs", "2", "--device", "cpu"])
    cfg = rl_grpo.CFG
    jcfg, jp = jax_init(cfg)
    out = rl_grpo.run(args, params=params_from_jax(jp, cfg, device="cpu"))
    ref = jp
    oc = jtrain.OptConfig(lr=3e-4, warmup_steps=0, weight_decay=0.0)
    step = jax.jit(jrlhf.make_grpo_step(jcfg, oc, clip_eps=0.2, kl_beta=0.02,
                                        vocab_chunk=None))
    opt = jtrain.init_opt_state(jp, oc)
    for rnd in out["rounds"]:
        b = {k: v.numpy() for k, v in rnd["batch"].items()}
        want_ref = np.asarray(jrlhf.token_logprobs(ref, b["tokens"],
                                                   b["targets"], jcfg, None))
        live = b["targets"] >= 0
        np.testing.assert_allclose(b["ref_logp"][live], want_ref[live],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            b["adv"], np.asarray(jrlhf.grpo_advantages(b["rewards"], 4)),
            rtol=1e-5, atol=1e-6)
        for m in rnd["metrics"]:
            jp, opt, jm = step(jp, opt, b["tokens"], b["targets"],
                               b["old_logp"], b["ref_logp"], b["adv"])
            losses_close([m["loss"], m["kl"]],
                         [float(jm["loss"]), float(jm["kl"])])
    assert 0.0 <= out["final_reward"] <= 1.0


# -- whole runs through main ------------------------------------------------


def test_serve_lm_main_completes_every_request():
    out = serve_lm.main(["--requests", "5", "--slots", "2", "--max-new", "6",
                         "--d-model", "64", "--layers", "2", "--device",
                         "cpu"])
    assert out["stats"]["completed"] == 5
    assert [len(t) for t in out["tokens"]] == [6] * 5
    assert out["launches"]["K4"] == 0  # the plain path on the CPU


def test_speculative_lm_main_is_token_exact():
    out = speculative_lm.main(["--max-new", "10", "--gamma", "3",
                               "--d-model", "64", "--layers", "2",
                               "--device", "cpu"])
    assert out["tokens"] == out["greedy"] and len(out["tokens"]) == 10
    assert 1 <= out["rounds"] <= 10


def test_speculative_lm_cpu_defaults_part_from_greedy_at_a_near_tie(
        monkeypatch):
    """A known defect, kept visible: at its defaults on the CPU (a bf16
    target of random weights) the example fails its own check.  The
    speculative output leaves greedy at token 12, where the target's two
    best logits lie within 2e-3 and speculation takes the other one: the
    verify pass scores gamma + 1 positions in one product, greedy one, and
    their roundings part there.  The JAX example fails the same way at
    another target seed; on the card the defaults pass."""
    from kfunca_tpu_torch.models.transformer import forward, init_params

    args = speculative_lm.parse(["--device", "cpu"])
    out = speculative_lm.run(args)
    got, want = out["tokens"], out["greedy"]
    assert got[:12] == want[:12] and got[12] != want[12]
    cfg, _ = speculative_lm.configs(args)
    with torch.no_grad():
        logits = forward(init_params(0, cfg, device=CPU), torch.tensor(
            [speculative_lm.PROMPT[0] + want[:12]], dtype=torch.int32),
            cfg)[0, -1].float()
    # which of the two a product ranks first depends on its blocking (the
    # thread count among it): the tokens are the two best, either way round
    best, second = torch.topk(logits, 2).indices.tolist()
    assert {best, second} == {want[12], got[12]}
    assert logits[best] - logits[second] < 2e-3
    monkeypatch.setattr(speculative_lm, "run", lambda args: out)
    with pytest.raises(SystemExit, match="must match greedy exactly"):
        speculative_lm.main(["--device", "cpu"])


@pytest.mark.parametrize("extra", [[], ["--no-quant"], ["--tp", "2"]])
def test_serve_hf_main_serves_the_hermetic_llama(extra):
    before = set(Path(tempfile.gettempdir()).glob("kfunca_tiny_llama_*"))
    out = serve_hf.main(["--requests", "3", "--slots", "2", "--max-new",
                         "4", "--device", "cpu", *extra])
    assert out["stats"]["completed"] == 3
    assert all(len(t) == 4 for t in out["tokens"])
    assert (out["cfg"].n_layers, out["cfg"].d_model, out["cfg"].kv_heads) \
        == (4, 256, 2)
    # the temporary checkpoint is gone
    assert set(Path(tempfile.gettempdir()).glob("kfunca_tiny_llama_*")) \
        == before


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_serve_api_main_answers_over_http(monkeypatch, temperature):
    """One text request on port 0, then the shutdown.  A sampled request
    (the server's default) reaches ids a 512-id model of the JAX example
    could not decode: the port's model has the tokenizer's vocabulary."""
    answers = []

    def one_request(srv):
        body = json.dumps({"prompt": "the sea", "max_tokens": 24,
                           "temperature": temperature}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answers.append(json.loads(r.read()))

    monkeypatch.setattr(serve_api, "wait", one_request)
    srv = serve_api.main(["--port", "0", "--slots", "2", "--pages", "32",
                          "--device", "cpu"])
    assert srv.port != 0
    assert srv.engine.cfg.vocab_size == srv.tokenizer.vocab_size == 326
    (ans,) = answers
    assert ans["usage"]["completion_tokens"] == 24
    assert isinstance(ans["choices"][0]["text"], str)


def test_serve_deepseek_main_is_token_exact():
    out = serve_deepseek.main(["--device", "cpu"])
    assert out["tokens"] == out["want"] and len(out["tokens"]) == 6


# -- every example takes the JAX example's flags ------------------------------


def _jax_flags(name) -> dict:
    """{dest: default} of the add_argument calls in the JAX example's
    source (a flag without a default: None, or False for store_true)."""
    import ast

    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "add_argument"):
            dest = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            store_true = ("action" in kw
                          and ast.literal_eval(kw["action"]) == "store_true")
            flags[dest] = (ast.literal_eval(kw["default"]) if "default" in kw
                           else (False if store_true else None))
    return flags


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "examples").glob("*.py")))
def test_example_takes_the_jax_flags_and_defaults(name):
    """The port's parser has every flag of the JAX example, with its
    default (train_lm's checkpoint in the temporary directory, the JAX
    example's /tmp), and --device, which defaults to the card."""
    mod = importlib.import_module(f"kfunca_tpu_torch.examples.{name}")
    got = vars(mod.parse([]))
    want = _jax_flags(name)
    assert set(got) == set(want) | {"device"}
    assert got["device"] is None
    if name == "train_lm":
        assert got.pop("ckpt") == str(Path(tempfile.gettempdir())
                                      / "kfunca_lm.npz")
        assert want.pop("ckpt") == "/tmp/kfunca_lm.npz"
    assert {k: got[k] for k in want} == want
