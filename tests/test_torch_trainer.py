"""Port parity: data, checkpoints, evaluation and the Trainer.

TokenDataset batches must equal the JAX package's exactly (numpy with the
same seeded generators); a checkpoint written by the JAX package must load
in the port, and the port's in the JAX package; evaluate must give the JAX
package's NLL and accuracy on shared weights; and the Trainer's resume must
be bitwise identical to an uninterrupted run.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import data as jdata
from kfunca_tpu.models import eval as jeval
from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.utils import checkpoint as jckpt
from kfunca_tpu_torch.models import data as tdata
from kfunca_tpu_torch.models import eval as teval
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.trainer import Trainer, TrainerConfig
from kfunca_tpu_torch.models.weights import (
    opt_state_from_jax, params_from_jax, tree_to_numpy)
from kfunca_tpu_torch.utils import checkpoint as tckpt
from kfunca_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=96, max_seq_len=32, dtype="float32", attention_window=8)


def _corpus(n=4000, vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.integers(1, 5, size=n)) % vocab).astype(np.int32)


# -- data ---------------------------------------------------------------------


def test_token_dataset_batches_equal_jax():
    corpus = _corpus()
    jd = jdata.TokenDataset(corpus, 16, 4, seed=3)
    td = tdata.TokenDataset(corpus, 16, 4, seed=3, device="cpu")
    for step in (0, 1, 7, 12345):
        for a, b in zip(td.batch_at(step), jd.batch_at(step)):
            assert a.dtype == np.int32 and a.shape == (4, 16)
            np.testing.assert_array_equal(a, b)
    for _ in range(3):  # the stateful sampler draws the same sequence
        for a, b in zip(td.sample_batch(), jd.sample_batch()):
            np.testing.assert_array_equal(a, b)
    it, jit_ = td.iter_from(5), jd.iter_from(5)
    for _ in range(2):
        for a, b in zip(next(it), next(jit_)):
            np.testing.assert_array_equal(a, b)
    tokens, targets = td.batch_at(2)
    np.testing.assert_array_equal(tokens[:, 1:], targets[:, :-1])


def test_token_dataset_checks_its_corpus():
    with pytest.raises(ValueError, match="flat token array"):
        tdata.TokenDataset(np.zeros((4, 4), np.int32), 2, 1, device="cpu")
    with pytest.raises(ValueError, match="shorter than one sequence"):
        tdata.TokenDataset(np.zeros(8, np.int32), 8, 1, device="cpu")


def test_prefetcher_stages_batches_on_the_device():
    td = tdata.TokenDataset(_corpus(), 16, 4, seed=1, device="cpu")
    twin = tdata.TokenDataset(_corpus(), 16, 4, seed=1, device="cpu")
    pf = tdata.Prefetcher(td, depth=2)
    try:
        for _ in range(3):
            tokens, targets = pf.next()
            want = twin.sample_batch()
            assert tokens.dtype == torch.int32 and tokens.device.type == "cpu"
            np.testing.assert_array_equal(tokens.numpy(), want[0])
            np.testing.assert_array_equal(targets.numpy(), want[1])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# -- checkpoints ----------------------------------------------------------------


def _jax_state(oc_kw=None):
    jc = jtf.TransformerConfig(**CFG)
    jp = jtf.init_params(jax.random.PRNGKey(1), jc)
    joc = jtr.OptConfig(**(oc_kw or {}))
    return jc, jp, jtr.init_opt_state(jp, joc)


def test_checkpoint_saved_by_jax_loads_in_the_port(tmp_path):
    jc, jp, jst = _jax_state(dict(state_dtype="bfloat16", ema_decay=0.9))
    # nonzero bf16 moments, so their bits are worth checking
    rng = np.random.default_rng(0)
    jst["m"] = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.bfloat16),
        jst["m"])
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, {"params": jp, "opt": jst, "step": np.int64(7)})
    tc = ttf.TransformerConfig(**CFG)
    like = {"params": ttf.init_params(0, tc, device="cpu"),
            "opt": ttr.init_opt_state(
                ttf.init_params(0, tc, device="cpu"),
                ttr.OptConfig(state_dtype="bfloat16", ema_decay=0.9),
                device="cpu"),
            "step": np.int64(0)}
    tree = tckpt.load(path, like=like)
    assert int(tree["step"]) == 7 and tree["step"].dtype == np.int64
    want = jax.tree_util.tree_leaves({"params": jp, "opt": jst})
    got = tree_leaves({"params": tree["params"], "opt": tree["opt"]})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                np.asarray(w).view(np.uint16))
        else:
            assert str(g.dtype) == f"torch.{w.dtype.name}"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load(path, like={"params": like["params"]})


def test_checkpoint_saved_by_the_port_loads_in_jax(tmp_path):
    jc, jp, jst = _jax_state()
    tc = ttf.TransformerConfig(**CFG)
    tp = ttf.init_params(5, tc, device="cpu")
    tst = ttr.init_opt_state(tp, device="cpu")
    tst["m"]["embed"] = torch.randn(tst["m"]["embed"].shape).bfloat16()
    path = str(tmp_path / "port.npz")
    tckpt.save(path, {"params": tp, "opt": tst, "step": np.int64(3)})
    assert not os.path.exists(path + ".tmp")
    jst["m"]["embed"] = jst["m"]["embed"].astype(jnp.bfloat16)
    tree = jckpt.load(path, like={"params": jp, "opt": jst,
                                  "step": np.int64(0)})
    for g, w in zip(jax.tree_util.tree_leaves(tree["params"]),
                    tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    np.testing.assert_array_equal(
        np.asarray(tree["opt"]["m"]["embed"]).view(np.uint16),
        tst["m"]["embed"].view(torch.int16).numpy().view(np.uint16))
    # the port's own round trip, bf16 bit for bit, and the flat form
    back = tckpt.load(path, like={"params": tp, "opt": tst,
                                  "step": np.int64(0)})
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back["opt"]), tree_leaves(tst)))
    flat = tckpt.load(path)
    assert len(flat) == len(tree_leaves({"p": tp, "o": tst})) + 1
    ml = tckpt.load(path, like={"params": tp, "opt": tst, "step": np.int64(0)},
                    device="meta")
    assert ml["params"]["embed"].device.type == "meta"
    tckpt.save(path, {"x": np.ones(3, ml_dtypes.bfloat16)})
    assert tckpt.load(path)[0].dtype == np.uint16


def test_tree_order_is_jax_flatten_order():
    tree = {"b": [3, {"z": 4, "a": 5}], "a": 1, "c": None, "B": 2}
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    doubled = tree_map(lambda x: 2 * x, tree)
    assert doubled == jax.tree_util.tree_map(lambda x: 2 * x, tree)
    assert tree_unflatten(tree, [10, 20, 30, 40, 50]) == \
        jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                     [10, 20, 30, 40, 50])
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(tree, range(6))


# -- evaluation ------------------------------------------------------------------


def test_evaluate_matches_jax():
    jc, jp, _ = _jax_state()
    tc = ttf.TransformerConfig(**CFG)
    tp = params_from_jax(jp, tc, device="cpu")
    ds = jdata.TokenDataset(_corpus(), 16, 4, seed=2)
    batches = [ds.batch_at(i) for i in range(3)]
    masked = [(t, np.where(g % 5 == 0, -100, g)) for t, g in batches]
    for bs, kw in ((batches, {}), (masked, {"ignore_index": -100}),
                   (batches, {"max_batches": 2})):
        want = jeval.evaluate(jp, jc, bs, vocab_chunk=48, **kw)
        got = teval.evaluate(tp, tc, bs, vocab_chunk=48, device="cpu", **kw)
        assert got["tokens"] == want["tokens"]
        assert got["token_accuracy"] == pytest.approx(want["token_accuracy"])
        assert got["nll"] == pytest.approx(want["nll"], abs=1e-5)
        assert got["perplexity"] == pytest.approx(want["perplexity"],
                                                  rel=1e-5)
    want = jeval.perplexity(jp, jc, _corpus(300), batch_size=4, seq_len=16,
                            vocab_chunk=64)
    got = teval.perplexity(tp, tc, _corpus(300), batch_size=4, seq_len=16,
                           vocab_chunk=64, device="cpu")
    assert got == pytest.approx(want, rel=1e-5)
    with pytest.raises(ValueError, match="no tokens scored"):
        teval.evaluate(tp, tc, [], device="cpu")
    with pytest.raises(ValueError, match="shorter than one"):
        teval.perplexity(tp, tc, _corpus(10), seq_len=16, device="cpu")
    assert not any(p.requires_grad for p in tree_leaves(tp))


# -- the Trainer -----------------------------------------------------------------


def _fit(out_dir, total, **kw):
    tc = ttf.TransformerConfig(**CFG)
    oc = ttr.OptConfig(lr=1e-3, warmup_steps=2, clip_norm=1.0)
    trainer = Trainer(tc, TrainerConfig(out_dir=str(out_dir),
                                        total_steps=total, log_every=1, **kw),
                      oc, device="cpu")
    ds = tdata.TokenDataset(_corpus(), 16, 4, seed=4, device="cpu")
    return trainer, ds


def test_trainer_resume_is_bitwise_identical(tmp_path):
    """6 steps straight against 3 steps, a new Trainer, and 3 more from
    the checkpoint: every param and optimizer leaf is bitwise equal."""
    straight, ds = _fit(tmp_path / "a", 6)
    want = straight.fit(ds, seed=1)
    first, _ = _fit(tmp_path / "b", 3)
    first.fit(ds, seed=1)
    second, _ = _fit(tmp_path / "b", 6)
    assert second.latest_checkpoint() == (
        str(tmp_path / "b" / "step_00000003.npz"), 3)
    got = second.fit(ds, seed=99)  # the seed is ignored on resume
    assert got["step"] == 6 and len(got["history"]) == 3
    for a, b in zip(tree_leaves((got["params"], got["opt_state"])),
                    tree_leaves((want["params"], want["opt_state"]))):
        assert torch.equal(a, b)
    assert [h["loss"] for h in got["history"]] == [
        h["loss"] for h in want["history"][3:]]
    losses = [h["loss"] for h in want["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    # nothing left to do: fit returns the loaded state and writes nothing
    third, _ = _fit(tmp_path / "b", 6)
    before = sorted(os.listdir(tmp_path / "b"))
    again = third.fit(ds)
    assert sorted(os.listdir(tmp_path / "b")) == before
    assert torch.equal(again["params"]["embed"], want["params"]["embed"])


def test_trainer_checkpoints_retention_eval_and_callback(tmp_path):
    trainer, ds = _fit(tmp_path, 5, ckpt_every=1, keep=2, eval_every=2,
                       eval_batches=2, loss_chunk=48)
    assert trainer.latest_checkpoint() is None
    seen = []
    out = trainer.fit(ds, seed=0, eval_dataset=ds,
                      on_step=lambda s, m: seen.append((s, m["lr"])))
    assert sorted(os.listdir(tmp_path)) == ["step_00000004.npz",
                                            "step_00000005.npz"]
    assert [s for s, _ in seen] == [1, 2, 3, 4, 5]
    assert seen[0][1] == pytest.approx(5e-4) and seen[1][1] == pytest.approx(
        1e-3)
    assert sorted(out["evals"]) == [2, 4]
    assert out["evals"][4]["tokens"] == 2 * 4 * 16
    assert set(out["history"][0]) == {"loss", "grad_norm", "lr", "step"}


def test_trainer_step_matches_the_jax_trainer(tmp_path):
    """Two steps of each package's Trainer from shared weights on the same
    dataset: the logged losses agree (fp32, 1e-5)."""
    from kfunca_tpu.models import trainer as jtrainer

    jc, jp, _ = _jax_state()
    tc = ttf.TransformerConfig(**CFG)
    corpus = _corpus()
    jt = jtrainer.Trainer(jc, jtrainer.TrainerConfig(
        out_dir=str(tmp_path / "j"), total_steps=2, log_every=1),
        jtr.OptConfig(lr=1e-3))
    tt = Trainer(tc, TrainerConfig(out_dir=str(tmp_path / "t"), total_steps=2,
                                   log_every=1), ttr.OptConfig(lr=1e-3),
                 device="cpu")
    jout = jt.fit(jdata.TokenDataset(corpus, 16, 4, seed=4), params=jp)
    tout = tt.fit(tdata.TokenDataset(corpus, 16, 4, seed=4, device="cpu"),
                  params=params_from_jax(jp, tc, device="cpu"))
    for jh, th in zip(jout["history"], tout["history"]):
        assert th["loss"] == pytest.approx(jh["loss"], abs=1e-5)
        assert th["grad_norm"] == pytest.approx(jh["grad_norm"], rel=1e-4)
    # and the final checkpoints are interchangeable
    tree = tckpt.load(
        str(tmp_path / "j" / "step_00000002.npz"),
        like={"params": tout["params"], "opt": tout["opt_state"],
              "step": np.int64(0)})
    np.testing.assert_allclose(
        tree["params"]["embed"].numpy(), tout["params"]["embed"].numpy(),
        atol=1e-5)


def test_opt_state_from_jax_keeps_every_dtype():
    _, jp, jst = _jax_state(dict(algo="adafactor", state_dtype="bfloat16"))
    tst = opt_state_from_jax(jst, device="cpu")
    assert tst["step"].dtype == torch.int32 and tst["step"].ndim == 0
    assert tst["vr"]["embed"].dtype == torch.float32
    assert tst["v1"]["final_norm"].dtype == torch.bfloat16
    assert tst["v1"]["embed"].ndim == 0
    back = tree_to_numpy(tst)
    assert back["v1"]["final_norm"].dtype == np.float32
