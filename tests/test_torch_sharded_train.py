"""Port parity: the sharded train step over a (dp, tp) = (2, 2) mesh.

The JAX side is make_sharded_train_step on a (2, 2) mesh of the conftest's
virtual CPU devices; the port's runs over LocalMesh(2, 2, "cpu") and over
a 4-process gloo DeviceMesh (tests/torch_mesh_ranks.py, one spawn for the
module).  Both start from the same weights (the JAX init_params carried
across by models/weights) and take the same numpy batches; the params are
gathered back to the global layout and compared after two steps.

Tolerances are test_torch_train.py's: 1e-5 of each leaf's largest entry,
plus 1e-2 * lr a step for the rules that divide an entry's gradient by its
own size (adamw, lion, adafactor, muon), whose RELATIVE gradient error is
up to ~1e-2 where a sum nearly cancels; the sharded sums run in another
order than the single device's, as GSPMD's do.  The biased GPT-2 layout
runs sgd: its k bias has a gradient that is zero up to rounding, which a
sign-like rule turns into a full lr-sized step of either sign.
"""

import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.parallel import mesh as jmesh
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax, tree_to_numpy
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.utils.tree import tree_leaves

import torch_mesh_ranks

LLAMA = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=96, max_seq_len=32, dtype="float32")
GPT2 = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=96,
            max_seq_len=32, dtype="float32", norm="layernorm",
            pos="learned", mlp_type="gelu", proj_bias=True)
# one kv head over tp = 2: attention is replicated, the MLP split
MQA = dict(LLAMA, n_kv_heads=1)
OPTS = {
    "adamw": dict(algo="adamw", clip_norm=0.5),
    "sgd": dict(algo="sgd", lr=1e-2),
    "lion": dict(algo="lion"),
    "muon": dict(algo="muon", lr=1e-2),
    "adafactor": dict(algo="adafactor", lr=1e-2, clip_norm=1.0),
    "ema": dict(algo="adamw", ema_decay=0.9, warmup_steps=1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(cfg, n=2, batch=4, seq=16, seed=0, ignore=None):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, cfg["vocab_size"], (n, batch, seq + 1)).astype(
        np.int32)
    tok, tgt = w[:, :, :-1], w[:, :, 1:].copy()
    if ignore is not None:
        tgt[:, 0, :6] = ignore
    return tok, tgt


@functools.lru_cache(maxsize=None)
def _jax_params(cfg_items):
    jc = jtf.TransformerConfig(**dict(cfg_items))
    return jc, jtf.init_params(jax.random.PRNGKey(0), jc)


def _run(cfg, okw, fsdp=False, grad_accum=1, **kw):
    """Two sharded steps in each package -> ((jax params, out), (port
    params, out)), params as global numpy trees."""
    jc, jp0 = _jax_params(tuple(sorted(cfg.items())))
    tc = ttf.TransformerConfig(**cfg)
    joc, toc = jtr.OptConfig(**okw), ttr.OptConfig(**okw)
    jm = jmesh.make_mesh(4, dp=2, tp=2)
    jp = jmesh.shard_params(jp0, jm, fsdp=fsdp)
    jst = jtr.init_opt_state(jp, joc)
    jstep = jtr.make_sharded_train_step(jc, jm, joc, fsdp=fsdp,
                                        grad_accum=grad_accum, **kw)(jp)
    mesh = tmesh.LocalMesh(2, 2, "cpu")
    sp = tmesh.shard_params(params_from_jax(jp0, tc, device="cpu"), mesh,
                            fsdp, cfg=tc)
    tst = ttr.init_opt_state(sp, toc)
    tstep = ttr.make_sharded_train_step(tc, mesh, toc, fsdp=fsdp,
                                        grad_accum=grad_accum, **kw)
    tokens, targets = _batches(cfg, ignore=kw.get("ignore_index"))
    for tok, tgt in zip(tokens, targets):
        with jm:
            jp, jst, jout = jstep(jp, jst, jnp.asarray(tok), jnp.asarray(tgt))
        sp, tst, tout = tstep(sp, tst, tok, tgt)
    return (jp, jst, jout), (tree_to_numpy(tmesh.gather_params(sp)),
                             ttr.sharded_opt_state(sp, tst), tout)


def _assert_trees_close(got, want, tol, extra_atol=0.0):
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30) if w.size else 1.0
        np.testing.assert_allclose(g, w, atol=tol * scale + extra_atol,
                                   rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _extra(okw, steps=2):
    return 0.0 if okw["algo"] == "sgd" else steps * 1e-2 * ttr.OptConfig(
        **okw).lr


@pytest.mark.parametrize("name", list(OPTS))
def test_each_optimizer_matches_the_jax_sharded_step(name):
    """Dense dp x tp with every optimizer the JAX step shards (its state
    sharded like the params), the optimizer state gathered back too."""
    okw = OPTS[name]
    (jp, jst, jloss), (tp, tst, tloss) = _run(LLAMA, okw)
    _assert_trees_close(tp, jp, 1e-5, _extra(okw))
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    got = tree_to_numpy(tmesh.gather_params(tst))
    assert int(got["step"]) == 2
    for key in jst:
        if key != "step":
            _assert_trees_close(got[key], jst[key], 1e-5, _extra(okw))


@pytest.mark.parametrize("layout", ["fsdp", "fsdp_accum", "dense_accum"])
def test_fsdp_and_accumulation_match_the_jax_sharded_step(layout):
    okw = OPTS["adamw"]
    fsdp = layout.startswith("fsdp")
    accum = 2 if layout.endswith("accum") else 1
    (jp, _, jloss), (tp, _, tloss) = _run(LLAMA, okw, fsdp=fsdp,
                                          grad_accum=accum)
    _assert_trees_close(tp, jp, 1e-5, _extra(okw))
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)


@pytest.mark.parametrize("cfg", ["gpt2", "mqa"])
def test_layouts_match_the_jax_sharded_step(cfg):
    """The tied, biased GPT-2 layout (a row-parallel tied head, the bias of
    the head-aligned qkv split) and one kv head over tp = 2 (attention
    replicated over tp), each with fsdp and accumulation."""
    okw = OPTS["sgd"]
    (jp, _, jloss), (tp, _, tloss) = _run(
        GPT2 if cfg == "gpt2" else MQA, okw, fsdp=True, grad_accum=2)
    _assert_trees_close(tp, jp, 1e-5)
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)


def test_loss_chunk_ignore_index_and_metrics_match_jax():
    """The vocab-parallel loss streamed in vocab chunks of 48 (over shards
    of 64), padding targets masked over the global microbatches, and the
    metrics dict (grad_norm counts each shard once)."""
    okw = dict(algo="adamw", clip_norm=0.5, warmup_steps=2, total_steps=10)
    kw = dict(loss_chunk=48, ignore_index=-100, with_metrics=True)
    (jp, _, jm), (tp, _, tm) = _run(LLAMA, okw, grad_accum=2, **kw)
    _assert_trees_close(tp, jp, 1e-5, _extra(okw))
    assert sorted(tm) == sorted(jm)
    for key in ("loss", "grad_norm", "lr"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    assert int(tm["step"]) == int(jm["step"]) == 2


def test_a_step_refuses_what_it_cannot_split():
    tc = ttf.TransformerConfig(**LLAMA)
    mesh = tmesh.LocalMesh(2, 2, "cpu")
    sp = tmesh.shard_params(ttf.init_params(0, tc, device="cpu"), mesh,
                            cfg=tc)
    step = ttr.make_sharded_train_step(tc, mesh, grad_accum=3)
    tok, tgt = _batches(LLAMA, n=1)
    with pytest.raises(ValueError, match="not divisible"):
        step(sp, ttr.init_opt_state(sp), tok[0], tgt[0])
    with pytest.raises(ValueError, match="does not split"):
        step(sp, ttr.init_opt_state(sp), tok[0][:3], tgt[0][:3])
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttr.make_sharded_train_step(tc, mesh, ttr.OptConfig(algo="adam"))


# -- the same step over a 4-process gloo DeviceMesh ---------------------------

GLOO_SPECS = {
    "dense": dict(fsdp=False, grad_accum=1),
    "fsdp_accum": dict(fsdp=True, grad_accum=2, ckpt=True),
    # every optimizer the JAX step shards, in one spawn (adafactor and muon
    # gather their split leaves over the group)
    "optimizers": dict(fsdp=True, grad_accum=1, ocs=OPTS),
}


@pytest.fixture(scope="module")
def gloo_steps(tmp_path_factory):
    """Each GLOO_SPECS case over a (2, 2) gloo mesh (one spawn a case):
    {case: (gathered params, losses, out dir)}."""
    out = {}
    for case, extra in GLOO_SPECS.items():
        tmp = tmp_path_factory.mktemp(f"gloo_{case}")
        tokens, targets = _batches(LLAMA)
        np.savez(tmp / "batches.npz", tokens=tokens, targets=targets)
        spec = dict(cfg=LLAMA, oc=OPTS["adamw"], seed=3,
                    batches=str(tmp / "batches.npz"), **extra)
        ctx = torch.multiprocessing.start_processes(
            torch_mesh_ranks.run_rank,
            args=(4, str(tmp / "store"), "train", spec, str(tmp)), nprocs=4,
            join=False, start_method="spawn")
        deadline = time.monotonic() + 240
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("the gloo ranks did not finish in 240 s")
        out[case] = (dict(np.load(tmp / "rank0.npz")), tmp)
    return out


def _local_run(case, okw=OPTS["adamw"]):
    extra = GLOO_SPECS[case]
    tc = ttf.TransformerConfig(**LLAMA)
    oc = ttr.OptConfig(**okw)
    mesh = tmesh.LocalMesh(2, 2, "cpu")
    sp = tmesh.shard_params(ttf.init_params(3, tc, device="cpu"), mesh,
                            extra["fsdp"], cfg=tc)
    st = ttr.init_opt_state(sp, oc)
    step = ttr.make_sharded_train_step(tc, mesh, oc, fsdp=extra["fsdp"],
                                       grad_accum=extra["grad_accum"])
    losses = []
    for tok, tgt in zip(*_batches(LLAMA)):
        sp, st, loss = step(sp, st, tok, tgt)
        losses.append(float(loss))
    return sp, st, losses


def _assert_gloo_matches_local(arrays, prefix, case, okw):
    sp, _, want_losses = _local_run(case, okw)
    want = [x.numpy() for x in tree_leaves(tmesh.gather_params(sp))]
    got = [arrays[f"{prefix}p{i}"] for i in range(len(want))]
    extra = _extra(okw)
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=1e-5 * scale + extra, rtol=1e-5)
    np.testing.assert_allclose(arrays[f"{prefix}losses"], want_losses,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["dense", "fsdp_accum"])
def test_gloo_mesh_matches_the_local_mesh(gloo_steps, case):
    """The same step over one process a rank (gloo's all-reduce sums in its
    own order) and over LocalMesh: the gathered params within the step
    tolerance, the losses within 1e-6."""
    _assert_gloo_matches_local(gloo_steps[case][0], "", case, OPTS["adamw"])


@pytest.mark.parametrize("name", list(OPTS))
def test_each_optimizer_over_gloo_matches_the_local_mesh(gloo_steps, name):
    """Every optimizer of test_each_optimizer_matches_the_jax_sharded_step
    over the gloo mesh (fsdp), against LocalMesh within the same
    tolerance."""
    _assert_gloo_matches_local(gloo_steps["optimizers"][0], f"{name}_",
                               "optimizers", OPTS[name])


def test_gloo_sharded_checkpoint_loads_into_a_local_mesh(gloo_steps):
    """save_sharded from four processes (a shard file each), loaded into
    LocalMesh(1, 4): the gathered params equal the gloo run's exactly."""
    from kfunca_tpu_torch.utils import checkpoint as ck

    arrays, tmp = gloo_steps["fsdp_accum"]
    got = [arrays[f"p{i}"] for i in range(len(arrays) - 1)]
    tc = ttf.TransformerConfig(**LLAMA)
    oc = ttr.OptConfig(**OPTS["adamw"])
    mesh = tmesh.LocalMesh(1, 4, "cpu")
    sp = tmesh.shard_params(ttf.init_params(0, tc, device="cpu"), mesh,
                            cfg=tc)
    like = {"opt": ttr.sharded_opt_state(sp, ttr.init_opt_state(sp, oc)),
            "params": sp}
    back = ck.load_sharded(str(tmp / "ckpt"), like)
    assert sorted(p.name for p in (tmp / "ckpt").glob("shard_*.npz")) == [
        f"shard_{r}.npz" for r in range(4)]
    for g, w in zip(got, tree_leaves(tmesh.gather_params(back["params"]))):
        assert np.array_equal(g, w.numpy())
    assert int(back["opt"].local[0]["step"]) == 2
