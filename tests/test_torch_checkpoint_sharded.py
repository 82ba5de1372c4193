"""Port parity: sharded and asynchronous checkpoints.

save_sharded / load_sharded write the JAX package's directory format, so
a directory written by either package loads in the other (params sharded
over a (2, 2) mesh on both sides, bf16 leaves included); a missing region
raises; save_async copies before it returns and reports a failed write on
wait().
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.parallel import mesh as jmesh
from kfunca_tpu.utils import checkpoint as jck
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax, tree_to_numpy
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.utils import checkpoint as tck
from kfunca_tpu_torch.utils.tree import tree_leaves

CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=96, max_seq_len=32, dtype="bfloat16", proj_bias=True)


def _jax_params(dtype):
    jc = jtf.TransformerConfig(**CFG)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    return jax.tree_util.tree_map(lambda x: x.astype(dtype), jp)


def _port(jp, mesh_shape=(2, 2), fsdp=True):
    tc = ttf.TransformerConfig(**CFG)
    params = params_from_jax(jp, tc, device="cpu")
    return tmesh.shard_params(params, tmesh.LocalMesh(*mesh_shape, "cpu"),
                              fsdp, cfg=tc)


def _same(got, want):
    """Bit for bit (bf16 compared widened to fp32, which is exact)."""
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        g, w = (np.asarray(x) for x in (g, w))
        g, w = (x.astype(np.float32) if x.dtype.name == "bfloat16" else x
                for x in (g, w))
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_port_directory_loads_in_jax(tmp_path, dtype):
    jp = _jax_params(dtype)
    sp = _port(jp)
    tck.save_sharded(str(tmp_path), {"params": sp, "step": torch.tensor(7)})
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["leaves"][0]["dtype"] == jnp.dtype(dtype).name
    jm = jmesh.make_mesh(4, dp=2, tp=2)
    like = {"params": jmesh.shard_params(jp, jm, fsdp=False),
            "step": jnp.int64(0)}
    back = jck.load_sharded(str(tmp_path), like)
    _same(back["params"], jp)
    assert int(back["step"]) == 7


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_jax_directory_loads_in_the_port(tmp_path, dtype):
    jp = _jax_params(dtype)
    jm = jmesh.make_mesh(4, dp=2, tp=2)
    jck.save_sharded(str(tmp_path), jmesh.shard_params(jp, jm, fsdp=True))
    like = _port(jax.tree_util.tree_map(jnp.zeros_like, jp), (1, 4), False)
    back = tck.load_sharded(str(tmp_path), like)
    assert isinstance(back, tmesh.ShardedParams)
    assert back.local[0]["embed"].dtype == like.local[0]["embed"].dtype
    _same(tree_to_numpy(tmesh.gather_params(back)), jp)


def test_sharded_round_trip_of_a_train_state_is_bit_exact(tmp_path):
    """The fsdp params and adamw state after a step, saved and loaded into
    the same mesh (every held piece equal) and into another."""
    tc = ttf.TransformerConfig(**dict(CFG, dtype="float32"))
    mesh = tmesh.LocalMesh(2, 2, "cpu")
    sp = tmesh.shard_params(ttf.init_params(0, tc, device="cpu"), mesh,
                            True, cfg=tc)
    st = ttr.init_opt_state(sp)
    step = ttr.make_sharded_train_step(tc, mesh, fsdp=True)
    tok = np.random.default_rng(0).integers(0, 128, (4, 9))
    sp, st, _ = step(sp, st, tok[:, :-1], tok[:, 1:])
    state = {"opt": ttr.sharded_opt_state(sp, st), "params": sp}
    tck.save_sharded(str(tmp_path), state)
    back = tck.load_sharded(str(tmp_path), state)
    for a, b in zip(sp.local + list(st), back["params"].local
                    + back["opt"].local):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
    other = tmesh.shard_params(ttf.init_params(1, tc, device="cpu"),
                               tmesh.LocalMesh(1, 4, "cpu"), cfg=tc)
    moved = tck.load_sharded(str(tmp_path), {
        "opt": ttr.sharded_opt_state(other, ttr.init_opt_state(other)),
        "params": other})
    for x, y in zip(tree_leaves(tmesh.gather_params(moved["params"])),
                    tree_leaves(tmesh.gather_params(sp))):
        assert torch.equal(x, y)


def test_a_missing_region_raises(tmp_path):
    sp = _port(_jax_params(jnp.float32))
    tck.save_sharded(str(tmp_path), sp)
    path = tmp_path / "shard_0.npz"
    with np.load(path) as z:
        arrays = dict(z)
    records = json.loads(bytes(arrays["__shard_manifest__"]).decode())
    leaf = records["shards"].pop()["leaf"]  # the last wqkv's last piece
    arrays["__shard_manifest__"] = np.frombuffer(
        json.dumps(records).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match=f"leaf {leaf}: only"):
        tck.load_sharded(str(tmp_path), sp)
    with pytest.raises(ValueError, match=f"leaf {leaf}: only"):
        jck.load_sharded(str(tmp_path), _jax_params(jnp.float32))


def test_save_async_copies_before_it_returns(tmp_path, monkeypatch):
    """The write is held on an event: save_async has returned while the
    writer waits, the params are changed, and the file holds the values
    of the call."""
    tc = ttf.TransformerConfig(**dict(CFG, dtype="float32"))
    params = ttf.init_params(0, tc, device="cpu")
    want = [x.clone() for x in tree_leaves(params)]
    gate = threading.Event()
    real = tck._write

    def held(*args):
        gate.wait(30)
        return real(*args)

    monkeypatch.setattr(tck, "_write", held)
    handle = tck.save_async(str(tmp_path / "a.npz"), params)
    assert not handle.done()
    for x in tree_leaves(params):
        x.add_(1.0)
    gate.set()
    handle.wait()
    for got, w in zip(tree_leaves(tck.load(str(tmp_path / "a.npz"), params)),
                      want):
        assert torch.equal(got, w)
    # the JAX loader reads it too
    assert np.array_equal(jck.load(str(tmp_path / "a.npz"))[0],
                          want[0].numpy())


def test_save_async_of_sharded_params_and_its_error_on_wait(tmp_path):
    sp = _port(_jax_params(jnp.bfloat16))
    handle = tck.save_async(str(tmp_path / "s.npz"), sp)
    handle.wait()
    full = tmesh.gather_params(sp)
    got = tree_leaves(tck.load(str(tmp_path / "s.npz"), full))
    assert all(torch.equal(g, w) for g, w in zip(got, tree_leaves(full)))
    bad = tck.save_async(str(tmp_path / "missing" / "x.npz"), sp)
    with pytest.raises(FileNotFoundError):
        bad.wait()
