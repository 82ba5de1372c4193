"""Port parity: parallel/multihost.py.

One case for each of tests/test_multihost.py's (the single-process forms
and the pure slicing logic), and a 2-process gloo run that starts the
process group from torchrun's environment (tests/torch_mesh_ranks.py).
"""

import socket
import time

import numpy as np
import pytest
import torch

from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.parallel import multihost

import torch_mesh_ranks

ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
       "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_initialize_single_process_noop(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0


def test_mesh_single_process():
    mesh = multihost.make_multihost_mesh(device="cpu")
    assert isinstance(mesh, tmesh.LocalMesh)
    assert tuple(mesh.shape) == tmesh.AXES
    assert len(mesh.ranks) == mesh.dp * mesh.tp


def test_mesh_explicit_factors():
    mesh = multihost.make_multihost_mesh(dp=4, tp=2, device="cpu")
    assert mesh.shape == {"dp": 4, "tp": 2}


def test_batch_info_single_process():
    mesh = multihost.make_multihost_mesh(dp=4, tp=2, device="cpu")
    assert multihost.process_batch_info(32, mesh) == (0, 32)


def test_batch_info_math(monkeypatch):
    mesh = multihost.make_multihost_mesh(dp=4, tp=2, device="cpu")
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    monkeypatch.setattr(multihost, "process_index", lambda: 2)
    assert multihost.process_batch_info(32, mesh) == (16, 8)
    with pytest.raises(ValueError):
        multihost.process_batch_info(30, mesh)


def test_global_batch_from_local():
    mesh = multihost.make_multihost_mesh(dp=4, tp=2, device="cpu")
    local = np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
    stripes = multihost.global_batch_from_local(local, mesh)
    assert len(stripes) == 4 and all(s.shape == (2, 16) for s in stripes)
    np.testing.assert_array_equal(torch.cat(stripes).numpy(), local)
    with pytest.raises(ValueError, match="leading axis"):
        multihost.global_batch_from_local(local, mesh, spec=("dp", "tp"))


def test_sharded_train_step_accepts_global_batch():
    """End to end on LocalMesh(4, 2): assemble -> sharded step."""
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=1, d_ff=64, dtype="float32")
    mesh = multihost.make_multihost_mesh(dp=4, tp=2, device="cpu")
    params = tmesh.shard_params(ttf.init_params(0, cfg, device="cpu"), mesh,
                                cfg=cfg)
    opt = ttr.init_opt_state(params)
    step = ttr.make_sharded_train_step(cfg, mesh, ttr.OptConfig(lr=1e-2),
                                       loss_chunk=32)
    tokens = np.arange(8 * 16, dtype=np.int32).reshape(8, 16) % 64
    targets = np.roll(tokens, -1, axis=1)
    tok = multihost.global_batch_from_local(tokens, mesh)
    tgt = multihost.global_batch_from_local(targets, mesh)
    params, opt, loss = step(params, opt, tok, tgt)
    assert np.isfinite(float(loss))
    assert int(opt[0]["step"]) == 1


def test_tp_must_fit_local_devices(monkeypatch):
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "local_process_count", lambda: 4)
    with pytest.raises(ValueError, match="does not pack"):
        multihost.make_multihost_mesh(dp=1, tp=8)


def test_initialize_needs_a_coordinator_for_several_processes(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize()


def test_two_gloo_processes_initialize_from_the_environment(tmp_path):
    """torchrun's variables on a free localhost port: both processes join,
    the mesh is (2, 1), each loads its stripe of arange(16) and the
    dp-sharded batch sums to 120, as the JAX dryrun's multihost phase."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.start_processes(
        torch_mesh_ranks.run_initialize, args=(2, port, str(tmp_path)),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo processes did not finish in 240 s")
    for r in range(2):
        got = np.load(tmp_path / f"init{r}.npz")
        assert bool(got["active"])
        assert (int(got["start"]), int(got["size"])) == (8 * r, 8)
        assert float(got["total"]) == sum(range(16))
        assert int(got["shape"]) == 2
