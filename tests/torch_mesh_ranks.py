"""One rank of a (dp, tp) mesh over a torch.distributed gloo group.

The mesh tests spawn `run_rank` in several processes.  A spawned child
imports this module by name, so it imports only torch, numpy and the port:
no JAX, and not the tests' conftest.  Each task writes rank<r>.npz (and
what else it says) under out_dir.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from kfunca_tpu_torch.parallel import collectives as cc
from kfunca_tpu_torch.parallel import mesh as meshlib
from kfunca_tpu_torch.parallel import multihost

COLLECTIVE_DIMS = {"sum": 0, "max": 0, "gather": 1, "split": 1,
                   "reduce_scatter": 0}


def rank_input(rank, shape=(4, 6), seed=11):
    """Rank r's input to the collective checks (the same in every form)."""
    g = torch.Generator().manual_seed(seed + rank)
    return torch.randn(shape, generator=g)


def collectives_task(mesh):
    """Every raw collective over both axes, and each differentiable one's
    forward and backward (the gradient of sum(out * weight))."""
    r = mesh.ranks[0]
    x = rank_input(r)
    out = {}
    for axis in meshlib.AXES:
        for kind, dim in COLLECTIVE_DIMS.items():
            out[f"{kind}_{axis}"] = mesh.collective(kind, [x], axis, dim)[0]
        for name in ("copy", "reduce", "gather", "scatter", "all_gather",
                     "reduce_scatter"):
            xr = x.clone().requires_grad_(True)
            y = getattr(cc, name)([xr], mesh, axis, *(() if name in (
                "copy", "reduce") else (1,)))[0]
            w = rank_input(r, y.shape, seed=29)
            (g,) = torch.autograd.grad((y * w).sum(), [xr])
            out[f"d_{name}_{axis}"] = y.detach()
            out[f"d_{name}_{axis}_grad"] = g
    return {k: v.numpy() for k, v in out.items()}


def train_task(mesh, spec, out_dir):
    """Two sharded steps from the spec's seeded params and batches; the
    gathered params and the losses.  With `ckpt`, the fsdp state is also
    written by save_sharded from every process.  With `ocs` (name ->
    OptConfig fields) the steps run once an optimizer, the arrays keyed
    "<name>_"."""
    if spec.get("ocs"):
        out = {}
        for name, oc in spec["ocs"].items():
            one = train_task(mesh, {**spec, "oc": oc, "ocs": None,
                                    "ckpt": False}, out_dir)
            out.update({f"{name}_{k}": v for k, v in one.items()})
        return out
    from kfunca_tpu_torch.models import train as ttr
    from kfunca_tpu_torch.models import transformer as ttf
    from kfunca_tpu_torch.utils import checkpoint as ck
    from kfunca_tpu_torch.utils.tree import tree_leaves

    cfg = ttf.TransformerConfig(**spec["cfg"])
    oc = ttr.OptConfig(**spec["oc"])
    params = ttf.init_params(spec["seed"], cfg, device="cpu")
    sp = meshlib.shard_params(params, mesh, spec["fsdp"], cfg=cfg)
    state = ttr.init_opt_state(sp, oc)
    step = ttr.make_sharded_train_step(cfg, mesh, oc, fsdp=spec["fsdp"],
                                       grad_accum=spec["grad_accum"])
    batches = np.load(spec["batches"])
    start, size = multihost.process_batch_info(batches["tokens"].shape[1],
                                               mesh)
    losses = []
    for tok, tgt in zip(batches["tokens"], batches["targets"]):
        local_tok = multihost.global_batch_from_local(
            tok[start:start + size], mesh)
        local_tgt = multihost.global_batch_from_local(
            tgt[start:start + size], mesh)
        sp, state, loss = step(sp, state, local_tok, local_tgt)
        losses.append(float(loss))
    full = meshlib.gather_params(sp)
    out = {f"p{i}": x.cpu().numpy() for i, x in enumerate(tree_leaves(full))}
    out["losses"] = np.asarray(losses)
    if spec.get("ckpt"):
        ck.save_sharded(os.path.join(out_dir, "ckpt"),
                        {"opt": ttr.sharded_opt_state(sp, state),
                         "params": sp})
    return out


def serve_task(mesh, spec):
    """A tensor-parallel InferenceServer over the mesh: the greedy tokens
    of the spec's prompts (every rank serves the same requests)."""
    from kfunca_tpu_torch.models import serve
    from kfunca_tpu_torch.models import transformer as ttf
    from kfunca_tpu_torch.utils.tree import tree_map

    cfg = ttf.TransformerConfig(**spec["cfg"])
    dev = meshlib.as_mesh(mesh).device
    params = tree_map(lambda t: t.to(dev),
                      ttf.init_params(spec["seed"], cfg, device="cpu"))
    srv = serve.InferenceServer(params, cfg, mesh=mesh, **spec["server"])
    rids = [srv.submit(p, max_new=spec["max_new"]) for p in spec["prompts"]]
    done = srv.run()
    return {f"t{i}": np.asarray(done[r]) for i, r in enumerate(rids)}


TASKS = {"train": train_task, "serve": lambda mesh, spec, _: serve_task(
    mesh, spec)}


def run_rank(rank, world, init_file, task, spec, out_dir, dp=2, tp=2,
             backend="gloo"):
    """This rank's part of `task` ("collectives", "train" or "serve") on a
    (dp, tp) DeviceMesh: gloo on the CPU, or NCCL on card `rank`; writes
    rank<r>.npz."""
    torch.set_num_threads(1)
    kind = "cpu"
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kind = "cuda"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        dm = init_device_mesh(kind, (dp, tp), mesh_dim_names=meshlib.AXES)
        mesh = meshlib.as_mesh(dm)
        out = (collectives_task(mesh) if task == "collectives"
               else TASKS[task](dm, spec, out_dir))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def run_initialize(rank, world, port, out_dir):
    """multihost.initialize from torchrun's environment, then a dp-sharded
    batch: the sum of every process's stripe of arange(16)."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    active = multihost.initialize()
    try:
        mesh = multihost.make_multihost_mesh(dp=world, tp=1)
        start, size = multihost.process_batch_info(16, mesh)
        stripe = multihost.global_batch_from_local(
            np.arange(start, start + size, dtype=np.float32)[:, None], mesh)
        total = stripe.sum()
        dist.all_reduce(total)
        np.savez(os.path.join(out_dir, f"init{rank}.npz"),
                 active=active, start=start, size=size, total=total.numpy(),
                 shape=np.asarray(meshlib.as_mesh(mesh).shape["dp"]))
    finally:
        dist.destroy_process_group()
