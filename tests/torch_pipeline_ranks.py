"""One rank of the pipeline, zero-bubble and expert-parallel paths over a
torch.distributed gloo group.

tests/test_torch_pipeline_gloo.py spawns `run_rank` in four processes
(tests/test_torch_cuda.py in one process a card, over NCCL).  A spawned
child imports this module by name, so it imports only torch, numpy and
the port: no JAX, and not the tests' conftest.  `tasks(n)` holds each
check's mesh and function of a mesh; the tests run the same functions
over a LocalMesh in one process and need the same arrays.  Each rank
writes rank<r>.npz under out_dir.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from kfunca_tpu_torch.models import moe as tmoe
from kfunca_tpu_torch.models import pipeline_lm as tpl
from kfunca_tpu_torch.parallel import collectives as cc
from kfunca_tpu_torch.parallel import mesh as meshlib
from kfunca_tpu_torch.parallel import pipeline as tpipe
from kfunca_tpu_torch.parallel import zero_bubble as tzb
from kfunca_tpu_torch.utils.tree import tree_leaves

N = 4  # the gloo test's processes
DIM, M, MB = 8, 4, 2
PLM = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=4, n_experts=4,
           d_ff=24, n_stages=2, n_microbatches=2, dtype="float32")
MOE = dict(n_experts=8, d_model=8, d_ff=12, capacity_factor=1.0, top_k=2)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def rank_input(rank, shape=(4, 6), seed=11, device="cpu"):
    return torch.randn(shape, generator=gen(seed + rank)).to(device)


def collectives_task(mesh):
    """shift (both ways, cyclic and not) and all_to_all, raw and
    differentiable (the gradient of sum(out * weight))."""
    dev = mesh.device
    out = {r: {} for r in mesh.ranks}
    xs = [rank_input(r, device=dev) for r in mesh.ranks]
    for offset in (1, -1):
        for cyclic in (True, False):
            key = f"shift{offset}{'c' if cyclic else ''}"
            raw = mesh.collective("shift", xs, "pp", offset=offset,
                                  cyclic=cyclic)
            xr = [x.clone().requires_grad_(True) for x in xs]
            ys = cc.shift(xr, mesh, "pp", offset, cyclic)
            ws = [rank_input(r, seed=29, device=dev) for r in mesh.ranks]
            gs = torch.autograd.grad(sum((y * w).sum()
                                         for y, w in zip(ys, ws)), xr)
            for i, r in enumerate(mesh.ranks):
                out[r][key] = _np(raw[i])
                out[r][key + "_grad"] = _np(gs[i])
    n = mesh.size("pp")
    xr = [rank_input(r, (2 * n, 3), device=dev).requires_grad_(True)
          for r in mesh.ranks]
    ys = cc.all_to_all(xr, mesh, "pp", split_dim=0, concat_dim=1)
    ws = [rank_input(r, ys[0].shape, seed=31, device=dev)
          for r in mesh.ranks]
    gs = torch.autograd.grad(sum((y * w).sum() for y, w in zip(ys, ws)), xr)
    for i, r in enumerate(mesh.ranks):
        out[r]["a2a"] = _np(ys[i])
        out[r]["a2a_grad"] = _np(gs[i])
    return out


def _np(t):
    return t.detach().cpu().numpy()


def _tanh_stage(sp, h):
    for j in range(sp["w"].shape[0]):
        h = torch.tanh(h @ sp["w"][j])
    return h


def _zb_inputs(n, dev):
    g = gen(5)
    layers = [{"w": (torch.randn((DIM, DIM), generator=g) * 0.3).to(dev)}
              for _ in range(2 * n)]
    x = torch.randn((M, MB, DIM), generator=g).to(dev)
    tgt = torch.randn((M, MB, DIM), generator=g).to(dev)
    return layers, x, tgt


def zb_task(mesh):
    """A ZB-H1 and a ZB-V step over the pp ranks, and GPipe's outputs and
    gradients: losses and each rank's gradients."""
    N = mesh.size("pp")
    layers, x, tgt = _zb_inputs(N, mesh.device)

    def loss(y, i):
        return ((y - tgt[i]) ** 2).sum()

    out = {r: {} for r in mesh.ranks}
    sp = tpipe.stage_shards(tpipe.stack_stages(layers[:N], N), mesh)
    lz, gz = tzb.make_zb_train_step(_tanh_stage, loss, mesh, n_micro=M)(
        sp, [x] * len(mesh.ranks))
    spv = tpipe.stage_shards(tzb.stack_stages_v(layers, N), mesh)
    lv, gv = tzb.make_zbv_train_step(
        lambda p, h: torch.tanh(h @ p["w"]), loss, mesh, n_micro=M)(
        spv, [x] * len(mesh.ranks))
    fwd = tpipe.make_pipelined_forward(
        lambda p, h: torch.tanh(h @ p["w"]), mesh)
    trees = [{"w": t["w"].clone().requires_grad_(True)} for t in sp.local]
    ys = fwd(trees, [x.clone() for _ in mesh.ranks])
    gp = torch.autograd.grad(sum(((y - tgt) ** 2).sum() for y in ys),
                             [t["w"] for t in trees])
    for i, r in enumerate(mesh.ranks):
        out[r].update(zb_loss=_np(lz), zb_grad=_np(gz[i]["w"]),
                      zbv_loss=_np(lv), zbv_grad=_np(gv[i]["w"]),
                      gpipe_out=_np(ys[i]), gpipe_grad=_np(gp[i]))
    return out


def ep_task(mesh):
    """An expert-parallel forward over the ep ranks (capacity 1.0, so
    tokens drop) and its gradients."""
    cfg = tmoe.MoEConfig(**MOE)
    params = tmoe.init_moe_params(7, cfg, device="cpu")
    x = torch.randn((8, 4, MOE["d_model"]), generator=gen(9)).to(mesh.device)
    sp = tmoe.shard_moe_params(params, mesh)
    trees = [{k: v.clone().requires_grad_(True) for k, v in t.items()}
             for t in sp.local]
    parts = x.chunk(mesh.size("ep"))
    xs = [parts[mesh.index(r, "ep")] for r in mesh.ranks]
    outs, aux = tmoe.make_moe_ffn_ep(mesh, cfg)(xs, trees)
    grads = torch.autograd.grad(sum((o ** 2).sum() for o in outs),
                                [t[k] for t in trees
                                 for k in ("router", "w_in", "w_out")])
    out = {}
    for i, r in enumerate(mesh.ranks):
        out[r] = {"out": _np(outs[i]), "aux": _np(aux[i]),
                  "d_router": _np(grads[3 * i]),
                  "d_w_in": _np(grads[3 * i + 1]),
                  "d_w_out": _np(grads[3 * i + 2])}
    return out


def plm_task(mesh):
    """One pipeline_lm SGD step over (dp, pp 2, tp): the loss and the
    gathered params."""
    cfg = tpl.PipelineMoEConfig(**PLM)
    params = tpl.init_params(3, cfg, device="cpu")
    g = gen(4)
    tok = torch.randint(0, PLM["vocab_size"], (4, 8), generator=g)
    tgt = torch.randint(0, PLM["vocab_size"], (4, 8), generator=g)
    sp = tpl.shard_params(params, mesh, cfg)
    sp, loss = tpl.make_train_step(cfg, mesh, lr=0.1)(sp, tok, tgt)
    full = meshlib.gather_params(sp)
    res = {"loss": _np(loss)}
    res.update({f"p{i}": _np(x) for i, x in enumerate(tree_leaves(full))})
    return {r: res for r in mesh.ranks}


def tasks(n):
    """{name: (axis names, sizes, function of a mesh)} over n ranks."""
    return {"collectives": (("pp",), (n,), collectives_task),
            "zb": (("pp",), (n,), zb_task),
            "ep": (("ep",), (n,), ep_task),
            "plm": (("dp", "pp", "tp"), (n // 4 or 1, 2, 2 if n >= 4 else 1),
                    plm_task)}


def local_results(task, n=N, device="cpu"):
    """The task over a LocalMesh of n ranks in this process: {rank:
    arrays}."""
    names, sizes, fn = tasks(n)[task]
    return fn(meshlib.LocalMesh(axes=dict(zip(names, sizes)), device=device))


def run_rank(rank, world, init_file, out_dir, backend="gloo"):
    """Every task on this rank of a group of `world` processes: gloo on
    the CPU, or NCCL on card `rank`."""
    torch.set_num_threads(1)
    kind = "cpu"
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kind = "cuda"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = {}
        for task, (names, sizes, fn) in tasks(world).items():
            dm = init_device_mesh(kind, sizes, mesh_dim_names=names)
            res = fn(meshlib.as_mesh(dm))
            (mine,) = res.values()
            out.update({f"{task}.{k}": v for k, v in mine.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
