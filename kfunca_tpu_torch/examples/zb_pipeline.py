"""Zero-bubble pipeline training over a 4-stage mesh.

Demonstrates the hand-scheduled F/B/W pipeline of parallel/zero_bubble.py:
the schedule table, its cost against the GPipe pipeline, and a short
training loop where the ZB step supplies (loss, stage grads) and plain SGD
consumes them.  The mesh is a LocalMesh(axes={"pp": 4}): the four stages
on the one card (or on the CPU with --device cpu), stepped in lockstep.
The stages are tanh MLPs: no kernel of the port runs here.

    python -m kfunca_tpu_torch.examples.zb_pipeline
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..parallel.mesh import LocalMesh
from ..parallel.pipeline import stack_stages, stage_shards
from ..parallel.zero_bubble import make_zb_train_step, schedule_cost, \
    zb_schedule
from . import _common

N_STAGES, N_MICRO, MB, DIM = 4, 8, 4, 64
ITERS, LR = 20, 0.05


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _common.add_device_flag(ap)
    return ap.parse_args(argv)


def data():
    """The layers (numpy, 2 a stage), the targets and the inputs, from the
    JAX example's numpy stream."""
    rng = np.random.default_rng(0)
    layers = [{"w": (rng.standard_normal((DIM, DIM)) * 0.2).astype(np.float32),
               "b": np.zeros((DIM,), np.float32)}
              for _ in range(N_STAGES * 2)]
    targets = rng.standard_normal((N_MICRO, MB, DIM)).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, DIM)).astype(np.float32)
    return layers, targets, x


def stage_fn(sp, x):
    for j in range(sp["w"].shape[0]):
        x = torch.tanh(x @ sp["w"][j] + sp["b"][j])
    return x


def run(args) -> dict:
    """The schedule, its cost and the loop; returns the losses, the cost
    and ms/iteration."""
    dev = _common.device(args)
    sched = zb_schedule(N_STAGES, N_MICRO)
    names = {0: ".", 1: "F", 2: "B", 3: "W"}
    print("schedule (rows = stages, cols = ticks):")
    for d in range(N_STAGES):
        print("  " + "".join(names[int(o)] for o in sched[d]))
    cost = schedule_cost(N_STAGES, N_MICRO)
    print("cost:", cost)

    layers, targets, x = data()
    mesh = LocalMesh(axes={"pp": N_STAGES}, device=dev)
    params = stage_shards(stack_stages(
        [{k: torch.from_numpy(v).to(dev) for k, v in lay.items()}
         for lay in layers], N_STAGES), mesh)
    tgt = torch.from_numpy(targets).to(dev)

    def loss_fn(y, i):
        return torch.mean((y - tgt[i]) ** 2)

    step = make_zb_train_step(stage_fn, loss_fn, mesh, n_micro=N_MICRO)
    xs = torch.from_numpy(x).to(dev)
    losses = []
    t0 = _common.now(dev)
    for it in range(ITERS):
        loss, grads = step(params, xs)
        with torch.no_grad():
            for held, g in zip(params.local, grads):
                for k in held:
                    held[k].sub_(LR * g[k].to(held[k].dtype))
        losses.append(float(loss))
        if it % 5 == 0 or it == ITERS - 1:
            print(f"iter {it}: loss {losses[-1]:.4f}")
    dt = _common.now(dev) - t0
    print(f"{ITERS} iterations in {dt:.2f}s = {1e3 * dt / ITERS:.1f} "
          f"ms/iteration; {_common.card(dev)}")
    print("done (loss should decrease)")
    return {"losses": losses, "cost": cost, "seconds": dt}


def main(argv=None) -> dict:
    out = run(parse(argv))
    if not out["losses"][-1] < out["losses"][0]:
        raise SystemExit(f"the loss did not decrease: {out['losses']}")
    return out


if __name__ == "__main__":
    main()
