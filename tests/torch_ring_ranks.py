"""One rank of ring attention over a torch.distributed gloo group.

`tests/test_torch_ring_attention.py` spawns `run_rank` in four processes.
A spawned child imports this module by name, so it imports only torch,
numpy and the port: no JAX, and not the tests' conftest.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from kfunca_tpu_torch.parallel.ring_attention import make_ring_attention


def run_rank(rank, world, init_file, inputs, out_dir, backend="gloo",
             dtype="float32"):
    """Forward and `sum(sin(.))` gradients of this rank's shards through
    make_ring_attention over a `cp` DeviceMesh, the fp32 inputs cast to
    `dtype`; writes rank<r>.npz (in fp32).  backend "gloo" runs on the CPU,
    "nccl" on card `rank`."""
    torch.set_num_threads(1)
    device = "cpu"
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(torch.device(device).type, (world,),
                                mesh_dim_names=("cp",))
        ring = make_ring_attention(mesh, cp_axis="cp")
        arrays = np.load(inputs)
        s = arrays["q"].shape[2] // world

        def shard(name):
            x = torch.from_numpy(arrays[name][:, :, rank * s:(rank + 1) * s]
                                 .copy())
            return x.to(device, getattr(torch, dtype)).requires_grad_(True)

        q, k, v = (shard(n) for n in ("q", "k", "v"))
        out = ring(q, k, v)
        grads = torch.autograd.grad(torch.sin(out.float()).sum(), (q, k, v))
        host = lambda t: t.detach().float().cpu().numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", out=host(out),
                 dq=host(grads[0]), dk=host(grads[1]), dv=host(grads[2]))
    finally:
        dist.destroy_process_group()
