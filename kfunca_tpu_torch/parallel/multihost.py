"""Multi-process scale-out glue over torch.distributed.

Counterpart of kfunca_tpu/parallel/multihost.py.  The JAX package drives
jax.distributed: each host its local chips, tp packed inside a host, dp
across hosts.  Here a process drives one card (or one CPU rank under gloo):
`initialize` starts the process group, `make_multihost_mesh` lays a (dp, tp)
DeviceMesh with tp inside one host's LOCAL_WORLD_SIZE processes, and each
process loads its own stripe of the batch.  Everything degrades to a no-op
in a single process, where the mesh is a LocalMesh:

    from kfunca_tpu_torch.parallel import multihost
    multihost.initialize()                    # no-op in a single process
    mesh = multihost.make_multihost_mesh()    # dp across hosts, tp in one
    batch = multihost.global_batch_from_local(local_batch, mesh)

Launch one process a card with torchrun (`torchrun --nproc-per-node N
script.py`), which sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_WORLD_SIZE; the JAX names JAX_COORDINATOR_ADDRESS ("host:port") and
JAX_NUM_PROCESSES are read too.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as meshlib


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_process_count() -> int:
    """Processes on this host (torchrun's LOCAL_WORLD_SIZE), at least 1."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Start the process group for a multi-process run; returns whether one
    is active afterwards.  Safe to call unconditionally: with no
    coordinator and one process it is a no-op, and once the group is up it
    does nothing.  Arguments fall back to the environment: the coordinator
    from JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS or MASTER_ADDR and
    MASTER_PORT, the count from JAX_NUM_PROCESSES or WORLD_SIZE, the rank
    from RANK.  NCCL when this process sees a CUDA card, gloo otherwise;
    the card is LOCAL_RANK's."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (env.get("JAX_COORDINATOR_ADDRESS")
                               or env.get("COORDINATOR_ADDRESS"))
        if coordinator_address is None and env.get("MASTER_ADDR"):
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        n = env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if coordinator_address is None and num_processes in (None, 1):
        return False  # single process: nothing to coordinate
    if coordinator_address is None or num_processes is None:
        raise ValueError("a multi-process run needs a coordinator address "
                         "and a process count")
    if process_id is None:
        process_id = int(env.get("RANK", env.get("JAX_PROCESS_ID", "0")))
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def make_multihost_mesh(dp: int | None = None, tp: int | None = None, *,
                        device=None):
    """(dp, tp) mesh over all processes: tp packed inside one host's
    processes, dp across hosts.  Single process: parallel.mesh.make_mesh
    (a LocalMesh on `device`).  A tp that does not pack into one host's
    processes is refused, as in the JAX package: its per-product
    collectives would cross the slow network."""
    nproc = process_count()
    if nproc == 1:
        return meshlib.make_mesh(dp=dp, tp=tp, device=device)
    n_local = local_process_count()
    if dp is None or tp is None:
        dp, tp = meshlib.factor_mesh(nproc)
        tp = min(tp, n_local)
        dp = nproc // tp
    if tp > n_local or n_local % tp:
        raise ValueError(
            f"tp={tp} does not pack into one host's {n_local} local devices"
            " — tensor-parallel collectives must stay inside a host")
    # torchrun numbers processes host-major, so consecutive ranks (one tp
    # group) share a host and dp strides across hosts
    return meshlib.make_mesh(nproc, dp=dp, tp=tp)


def process_batch_info(global_batch: int, mesh) -> tuple[int, int]:
    """(start, size) of the global batch this process loads: one
    contiguous stripe a process (the batch is sharded over dp, and dp is
    laid host-major)."""
    nproc = process_count()
    if global_batch % nproc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{nproc} processes")
    size = global_batch // nproc
    return process_index() * size, size


def global_batch_from_local(local_batch, mesh, spec=None):
    """This process's batch on the mesh's device, sharded over dp
    (batch_spec): under a LocalMesh the list of the dp stripes of the
    (global) batch; under a DeviceMesh this process's stripe of a dp group,
    as rank_batches takes it.  Only the leading (batch) axis may be
    sharded, and only over dp."""
    spec = meshlib.batch_spec() if spec is None else tuple(spec)
    if tuple(spec)[:1] != ("dp",) or any(a is not None
                                          for a in tuple(spec)[1:]):
        raise ValueError(f"batch spec {spec}: only the leading axis over dp")
    mesh = meshlib.as_mesh(mesh)
    x = torch.as_tensor(np.asarray(local_batch)).to(mesh.device)
    if isinstance(mesh, meshlib.LocalMesh):
        if x.shape[0] % mesh.dp:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"dp = {mesh.dp}")
        return list(x.chunk(mesh.dp))
    # process_batch_info gives each process B / nproc rows; the tp
    # processes of dp group d (ranks d*tp .. d*tp + tp - 1) loaded the
    # consecutive stripes that make up dp stripe d, so it is their
    # all-gather along the batch
    if mesh.tp > 1:
        x = mesh.collective("gather", [x], "tp", 0)[0]
    return x
