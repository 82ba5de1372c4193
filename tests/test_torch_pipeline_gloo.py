"""The pipeline, zero-bubble and expert-parallel paths over a 4-process gloo
group against the same paths over a LocalMesh in one process.

One spawn for the module (tests/torch_pipeline_ranks.py): shift and
all_to_all (raw and differentiable), a ZB-H1 and a ZB-V step and a GPipe
forward and backward over ("pp",) = 4, an expert-parallel forward and its
gradients over ("ep",) = 4, and a pipeline_lm SGD step over (dp 1, pp 2,
tp 2).  Collectives and the ZB steps are bit for bit the LocalMesh's; the
paths whose all-reduces add more than two nonzero terms (gloo adds them in
another order) hold 1e-6 of each array's largest entry.
"""

import time

import numpy as np
import pytest
import torch

import torch_pipeline_ranks as ranks

EXACT = ("collectives", "zb")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_pipeline")
    ctx = torch.multiprocessing.start_processes(
        ranks.run_rank, args=(ranks.N, str(tmp / "store"), str(tmp)),
        nprocs=ranks.N, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish in 300 s")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(ranks.N)]


@pytest.mark.parametrize("task", list(ranks.tasks(ranks.N)))
def test_group_mesh_gives_the_local_mesh_results(gloo, task):
    local = ranks.local_results(task)
    for r in range(ranks.N):
        got = {k.split(".", 1)[1]: v for k, v in gloo[r].items()
               if k.startswith(task + ".")}
        assert sorted(got) == sorted(local[r])
        for key, want in local[r].items():
            if task in EXACT:
                np.testing.assert_array_equal(got[key], want,
                                              err_msg=f"rank {r} {key}")
            else:
                tol = 1e-6 * max(1.0, float(np.abs(want).max()))
                np.testing.assert_allclose(got[key], want, rtol=0, atol=tol,
                                           err_msg=f"rank {r} {key}")
