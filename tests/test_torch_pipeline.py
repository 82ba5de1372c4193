"""Port parity: parallel/pipeline.py and the named-axes mesh.

stack_stages / stack_stages_interleaved against the JAX package's; GPipe,
interleaved and remat pipelines over LocalMesh(pp = n) against JAX's
make_pipelined_forward / make_interleaved_pipeline on its virtual CPU
devices (outputs within 1e-5, the gradients of every stage's params and of
the input within 1e-4 of each leaf's largest entry); each stage chunk run
once a microbatch; and the mesh's named axes, shift and all_to_all against
jax.sharding.Mesh's numbering, lax.ppermute and the tiled lax.all_to_all.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

from kfunca_tpu.parallel import pipeline as jpipe
from kfunca_tpu_torch.parallel import collectives as cc
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.parallel import pipeline as tpipe

DIM, MB = 8, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _layers(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((DIM, DIM)) * 0.4).astype(np.float32),
             "b": (rng.standard_normal(DIM) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _jblock(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _tblock(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _torch_layers(layers):
    return [{k: torch.from_numpy(v) for k, v in lay.items()} for lay in layers]


def test_stacking_matches_jax():
    layers = _layers(8, seed=0)
    jl = [jax.tree_util.tree_map(jnp.asarray, lay) for lay in layers]
    tl = _torch_layers(layers)
    for got, want in ((tpipe.stack_stages(tl, 4), jpipe.stack_stages(jl, 4)),
                      (tpipe.stack_stages_interleaved(tl, 2, 2),
                       jpipe.stack_stages_interleaved(jl, 2, 2))):
        for key in ("w", "b"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    with pytest.raises(ValueError, match="do not split"):
        tpipe.stack_stages(tl[:3], 2)


CASES = [("gpipe", 2, 3, False), ("gpipe", 4, 4, False),
         ("gpipe", 4, 2, True), ("interleaved", 2, 3, False),
         ("interleaved", 4, 2, False), ("interleaved", 2, 4, True),
         # one device: the ring edge hands its own chunk c to chunk c + 1
         ("gpipe", 1, 2, False), ("interleaved", 1, 3, False),
         ("interleaved", 1, 2, True)]


@pytest.mark.parametrize("kind,n,m,remat", CASES)
def test_pipeline_matches_jax(kind, n, m, remat):
    """Outputs, the stage params' gradients and the input's gradient of
    sum(out * w), 2 layers a stage chunk."""
    v = 2 if kind == "interleaved" else 1
    layers = _layers(2 * n * v, seed=n + m)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, MB, DIM)).astype(np.float32)
    wt = rng.standard_normal((m, MB, DIM)).astype(np.float32)
    jl = [jax.tree_util.tree_map(jnp.asarray, lay) for lay in layers]
    jm = Mesh(np.asarray(jax.devices()[:n]), ("pp",))
    if v > 1:
        jst = jpipe.stack_stages_interleaved(jl, n, v)
        jf = jpipe.make_interleaved_pipeline(_jblock, jm, v=v, remat=remat)
    else:
        jst = jpipe.stack_stages(jl, n)
        jf = jpipe.make_pipelined_forward(_jblock, jm, remat=remat)
    with jm:
        jy = jax.jit(jf)(jst, x)
        jg = jax.jit(jax.grad(lambda s, xx: jnp.sum(jf(s, xx) * wt),
                              argnums=(0, 1)))(jst, x)
    mesh = tmesh.LocalMesh(axes={"pp": n}, device="cpu")
    tl = _torch_layers(layers)
    if v > 1:
        st = tpipe.stack_stages_interleaved(tl, n, v)
        f = tpipe.make_interleaved_pipeline(_tblock, mesh, v=v, remat=remat)
    else:
        st = tpipe.stack_stages(tl, n)
        f = tpipe.make_pipelined_forward(_tblock, mesh, remat=remat)
    sp = tpipe.stage_shards(st, mesh)
    trees = [{k: t.clone().requires_grad_(True) for k, t in tree.items()}
             for tree in sp.local]
    xt = torch.from_numpy(x).requires_grad_(True)
    ys = f(trees, xt)
    for y in ys:  # every pp rank holds the last stage's outputs
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   rtol=0, atol=1e-5)
    loss = sum((y * torch.from_numpy(wt)).sum() for y in ys)
    grads = torch.autograd.grad(
        loss, [t[k] for t in trees for k in ("b", "w")] + [xt])
    for j, key in enumerate(("b", "w")):
        got = torch.cat([grads[2 * i + j] for i in range(n)]).numpy()
        want = np.asarray(jg[0][key])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    want = np.asarray(jg[1])
    np.testing.assert_allclose(grads[-1].numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("v", [1, 2])
def test_each_stage_chunk_runs_once_a_microbatch(v):
    """The skipped ticks: n x v chunks x M applications (JAX's scan runs
    (M + v n - 1) x v a device); remat runs each once more backward."""
    n, m = 3, 4
    for remat in (False, True):
        calls = []

        def block(p, h):
            calls.append(1)
            return _tblock(p, h)

        mesh = tmesh.LocalMesh(axes={"pp": n}, device="cpu")
        tl = _torch_layers(_layers(n * v, seed=1))
        st = (tpipe.stack_stages_interleaved(tl, n, v) if v > 1
              else tpipe.stack_stages(tl, n))
        f = (tpipe.make_interleaved_pipeline(block, mesh, v=v, remat=remat)
             if v > 1 else tpipe.make_pipelined_forward(block, mesh,
                                                        remat=remat))
        trees = [{k: t.clone().requires_grad_(True) for k, t in tree.items()}
                 for tree in tpipe.stage_shards(st, mesh).local]
        ys = f(trees, torch.ones((m, MB, DIM)))
        assert len(calls) == n * v * m
        torch.autograd.grad(sum(y.sum() for y in ys), trees[0]["w"])
        assert len(calls) == n * v * m * (2 if remat else 1)


def test_a_list_of_copies_gets_the_gradient_on_every_rank():
    """Each pp rank's own copy of the input (a list) gets the whole
    gradient (collectives.copy), the one shared tensor gets it once."""
    n, m = 2, 2
    mesh = tmesh.LocalMesh(axes={"pp": n}, device="cpu")
    sp = tpipe.stage_shards(tpipe.stack_stages(
        _torch_layers(_layers(n, seed=2)), n), mesh)
    f = tpipe.make_pipelined_forward(_tblock, mesh)
    x = torch.randn((m, MB, DIM), generator=torch.Generator().manual_seed(0))
    shared = x.clone().requires_grad_(True)
    (g_shared,) = torch.autograd.grad(sum(y.sum() for y in f(sp, shared)),
                                      [shared])
    copies = [x.clone().requires_grad_(True) for _ in range(n)]
    gs = torch.autograd.grad(sum(y.sum() for y in f(sp, copies)), copies)
    for g in gs:
        torch.testing.assert_close(g, g_shared, rtol=0, atol=1e-6)


# -- the mesh's named axes ---------------------------------------------------


def test_named_axes_number_ranks_as_jax_meshes_do():
    sizes = {"dp": 2, "pp": 2, "tp": 2}
    mesh = tmesh.LocalMesh(axes=sizes, device="cpu")
    jm = Mesh(np.arange(8).reshape(2, 2, 2), tuple(sizes))
    for r in mesh.ranks:
        assert tuple(int(c) for c in np.argwhere(jm.devices == r)[0]) == \
            mesh.coord(r)
    for axis in sizes:
        k = tuple(sizes).index(axis)
        want = sorted(np.moveaxis(jm.devices, k, -1).reshape(-1, 2).tolist())
        assert sorted(mesh._groups(axis)) == want
        assert mesh.size(axis) == 2
    assert mesh.size("ep") == 1 and mesh.index(5, "ep") == 0
    assert (mesh.dp, mesh.tp) == (2, 2)
    subs = mesh.sub_meshes("pp")
    assert [(d, pos) for d, pos, _ in subs] == [(0, [0, 1, 4, 5]),
                                                (1, [2, 3, 6, 7])]
    assert subs[0][2].shape == {"dp": 2, "tp": 2}
    with pytest.raises(ValueError, match="not both"):
        tmesh.LocalMesh(2, 2, "cpu", axes={"pp": 2})
    assert tmesh.LocalMesh(2, 2, "cpu").shape == {"dp": 2, "tp": 2}


@pytest.mark.parametrize("offset", [1, -1])
def test_shift_is_jax_ppermute(offset):
    """cyclic shift over ("pp",) = 4 against lax.ppermute with the same
    permutation, and the non-cyclic form (zeros where no rank sends); both
    differentiable, the backward the shift the other way."""
    n = 4
    x = np.random.default_rng(0).standard_normal((n, 3, 5)).astype(np.float32)
    jm = Mesh(np.asarray(jax.devices()[:n]), ("pp",))
    for cyclic in (True, False):
        perm = [(i, (i + offset) % n) for i in range(n)
                if cyclic or 0 <= i + offset < n]
        fn = jax.shard_map(partial(jax.lax.ppermute, axis_name="pp",
                                   perm=perm), mesh=jm, in_specs=JP("pp"),
                           out_specs=JP("pp"), check_vma=False)
        with jm:
            want = np.asarray(jax.jit(fn)(x.reshape(n * 3, 5))).reshape(
                n, 3, 5)
        mesh = tmesh.LocalMesh(axes={"pp": n}, device="cpu")
        xs = [torch.from_numpy(x[i]).requires_grad_(True) for i in range(n)]
        ys = cc.shift(xs, mesh, "pp", offset, cyclic)
        for i in range(n):
            np.testing.assert_array_equal(ys[i].detach().numpy(), want[i])
        w = [torch.full((3, 5), float(i + 1)) for i in range(n)]
        gs = torch.autograd.grad(sum((y * wi).sum() for y, wi in zip(ys, w)),
                                 xs)
        back = cc.shift(w, mesh, "pp", -offset, cyclic)
        for g, b in zip(gs, back):
            assert torch.equal(g, b)


def test_all_to_all_is_jax_tiled_all_to_all():
    n = 4
    x = np.random.default_rng(1).standard_normal((n, 8, 3, 2)).astype(
        np.float32)
    jm = Mesh(np.asarray(jax.devices()[:n]), ("ep",))
    fn = jax.shard_map(partial(jax.lax.all_to_all, axis_name="ep",
                               split_axis=0, concat_axis=1, tiled=True),
                       mesh=jm, in_specs=JP("ep"), out_specs=JP("ep"),
                       check_vma=False)
    with jm:
        want = np.asarray(jax.jit(fn)(x.reshape(n * 8, 3, 2)))
    mesh = tmesh.LocalMesh(axes={"ep": n}, device="cpu")
    xs = [torch.from_numpy(x[i]).requires_grad_(True) for i in range(n)]
    ys = cc.all_to_all(xs, mesh, "ep", split_dim=0, concat_dim=1)
    assert ys[0].shape == (2, 12, 2)
    np.testing.assert_array_equal(torch.cat(ys).detach().numpy(), want)
    # the backward is the all_to_all with the dimensions swapped: the
    # gradient of sum(y * y) / 2 is x itself
    gs = torch.autograd.grad(sum((y * y).sum() / 2 for y in ys), xs)
    for g, xi in zip(gs, xs):
        assert torch.equal(g, xi.detach())


def test_a_mesh_with_its_axes_in_another_order_trains_alike():
    """The sharded step and the forward read each rank's dp and tp index
    by axis name: a LocalMesh of axes ("tp", "dp") gives the (dp, tp)
    mesh's loss, logits and params bit for bit (the same sums in the same
    order)."""
    from kfunca_tpu_torch.models import train as ttr
    from kfunca_tpu_torch.models import transformer as ttf
    from kfunca_tpu_torch.utils.tree import tree_leaves

    tc = ttf.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=96,
                               max_seq_len=32, dtype="float32")
    oc = ttr.OptConfig(algo="sgd", lr=1e-2)
    params = ttf.init_params(0, tc, device="cpu")
    win = np.random.default_rng(3).integers(0, 128, (4, 17))
    out = []
    for mesh in (tmesh.LocalMesh(2, 2, "cpu"),
                 tmesh.LocalMesh(axes={"tp": 2, "dp": 2}, device="cpu")):
        sp = tmesh.shard_params(params, mesh, cfg=tc)
        step = ttr.make_sharded_train_step(tc, mesh, oc, grad_accum=2)
        sp, _, loss = step(sp, ttr.init_opt_state(sp, oc), win[:, :-1],
                           win[:, 1:])
        logits = ttf.forward(sp, torch.from_numpy(win[:, :-1]), tc)
        out.append((float(loss), logits,
                    tree_leaves(tmesh.gather_params(sp))))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)
