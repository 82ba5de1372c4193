"""Port parity: parallel/zero_bubble.py.

The ZB-H1 and ZB-V op tables, their audits and costs against the JAX
package's bit for bit; the ZB-H1 and ZB-V steps (loss and every stage's
gradient, sums over microbatches) over LocalMesh(pp = n) against JAX's
make_zb_train_step / make_zbv_train_step on its virtual CPU devices, fp32
within 1e-5 of the loss and 1e-4 of each leaf's largest gradient entry;
and the ZB-H1 gradients against autograd through the sequential stack.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from kfunca_tpu.parallel import pipeline as jpipe
from kfunca_tpu.parallel import zero_bubble as jzb
from kfunca_tpu_torch.models.weights import stacked_params_from_jax
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.parallel import pipeline as tpipe
from kfunca_tpu_torch.parallel import zero_bubble as tzb

DIM, MB = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8])
@pytest.mark.parametrize("n_stages", [2, 3, 4, 8])
def test_schedule_tables_equal_jax_bit_for_bit(n_stages, n_micro):
    zb = tzb.zb_schedule(n_stages, n_micro)
    zbv = tzb.zbv_schedule(n_stages, n_micro)
    want_zb = jzb.zb_schedule(n_stages, n_micro)
    want_zbv = jzb.zbv_schedule(n_stages, n_micro)
    assert zb.dtype == want_zb.dtype and np.array_equal(zb, want_zb)
    assert zbv.dtype == want_zbv.dtype and np.array_equal(zbv, want_zbv)
    tzb.validate_schedule(zb, n_micro)
    tzb.validate_zbv_schedule(zbv, n_micro)
    assert tzb.schedule_cost(n_stages, n_micro) == jzb.schedule_cost(
        n_stages, n_micro)
    assert tzb.zbv_schedule_cost(n_stages, n_micro) == jzb.zbv_schedule_cost(
        n_stages, n_micro)


def test_the_audits_refuse_a_broken_table():
    sched = tzb.zb_schedule(4, 4).copy()
    first_b = int(np.argmax(sched[3] == tzb.OP_B))
    sched[3, first_b] = tzb.IDLE
    with pytest.raises(AssertionError):
        tzb.validate_schedule(sched, 4)
    v = tzb.zbv_schedule(3, 2).copy()
    v[:, [0, 1]] = v[:, [1, 0]]
    with pytest.raises(AssertionError):
        tzb.validate_zbv_schedule(v, 2)
    with pytest.raises(ValueError, match="n_micro"):
        tzb.make_zb_train_step(lambda p, x: x, lambda y, i: y.sum(),
                               tmesh.LocalMesh(axes={"pp": 2}, device="cpu"))


def _layers(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((DIM, DIM)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal(DIM) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _data(m, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, MB, DIM)).astype(np.float32),
            rng.standard_normal((m, MB, DIM)).astype(np.float32))


def _jstage(sp, x):
    h, _ = jax.lax.scan(lambda c, lp: (jnp.tanh(c @ lp["w"] + lp["b"]), None),
                        x, sp)
    return h


def _tstage(sp, x):
    for j in range(sp["w"].shape[0]):
        x = torch.tanh(x @ sp["w"][j] + sp["b"][j])
    return x


def _jloss(tgt):
    return lambda y, i: jnp.sum((y - jax.lax.dynamic_index_in_dim(
        jnp.asarray(tgt), i, 0, keepdims=False)) ** 2)


def _tloss(tgt):
    t = torch.from_numpy(tgt)
    return lambda y, i: ((y - t[i]) ** 2).sum()


def _to_torch(layers):
    return [{k: torch.from_numpy(v) for k, v in lay.items()} for lay in layers]


def _check(loss, grads, jl, jg, key_axis=0):
    """The loss within 1e-5 (relative) and each leaf's gradient, the held
    ranks' pieces joined along the stage axis, within 1e-4 of its largest
    entry."""
    assert abs(float(loss) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    for key in ("w", "b"):
        got = torch.cat([g[key] for g in grads], dim=key_axis).numpy()
        want = np.asarray(jg[key])
        assert got.shape == want.shape
        tol = 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=key)


@pytest.mark.parametrize("n,m,per", [(4, 4, 1), (2, 3, 2), (3, 5, 1)])
def test_zb_step_matches_jax(n, m, per):
    layers = _layers(n * per, seed=n + m)
    x, tgt = _data(m, seed=m)
    jm = Mesh(np.asarray(jax.devices()[:n]), ("pp",))
    jstacked = jpipe.stack_stages(
        [jax.tree_util.tree_map(jnp.asarray, lay) for lay in layers], n)
    with jm:
        jl, jg = jax.jit(jzb.make_zb_train_step(
            _jstage, _jloss(tgt), jm, n_micro=m))(jstacked, jnp.asarray(x))
    mesh = tmesh.LocalMesh(axes={"pp": n}, device="cpu")
    # JAX's own stacked tree carried across
    sp = tpipe.stage_shards(stacked_params_from_jax(jstacked, "cpu"), mesh)
    loss, grads = tzb.make_zb_train_step(_tstage, _tloss(tgt), mesh,
                                         n_micro=m)(sp, torch.from_numpy(x))
    assert [tuple(g["w"].shape) for g in grads] == [(1, per, DIM, DIM)] * n
    _check(loss, grads, jl, jg)


def _vstage_j(sp, x):
    return jnp.tanh(x @ sp["w"] + sp["b"])


def _vstage_t(sp, x):
    return torch.tanh(x @ sp["w"] + sp["b"])


@pytest.mark.parametrize("n,m", [(4, 4), (2, 2), (3, 5)])
def test_zbv_step_matches_jax(n, m):
    layers = _layers(2 * n, seed=10 + n)
    x, tgt = _data(m, seed=20 + m)
    jm = Mesh(np.asarray(jax.devices()[:n]), ("pp",))
    jstacked = jzb.stack_stages_v(
        [jax.tree_util.tree_map(jnp.asarray, lay) for lay in layers], n)
    with jm:
        jl, jg = jax.jit(jzb.make_zbv_train_step(
            _vstage_j, _jloss(tgt), jm, n_micro=m))(jstacked, jnp.asarray(x))
    mesh = tmesh.LocalMesh(axes={"pp": n}, device="cpu")
    stacked = tzb.stack_stages_v(_to_torch(layers), n)
    np.testing.assert_array_equal(stacked["w"].numpy(), np.asarray(
        jstacked["w"]))
    sp = tpipe.stage_shards(stacked, mesh)
    loss, grads = tzb.make_zbv_train_step(_vstage_t, _tloss(tgt), mesh,
                                          n_micro=m)(sp, torch.from_numpy(x))
    assert [tuple(g["w"].shape) for g in grads] == [(1, 2, DIM, DIM)] * n
    _check(loss, grads, jl, jg)


def test_zb_gradients_are_autograd_of_the_sequential_stack():
    """ZB-H1 over 4 stages of 2 layers: the sums over microbatches of the
    gradients of the layers applied in order (autograd, one device)."""
    n, m = 4, 4
    layers = _to_torch(_layers(2 * n, seed=3))
    x, tgt = _data(m, seed=4)
    mesh = tmesh.LocalMesh(axes={"pp": n}, device="cpu")
    sp = tpipe.stage_shards(tpipe.stack_stages(layers, n), mesh)
    loss, grads = tzb.make_zb_train_step(_tstage, _tloss(tgt), mesh,
                                         n_micro=m)(sp, torch.from_numpy(x))
    leaves = [{k: v.clone().requires_grad_(True) for k, v in lay.items()}
              for lay in layers]
    h = torch.from_numpy(x)
    for lay in leaves:
        h = torch.tanh(h @ lay["w"] + lay["b"])
    want_loss = ((h - torch.from_numpy(tgt)) ** 2).sum()
    want = torch.autograd.grad(want_loss, [lay["w"] for lay in leaves])
    want_loss = float(want_loss.detach())
    assert abs(float(loss) - want_loss) <= 1e-5 * want_loss
    got = torch.cat([g["w"][0] for g in grads])
    tol = 1e-4 * float(torch.stack(want).abs().max())
    torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=tol)


def test_zb_step_runs_each_op_once_a_microbatch():
    """F once, B and W each re-run the stage: 3 x stages x M stage calls."""
    n, m = 3, 4
    calls = []

    def stage(sp, x):
        calls.append(1)
        return _tstage(sp, x)

    mesh = tmesh.LocalMesh(axes={"pp": n}, device="cpu")
    layers = _to_torch(_layers(n, seed=5))
    x, tgt = _data(m, seed=6)
    sp = tpipe.stage_shards(tpipe.stack_stages(layers, n), mesh)
    tzb.make_zb_train_step(stage, _tloss(tgt), mesh, n_micro=m)(
        sp, torch.from_numpy(x))
    assert len(calls) == 3 * n * m
    calls.clear()
    spv = tpipe.stage_shards(tzb.stack_stages_v(_to_torch(_layers(2 * n, 7)),
                                                n), mesh)
    tzb.make_zbv_train_step(lambda p, h: (calls.append(1), _vstage_t(p, h))[1],
                            _tloss(tgt), mesh, n_micro=m)(
        spv, torch.from_numpy(x))
    assert len(calls) == 3 * 2 * n * m
