"""Port parity: knowledge distillation (kfunca_tpu_torch/models/distill.py).

The same numpy activations and heads, and the same weights of a teacher
and a narrower, shallower student (JAX init_params carried across), go
through both packages in fp32 on the CPU: chunked_kd_kl's value and
student gradients with vocab % chunk != 0 and tau != 1 (the partial last
chunk's padded columns masked, not -inf minus -inf), the same KL from full
logits, distill_loss, and two steps of make_distill_step.  Values within
1e-5, gradients and params within 1e-4 of max(1, max |ref|).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import distill as jds
from kfunca_tpu.models import train as jtr
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import distill as tds
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import (
    opt_state_from_jax, params_from_jax, tree_to_numpy)

TEACHER = dict(vocab_size=120, d_model=64, n_heads=4, n_kv_heads=2,
               n_layers=2, d_ff=96, max_seq_len=32, dtype="float32")
STUDENT = dict(TEACHER, d_model=32, n_heads=2, n_kv_heads=1, n_layers=1,
               d_ff=64)
CHUNK = 48  # 120 = 2 x 48 + 24
TAU = 2.0
TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _models():
    out = []
    for kw, seed in ((TEACHER, 0), (STUDENT, 1)):
        jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
        jp = jtf.init_params(jax.random.PRNGKey(seed), jc)
        out.append((jc, jp, tc, params_from_jax(jp, tc, device="cpu")))
    return out


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _heads(n=24, ds=32, dt=64, v=120, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, s, shape).astype(np.float32) for s, shape in
            ((1.0, (n, ds)), (0.3, (ds, v)), (1.0, (n, dt)), (0.3, (dt, v)))]


def _batch(seed=0, b=2, s=12):
    w = np.random.default_rng(seed).integers(0, 120, (b, s + 1)).astype(
        np.int32)
    tgt = w[:, 1:].copy()
    tgt[:, :3] = -100
    return w[:, :-1], tgt


@pytest.mark.parametrize("tau", [TAU, 1.0])
def test_chunked_kd_kl_value_and_gradients_match_jax(tau):
    x_s, w_s, x_t, w_t = _heads()
    g = np.random.default_rng(9).normal(0, 1, x_s.shape[0]).astype(
        np.float32)

    def jf(xs, ws, xt, wt):
        kl = jds.chunked_kd_kl(xs, ws, xt, wt, CHUNK, tau)
        return jnp.sum(kl * g), kl

    (_, want), wg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (x_s, w_s, x_t, w_t)))
    ts = [torch.tensor(a, requires_grad=True) for a in (x_s, w_s, x_t, w_t)]
    kl = tds.chunked_kd_kl(*ts, CHUNK, tau)
    _close(kl, want, LOSS_TOL)
    assert torch.isfinite(kl).all() and (kl >= -1e-6).all()
    (kl * torch.as_tensor(g)).sum().backward()
    _close(ts[0].grad, wg[0])
    _close(ts[1].grad, wg[1])
    assert not np.asarray(wg[2]).any()  # the JAX teacher cotangent: zeros
    assert ts[2].grad is None and ts[3].grad is None


def test_chunked_kd_kl_is_the_kl_of_full_logits():
    """The streamed KL and its student gradients against the KL of the
    full tempered distributions, one head chunk or three."""
    x_s, w_s, x_t, w_t = map(torch.as_tensor, _heads(seed=4))
    xs = x_s.clone().requires_grad_(True)
    want = torch.nn.functional.kl_div(
        torch.log_softmax(xs @ w_s / TAU, -1),
        torch.log_softmax(x_t @ w_t / TAU, -1), log_target=True,
        reduction="none").sum(-1)
    want.sum().backward()
    for chunk in (CHUNK, 128):
        x2 = x_s.clone().requires_grad_(True)
        got = tds.chunked_kd_kl(x2, w_s, x_t, w_t, chunk, TAU)
        _close(got, want.detach().numpy(), LOSS_TOL)
        got.sum().backward()
        _close(x2.grad, xs.grad.numpy())


def test_distill_loss_matches_jax():
    (tjc, tjp, ttc, ttp), (sjc, sjp, stc, stp) = _models()
    tokens, targets = _batch()
    want, wm = jax.jit(functools.partial(
        jds.distill_loss, s_cfg=sjc, t_cfg=tjc, alpha=0.3, tau=TAU,
        vocab_chunk=CHUNK))(sjp, tjp, jnp.asarray(tokens),
                            jnp.asarray(targets))
    got, gm = tds.distill_loss(stp, ttp, torch.as_tensor(tokens),
                               torch.as_tensor(targets), stc, ttc, alpha=0.3,
                               tau=TAU, vocab_chunk=CHUNK)
    _close(got, want, LOSS_TOL)
    for k in ("kd", "ce"):
        _close(gm[k], wm[k], LOSS_TOL)


def test_distill_steps_match_jax():
    (tjc, tjp, ttc, ttp), (sjc, sjp, stc, _) = _models()
    oc = dict(lr=1e-3)
    jst = jtr.init_opt_state(sjp, jtr.OptConfig(**oc))
    tst = opt_state_from_jax(jst, device="cpu")
    tparams = params_from_jax(sjp, stc, device="cpu")
    jstep = jax.jit(jds.make_distill_step(tjp, tjc, sjc, jtr.OptConfig(**oc),
                                          tau=TAU, vocab_chunk=CHUNK))
    tstep = tds.make_distill_step(ttp, ttc, stc, ttr.OptConfig(**oc),
                                  tau=TAU, vocab_chunk=CHUNK, device="cpu")
    jparams = sjp
    before = [t.clone() for t in jax.tree_util.tree_leaves(ttp)]
    for i in range(2):
        tokens, targets = _batch(seed=i)
        jparams, jst, jm = jstep(jparams, jst, jnp.asarray(tokens),
                                 jnp.asarray(targets))
        tparams, tst, tm = tstep(tparams, tst, tokens, targets)
        for k in jm:
            _close(tm[k], jm[k], LOSS_TOL)
    for g, w in zip(jax.tree_util.tree_leaves(tree_to_numpy(tparams)),
                    jax.tree_util.tree_leaves(jparams)):
        _close(g, w)
    assert all(torch.equal(a, b) for a, b in  # the teacher does not move
               zip(jax.tree_util.tree_leaves(ttp), before))
