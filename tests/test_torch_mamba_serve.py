"""Port parity: the Mamba continuous-batching server (models/mamba_serve.py).

Shared weights (the JAX init_mamba_params, carried across).  Greedy tokens
equal the JAX MambaServer's, request for request, with mixed prompt lengths
(several pow2 buckets), more requests than slots and eos; the bucketed
prefill's state is the unpadded prompt's (its first token is the argmax of
a full forward).  Sampling draws from torch's generator, not jax.random's,
so sampled requests are held to reproducibility under one seed and to the
softmax distribution.  fp32.
"""

import numpy as np
import pytest
import torch

import jax

from kfunca_tpu.models import mamba as jm
from kfunca_tpu.models.mamba_serve import MambaServer as JaxServer
from kfunca_tpu_torch.models import mamba as tm
from kfunca_tpu_torch.models.mamba_serve import MambaServer
from kfunca_tpu_torch.models.weights import mamba_params_from_jax

SMALL = dict(vocab_size=96, d_model=32, n_layers=2, d_state=8, dt_rank=4,
             dtype="float32")
PROMPTS = [[5, 9, 11], [7, 3, 2, 8, 30, 12, 4], [44, 2], [60, 61, 62, 63, 1],
           [8]]


@pytest.fixture(scope="module")
def model():
    jc = jm.MambaConfig(**SMALL)
    jp = jm.init_mamba_params(jax.random.PRNGKey(0), jc)
    tc = tm.MambaConfig(**SMALL)
    return jc, jp, tc, mamba_params_from_jax(jp, tc, device="cpu")


@pytest.fixture(scope="module")
def jax_run(model):
    """The JAX server's greedy tokens on PROMPTS, 2 slots, 6 new tokens,
    and the token to use as eos in the eos test (with its run)."""
    jc, jp, _, _ = model
    srv = JaxServer(jp, jc, batch_slots=2)
    rids = [srv.submit(p, max_new=6) for p in PROMPTS]
    out = srv.run()
    free = [out[r] for r in rids]
    eos = free[1][2]
    srv = JaxServer(jp, jc, batch_slots=2, eos_token=eos)
    rids = [srv.submit(p, max_new=6) for p in PROMPTS]
    out = srv.run()
    return free, eos, [out[r] for r in rids]


def test_greedy_tokens_equal_the_jax_server(model, jax_run):
    _, _, tc, tp = model
    srv = MambaServer(tp, tc, batch_slots=2)
    rids = [srv.submit(p, max_new=6) for p in PROMPTS]
    out = srv.run()
    assert sorted(out) == sorted(rids)
    assert [out[r] for r in rids] == jax_run[0]


def test_eos_stops_as_the_jax_server_does(model, jax_run):
    _, _, tc, tp = model
    _, eos, want = jax_run
    srv = MambaServer(tp, tc, batch_slots=2, eos_token=eos)
    rids = [srv.submit(p, max_new=6) for p in PROMPTS]
    out = srv.run()
    got = [out[r] for r in rids]
    assert got == want
    assert any(len(g) < 6 and g[-1] == eos for g in got)


def test_server_tokens_equal_generate(model):
    """More requests than slots; each equals the port's generate()."""
    _, _, tc, tp = model
    srv = MambaServer(tp, tc, batch_slots=2)
    rids = [srv.submit(p, max_new=5) for p in PROMPTS]
    out = srv.run()
    for rid, p in zip(rids, PROMPTS):
        want = tm.generate(tp, torch.tensor([p]), tc, max_new_tokens=5)[0]
        assert out[rid] == want.tolist(), p


def test_bucketed_prefill_is_exact(model):
    """A prompt of 5 pads to a bucket of 8: the prefill's logits and state
    are those of the unpadded prompt's forward and recurrence."""
    _, _, tc, tp = model
    prompt = [9, 4, 17, 2, 30]
    srv = MambaServer(tp, tc, batch_slots=1)
    padded = torch.zeros((1, 8), dtype=torch.int64)
    padded[0, :5] = torch.tensor(prompt)
    logits, states = srv._prefill_fn(8)(tp, padded, 5)
    full = tm.forward(tp, torch.tensor([prompt]), tc)[0, -1]
    torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)
    want = tm.init_mamba_state(tc, 1, "cpu")
    for t in prompt:
        _, want = tm._token_step(tp, torch.tensor([t]), want, tc)
    for got_l, want_l in zip(states, want):
        assert torch.equal(got_l["ssm"], want_l["ssm"])
        assert torch.equal(got_l["conv"], want_l["conv"])
    rid = srv.submit(prompt, max_new=1)
    assert srv.run()[rid] == [int(torch.argmax(full))]


def test_sampled_requests_reproduce_and_greedy_ones_stay_exact(model):
    _, _, tc, tp = model

    def run(seed):
        srv = MambaServer(tp, tc, batch_slots=2, seed=seed)
        rs = srv.submit([5, 9, 11], max_new=6, temperature=1.0)
        rg = srv.submit([7, 3, 2, 8], max_new=6)
        out = srv.run()
        return out[rs], out[rg]

    s1, g1 = run(0)
    s2, g2 = run(0)
    s3, _ = run(1)
    assert s1 == s2 and g1 == g2
    assert s1 != s3
    want = tm.generate(tp, torch.tensor([[7, 3, 2, 8]]), tc, max_new_tokens=6)
    assert g1 == want[0].tolist()


def test_sampling_follows_the_softmax(model):
    """20,000 draws of one slot at temperature 0.7: every token's share is
    within 0.015 of softmax(logits / 0.7); a temperature-0 slot in the same
    batch always takes the argmax."""
    _, _, tc, tp = model
    srv = MambaServer(tp, tc, batch_slots=2, seed=3)
    logits = torch.from_numpy(
        np.random.default_rng(0).normal(size=(1, 12)).astype(np.float32))
    n = 20_000
    batch = logits.expand(n, -1)
    temps = torch.full((n,), 0.7)
    draws = srv._sample(batch, temps)
    freq = torch.bincount(draws.long(), minlength=12).float() / n
    want = torch.softmax(logits[0] / 0.7, dim=-1)
    assert float((freq - want).abs().max()) < 0.015
    mixed = srv._sample(torch.cat([logits, logits]), torch.tensor([0.0, 1.0]))
    assert int(mixed[0]) == int(torch.argmax(logits))
