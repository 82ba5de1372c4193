"""Port parity: the paged-KV serving engine of kfunca_tpu_torch.

The JAX InferenceServer and the port's InferenceServer(device="cpu") serve
the same requests with the same weights (the JAX init_params carried
across by models/weights.params_from_jax).  Greedy decoding is compared
token for token, log-probs within LP_ATOL, and the schedulers event for
event: the same (request, token, finished) stream and the same number of
free pages after every step.  torch.Generator and jax.random draw
different numbers, so sampled decoding is checked by its distribution and
by determinism for a fixed generator, never against the JAX tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import serve as jserve
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import serve as tserve
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax

# vocab 256, d_model 256, 4 heads over 2 kv heads of 64: kv_heads*hd = 128,
# so both engines pick the fused [k|v] pool
SMALL = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=512, max_seq_len=256, dtype="float32")
# 2 slots for 5 requests: admission waits on finished requests
SERVER = dict(batch_slots=2, page_size=8, n_pages=40, max_pages_per_seq=10)
LENGTHS = (5, 17, 30, 9, 40)
MAX_NEW = 12
# fp32 logits of two layers summed in another order: the log-probs agree
# to ~1e-6 (measured); 1e-4 leaves room and still catches a wrong
# position, mask or page (those move a log-prob by tenths)
LP_ATOL = 1e-4


def _drive(srv, prompts, **submit_kw):
    """Submit every prompt, stream to the end; returns (request ids,
    events, log-probs).  An event is (request, token, finished, free
    pages, which table entries point at the trash page) at its yield."""
    rids = [srv.submit(p, max_new=MAX_NEW, **submit_kw) for p in prompts]
    events, lps = [], []
    for rid, tok, lp, last in srv.stream():
        trash = (srv.page_tables == srv.trash_page).tobytes()
        events.append((rid, int(tok), bool(last), srv.pool.available, trash))
        lps.append(lp)
    return rids, events, np.asarray(lps)


@pytest.fixture(scope="module", params=[None, 12], ids=["full", "window12"])
def served(request):
    """The JAX server's greedy run on shared weights, per window."""
    kw = dict(SMALL, attention_window=request.param)
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in LENGTHS]
    jsrv = jserve.InferenceServer(jp, jc, **SERVER)
    rids, events, lps = _drive(jsrv, prompts)
    return dict(tc=tc, tp=params_from_jax(jp, tc, device="cpu"),
                prompts=prompts, rids=rids, events=events, lps=lps,
                tokens=[jsrv.requests[r].tokens for r in rids])


def _port(served, **kw):
    return tserve.InferenceServer(served["tp"], served["tc"], device="cpu",
                                  **{**SERVER, **kw})


def test_greedy_stream_matches_jax_server(served):
    srv = _port(served)
    rids, events, lps = _drive(srv, served["prompts"])
    assert rids == served["rids"]
    assert events == served["events"]
    np.testing.assert_allclose(lps, served["lps"], atol=LP_ATOL, rtol=0)
    stats = srv.throughput_stats()
    assert stats["completed"] == len(LENGTHS)
    assert stats["generated_tokens"] == len(LENGTHS) * MAX_NEW
    assert srv.pool.available == SERVER["n_pages"] - 1
    assert all(r is None for r in srv.slot_req)


def test_decode_burst_matches_single_steps(served):
    """Four decode steps per scheduler call give the single-step tokens;
    the burst's tail past a finish is discarded."""
    srv = _port(served, decode_burst=4)
    calls = []
    step = srv._step
    srv._step = lambda: calls.append(step())
    rids = [srv.submit(p, max_new=MAX_NEW) for p in served["prompts"]]
    out = srv.run()
    assert srv.decode_steps > len(calls)  # bursts of 4 did run
    assert rids == served["rids"]
    assert [out[r] for r in rids] == served["tokens"]
    lps = np.concatenate([srv.requests[r].logprobs for r in served["rids"]])
    want = np.concatenate([
        [lp for (rid, *_), lp in zip(served["events"], served["lps"])
         if rid == r] for r in served["rids"]])
    np.testing.assert_allclose(lps, want, atol=LP_ATOL, rtol=0)
    assert srv.pool.available == SERVER["n_pages"] - 1


def _until(tokens, eos=None, stops=()):
    """The greedy reference cut where eos or a stop sequence ends it."""
    for i in range(len(tokens)):
        head = tokens[: i + 1]
        if eos is not None and head[-1] == eos:
            return head
        if any(len(head) >= len(s) and tuple(head[-len(s):]) == s
               for s in stops):
            return head
    return tokens


@pytest.mark.parametrize("burst", [1, 4])
def test_eos_and_stop_end_requests(served, burst):
    ref = served["tokens"]
    eos = ref[0][3]  # the server-wide eos ends request 0 at token 4
    srv = _port(served, eos_token=eos, decode_burst=burst)
    stop = tuple(ref[1][2:4])
    rids = [srv.submit(p, max_new=MAX_NEW) for p in served["prompts"][:1]]
    rids.append(srv.submit(served["prompts"][1], max_new=MAX_NEW,
                           stop=[stop]))
    rids.append(srv.submit(served["prompts"][2], max_new=MAX_NEW,
                           eos=ref[2][5]))  # a per-request eos overrides
    out = srv.run()
    assert out[rids[0]] == _until(ref[0], eos=eos)
    assert len(out[rids[0]]) <= 4
    assert out[rids[1]] == _until(ref[1], eos=eos, stops=(stop,))
    assert out[rids[2]] == _until(ref[2], eos=ref[2][5])
    assert srv.pool.available == SERVER["n_pages"] - 1


def test_cancel_frees_pages(served):
    srv = _port(served)
    rids = [srv.submit(p, max_new=MAX_NEW) for p in served["prompts"]]
    events = srv.stream()
    next(events)  # both slots admitted and decoding
    assert srv.cancel(rids[0]) and srv.cancel(rids[4])  # decoding, queued
    assert not srv.cancel(rids[0]) and not srv.cancel(99)
    for _ in events:
        pass
    assert srv.requests[rids[0]].cancelled
    assert len(srv.requests[rids[0]].tokens) < MAX_NEW
    assert srv.requests[rids[4]].tokens == []
    assert [srv.requests[r].tokens for r in rids[1:4]] == served["tokens"][1:4]
    assert srv.pool.available == SERVER["n_pages"] - 1


def test_window_frees_pages_behind_it():
    """A windowed sequence holds at most ceil(window/page) + 1 live pages
    once it is past the window, however long it decodes."""
    tc = ttf.TransformerConfig(**SMALL, attention_window=12)
    tp = ttf.init_params(0, tc, device="cpu")
    srv = tserve.InferenceServer(tp, tc, device="cpu", batch_slots=1,
                                 page_size=4, n_pages=64,
                                 max_pages_per_seq=20)
    srv.submit(list(range(1, 31)), max_new=40)
    held = []
    for _, _, _, last in srv.stream():
        if not last:
            held.append(sum(p != srv.trash_page for p in srv.slot_pages[0]))
    # admission allocates every page up to position 30 + 40 except those
    # wholly behind the first decode position's window; the rest are
    # returned as the window passes them
    assert max(held) <= -(-(30 + 40) // 4) - (30 - 12) // 4
    assert held == sorted(held, reverse=True)
    assert held[-1] <= -(-12 // 4) + 1
    assert srv.pool.available == 63
    assert (srv.page_tables == srv.trash_page).all()


def test_later_slices_raise(served):
    for kw in ({"prefix_cache": True}, {"max_loras": 2},
               {"quantize_weights": True}, {"quantize_kv": True},
               {"prefill_chunk": 16}, {"fused_pool": False}):
        with pytest.raises(NotImplementedError, match="later slice"):
            _port(served, **kw)
    srv = _port(served)
    with pytest.raises(NotImplementedError, match="later slice"):
        srv.submit([1, 2], repetition_penalty=1.2)
    with pytest.raises(NotImplementedError, match="later slice"):
        srv.submit([1, 2], allowed_fn=lambda toks, prompt: None)


# -- sampling -----------------------------------------------------------------


def _logits(rows=4000):
    """Identical rows over 8 tokens, softmax (0.5, 0.25, 0.125, ...)."""
    row = np.log(np.asarray([0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625,
                             0.0078125, 0.0078125]))
    return np.tile(row[[3, 0, 5, 1, 7, 2, 6, 4]], (rows, 1)).astype(np.float32)


def _freq(tokens, v=8):
    return np.bincount(np.asarray(tokens), minlength=v) / len(tokens)


def test_sampling_distribution_matches_jax():
    """temperature 1, top_p 0.8: both engines draw from the nucleus
    {p=0.5, 0.25, 0.125} renormalized; 4000 draws put each frequency
    within 0.03 (about 4 binomial standard deviations)."""
    logits = _logits()
    want = np.zeros(8)
    want[[1, 3, 5]] = np.asarray([0.5, 0.25, 0.125]) / 0.875
    got = tserve.sample_tokens(torch.from_numpy(logits),
                               torch.Generator().manual_seed(1), 1.0, 0.8)
    jgot = jserve.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(1),
                                temperature=1.0, top_p=0.8)
    assert got.dtype == torch.int32
    np.testing.assert_allclose(_freq(got.numpy()), want, atol=0.03)
    np.testing.assert_allclose(_freq(np.asarray(jgot)), want, atol=0.03)


def test_sampling_is_deterministic_per_generator():
    logits = torch.from_numpy(_logits(64)) + torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32))
    ones = torch.ones(64)

    def draw(seed):
        a = tserve.sample_tokens(logits, torch.Generator().manual_seed(seed),
                                 0.9, 0.95)
        b = tserve.sample_tokens_per_slot(
            logits, torch.Generator().manual_seed(seed), 0.9 * ones,
            0.95 * ones, torch.full((64,), 5, dtype=torch.int32), 0.01 * ones)
        return a, b

    (a1, b1), (a2, b2), (a3, b3) = draw(3), draw(3), draw(4)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, a3) and not torch.equal(b1, b3)


def test_per_slot_filters_restrict_support():
    """Per slot: greedy where temperature is 0, top-k keeps the k most
    likely, min-p keeps tokens with prob >= min_p * the top prob, top-p the
    nucleus; the argmax token always survives."""
    logits = torch.from_numpy(_logits(4000))
    n = logits.shape[0] // 4
    temp = torch.tensor([0.0, 1.0, 1.0, 1.0]).repeat_interleave(n)
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.1]).repeat_interleave(n)
    top_k = torch.tensor([0, 2, 0, 0], dtype=torch.int32).repeat_interleave(n)
    min_p = torch.tensor([0.0, 0.0, 0.2, 0.0]).repeat_interleave(n)
    got = tserve.sample_tokens_per_slot(
        logits, torch.Generator().manual_seed(0), temp, top_p, top_k,
        min_p).numpy()
    greedy, topk, minp, nucleus = (set(got[i * n:(i + 1) * n].tolist())
                                   for i in range(4))
    assert greedy == {1} and nucleus == {1}
    assert topk == {1, 3}  # p = 0.5, 0.25
    assert minp == {1, 3, 5}  # p >= 0.1
    # the same filters in the JAX engine keep the same supports
    jgot = np.asarray(jserve.sample_tokens_per_slot(
        jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
        jnp.asarray(temp.numpy()), jnp.asarray(top_p.numpy()),
        jnp.asarray(top_k.numpy()), jnp.asarray(min_p.numpy())))
    for i, want in enumerate(({1}, {1, 3}, {1, 3, 5}, {1})):
        assert set(jgot[i * n:(i + 1) * n].tolist()) == want


def test_token_logprobs_match_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((5, 256)) * 3).astype(np.float32)
    toks = rng.integers(0, 256, 5).astype(np.int32)
    got = tserve.token_logprobs(torch.from_numpy(logits),
                                torch.from_numpy(toks))
    want = jserve.token_logprobs(jnp.asarray(logits), jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_sampled_server_is_deterministic_per_seed(served):
    def run(seed):
        srv = _port(served, temperature=0.8, top_p=0.9, seed=seed)
        rids = [srv.submit(p, max_new=MAX_NEW) for p in served["prompts"]]
        rids.append(srv.submit(served["prompts"][0], max_new=MAX_NEW,
                               temperature=1.0, top_k=3, min_p=0.05))
        out = srv.run()
        assert srv.pool.available == SERVER["n_pages"] - 1
        return [out[r] for r in rids]

    first = run(5)
    assert run(5) == first
    assert run(6) != first
    assert all(len(t) == MAX_NEW for t in first)
