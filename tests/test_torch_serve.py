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
from kfunca_tpu_torch.models.weights import (
    decode_params_from_jax, params_from_jax)
from kfunca_tpu_torch.utils.tree import tree_leaves

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
    for kw in ({"max_loras": 2}, {"prefill_chunk": 16}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="later slice"):
            _port(served, **kw)
    srv = _port(served)
    with pytest.raises(NotImplementedError, match="later slice"):
        srv.submit([1, 2], repetition_penalty=1.2)
    with pytest.raises(NotImplementedError, match="later slice"):
        srv.submit([1, 2], allowed_fn=lambda toks, prompt: None)
    if served["tc"].attention_window is not None:
        # as in the JAX server: a window invalidates shared-prefix reuse
        with pytest.raises(NotImplementedError, match="sliding windows"):
            _port(served, prefix_cache=True)
    with pytest.raises(ValueError, match="quantize_weights"):
        _port(served, quantize_weights="int2")


# -- quantized weights, int8 KV, split pools, prefix cache ---------------------

# Quantized decode rounds activations and K/V vectors to int8.  The two
# frameworks sum an fp32 matmul in different orders, so a value a hair from
# a .5 boundary can round to the other neighbour: one int8 step of one
# element, 1/127 of its vector's largest entry.  That moves a log-prob by
# up to ~1e-2 (measured: 3e-4 with int8 KV, 8e-3 with int8 weights and KV
# over 12 decode steps) while a wrong scale, page or mask moves it by
# tenths.  Greedy tokens still agree on this model and these prompts (no
# top-2 margin is that small), so tokens are compared exactly and
# log-probs to Q_LP_ATOL; the unquantized options keep LP_ATOL.
Q_LP_ATOL = 0.05
OPTIONS = {
    "w8": dict(quantize_weights=True),
    "kv8": dict(quantize_kv=True),
    "w8kv8": dict(quantize_weights="int8", quantize_kv=True),
    "w4": dict(quantize_weights="int4"),
    "split": dict(fused_pool=False),
    "split_kv8": dict(fused_pool=False, quantize_kv=True),
}


@pytest.fixture(scope="module")
def shared():
    """One set of fp32 weights in both packages, no window."""
    jc, tc = jtf.TransformerConfig(**SMALL), ttf.TransformerConfig(**SMALL)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    return dict(jc=jc, tc=tc, jp=jp, tp=params_from_jax(jp, tc, device="cpu"),
                prompts=[rng.integers(0, 256, n).tolist() for n in LENGTHS])


def _widen_int4(tree):
    """numpy has no int4: widen a JAX decode-params tree's int4 leaves."""
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.int8) if x.dtype == jnp.int4 else x, tree)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_decode_params_bit_equal_to_jax(shared, bits):
    """The port's own quantizer and the JAX pytree carried across hold the
    same integers and scales, leaf for leaf."""
    want = decode_params_from_jax(
        _widen_int4(jserve.quantize_decode_params(shared["jp"], bits=bits)),
        device="cpu")
    got = tserve.quantize_decode_params(shared["tp"], bits=bits)
    assert sorted(got) == sorted(want) and "lm_head" in got
    blk = got["blocks"][0]
    assert isinstance(blk["wqkv"], tuple) and not isinstance(
        blk["attn_norm"], tuple)
    assert blk["wqkv"][0].dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert blk["wqkv"][0].shape[0] == 256 // (1 if bits == 8 else 2)
    assert got["lm_head"][1].shape == ((256,) if bits == 8 else (2, 256))
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="bits"):
        tserve.quantize_decode_params(shared["tp"], bits=2)


def _random_pools(rng, cfg, n_pages, page, fused, quantized):
    """numpy pools in the engine's four forms, filled with random KV (and
    positive scales), as (pools_k, pools_v); a quantized pool is a
    (data, scales) pair."""
    lead = (cfg.n_layers, n_pages, page)
    hkv, hd = cfg.kv_heads, cfg.head_dim

    def one(*tail):
        if not quantized:
            return rng.standard_normal(lead + tail).astype(np.float32)
        lanes = (128,) if fused else (hkv,)
        return (rng.integers(-127, 128, lead + tail).astype(np.int8),
                rng.uniform(0.005, 0.02, lead + lanes).astype(np.float32))

    return (one(2 * hkv * hd), None) if fused else (one(hkv, hd),
                                                    one(hkv, hd))


def _tree(fn, x):
    if isinstance(x, tuple):
        return tuple(fn(v) for v in x)
    return None if x is None else fn(x)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_decode_step_logits_match_jax(shared, name, monkeypatch):
    """One batched decode step from identical pools, tables and positions:
    the logits of both engines.  fp paths: 1e-4 (summation order).
    Quantized paths: 5e-3; a flipped int8 rounding of one activation
    element moves a logit by about 1e-3 here (see Q_LP_ATOL)."""
    opt = OPTIONS[name]
    bits = {True: 8, "int8": 8, "int4": 4}.get(opt.get("quantize_weights"))
    fused = opt.get("fused_pool", True)
    quantized = bool(opt.get("quantize_kv"))
    jc, tc = shared["jc"], shared["tc"]
    jparams, tparams = shared["jp"], shared["tp"]
    if bits:
        jparams = jserve.quantize_decode_params(jparams, bits=bits)
        tparams = decode_params_from_jax(_widen_int4(jparams), device="cpu")
    rng = np.random.default_rng(1)
    page, n_pages = 8, 12
    pk, pv = _random_pools(rng, tc, n_pages, page, fused, quantized)
    tables = np.asarray([[1, 2, 3], [4, 5, 11], [6, 11, 11]], np.int32)
    positions = np.asarray([20, 9, 3], np.int32)
    last = rng.integers(0, 256, 3).astype(np.int32)

    seen = {}
    real_j, real_t = jserve.token_logprobs, tserve.token_logprobs
    monkeypatch.setattr(jserve, "token_logprobs", lambda lg, tk: (
        seen.setdefault("jax", np.asarray(lg)), real_j(lg, tk))[1])
    monkeypatch.setattr(tserve, "token_logprobs", lambda lg, tk: (
        seen.setdefault("torch", lg.numpy()), real_t(lg, tk))[1])
    jtok, _, jpk, _ = jserve._decode_step_impl(
        jparams, _tree(jnp.asarray, pk), _tree(jnp.asarray, pv),
        jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(last),
        jax.random.PRNGKey(0), jc, page, engine="xla")
    tpk = _tree(lambda a: torch.from_numpy(a.copy()), pk)
    tpv = _tree(lambda a: torch.from_numpy(a.copy()), pv)
    ttok, _ = tserve.paged_decode_step(
        tparams, tpk, tpv, torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(last),
        torch.Generator().manual_seed(0), tc, page)
    tol = 5e-3 if (bits or quantized) else 1e-4
    np.testing.assert_allclose(seen["torch"], seen["jax"], atol=tol, rtol=0)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    # the step wrote the new K/V (and scales) in place, where the JAX step
    # did: fp values agree to 1e-5, an int8 rounding may flip by one step
    got_pools = tpk if quantized else (tpk,)
    want_pools = jpk if quantized else (jpk,)
    assert not np.array_equal(got_pools[0].numpy(), pk[0] if quantized else pk)
    for got, want in zip(got_pools, want_pools):
        diff = np.abs(got.numpy().astype(np.float32)
                      - np.asarray(want).astype(np.float32))
        assert diff.max() <= (1.0 if got.dtype == torch.int8 else 1e-5)


@pytest.fixture(scope="module", params=list(OPTIONS))
def jax_option_run(request, shared):
    """The JAX server's greedy run under one option."""
    jsrv = jserve.InferenceServer(shared["jp"], shared["jc"], **SERVER,
                                  **OPTIONS[request.param])
    rids, events, lps = _drive(jsrv, shared["prompts"])
    return dict(name=request.param, rids=rids, events=events, lps=lps,
                fused=jsrv.fused_pool)


def test_option_stream_matches_jax_server(shared, jax_option_run):
    """Greedy serving under each new option: the JAX server's event stream
    (request, token, finished, free pages, trash-table entries) and its
    log-probs."""
    opt = OPTIONS[jax_option_run["name"]]
    srv = tserve.InferenceServer(shared["tp"], shared["tc"], device="cpu",
                                 **SERVER, **opt)
    assert srv.fused_pool == jax_option_run["fused"]
    rids, events, lps = _drive(srv, shared["prompts"])
    assert rids == jax_option_run["rids"]
    assert events == jax_option_run["events"]
    quantized = opt.get("quantize_weights") or opt.get("quantize_kv")
    np.testing.assert_allclose(lps, jax_option_run["lps"], rtol=0,
                               atol=Q_LP_ATOL if quantized else LP_ATOL)
    assert srv.pool.available == SERVER["n_pages"] - 1


def test_pool_forms_and_bytes(shared):
    """The four pool forms' shapes and dtypes (the JAX constructor's), the
    scale pools starting at ones, and int8 pools taking a quarter of the
    fp32 data bytes plus their scales."""
    tc, hkv, hd = shared["tc"], 2, 64
    lead = (2, SERVER["n_pages"], SERVER["page_size"])
    made = {name: tserve.InferenceServer(shared["tp"], tc, device="cpu",
                                         **SERVER, **kw)
            for name, kw in [("fused", {}), ("kv8", OPTIONS["kv8"]),
                             ("split", OPTIONS["split"]),
                             ("split_kv8", OPTIONS["split_kv8"])]}
    assert made["fused"].pools_v is None and made["kv8"].pools_v is None
    assert made["fused"].pools_k.shape == lead + (2 * hkv * hd,)
    data, scales = made["kv8"].pools_k
    assert data.shape == lead + (2 * hkv * hd,) and data.dtype == torch.int8
    assert scales.shape == lead + (128,) and bool((scales == 1).all())
    assert made["split"].pools_k.shape == lead + (hkv, hd)
    assert made["split"].pools_v.shape == lead + (hkv, hd)
    for pool in (made["split_kv8"].pools_k, made["split_kv8"].pools_v):
        assert pool[0].shape == lead + (hkv, hd) and pool[0].dtype == torch.int8
        assert pool[1].shape == lead + (hkv,) and bool((pool[1] == 1).all())
    slots = lead[0] * lead[1] * lead[2]
    assert made["fused"].pool_bytes() == made["split"].pool_bytes() \
        == slots * 2 * hkv * hd * 4
    assert made["kv8"].pool_bytes() == slots * (2 * hkv * hd + 128 * 4)
    assert made["split_kv8"].pool_bytes() == slots * (2 * hkv * hd
                                                      + 2 * hkv * 4)
    with pytest.raises(ValueError, match="fused pools need"):
        tserve.InferenceServer(
            ttf.init_params(0, ttf.TransformerConfig(**{**SMALL,
                                                        "n_kv_heads": 1}),
                            device="cpu"),
            ttf.TransformerConfig(**{**SMALL, "n_kv_heads": 1}),
            device="cpu", fused_pool=True, **SERVER)


def test_unaligned_heads_pick_split_pools_like_jax():
    """kv_heads*head_dim = 64 is no multiple of 128: both engines choose
    split pools, served by `paged_decode_attention`, and agree."""
    kw = {**SMALL, "n_kv_heads": 1}
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(2), jc)
    tp = params_from_jax(jp, tc, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (7, 21)]
    jsrv = jserve.InferenceServer(jp, jc, **SERVER)
    srv = tserve.InferenceServer(tp, tc, device="cpu", **SERVER)
    assert not jsrv.fused_pool and not srv.fused_pool
    assert _drive(srv, prompts)[1] == _drive(jsrv, prompts)[1]


PREFIX_SERVER = dict(batch_slots=2, page_size=8, n_pages=14,
                     max_pages_per_seq=8)


def _prefix_prompts(pressure: bool = False):
    """Two families of prompts that share a 24- and a 16-token prefix and
    then diverge, one prompt repeated whole, and one with nothing shared;
    with 13 allocatable pages, cached pages must be evicted on the way.
    `pressure` orders them so that the last admission finds its own reused
    pages oldest in the cache while it must evict for room."""
    rng = np.random.default_rng(6)
    fam_a, fam_b = rng.integers(0, 256, 24), rng.integers(0, 256, 16)
    tails = [rng.integers(0, 256, n) for n in (3, 9, 1, 14, 6, 11)]
    lone = rng.integers(0, 256, 30)
    prompts = [np.concatenate([fam_a, tails[0]]),
               np.concatenate([fam_b, tails[1]]),
               np.concatenate([fam_a, tails[2]]),
               lone,
               np.concatenate([fam_a[:16], tails[3]]),
               np.concatenate([fam_b, tails[1]]),
               np.concatenate([fam_b, tails[5]]),
               np.concatenate([fam_a, tails[4]])]
    if pressure:
        prompts = [prompts[i] for i in (0, 1, 2, 4, 5, 3, 7, 6)]
    return [p.tolist() for p in prompts]


PREFIX_OPTS = pytest.mark.parametrize(
    "opt", [{}, {"quantize_kv": True},
            {"fused_pool": False, "quantize_kv": True}],
    ids=["fp", "kv8", "split_kv8"])


@PREFIX_OPTS
def test_prefix_cache_matches_jax_server(shared, opt):
    """Shared prefixes, divergent suffixes and eviction under pool
    pressure: the same events, the same reuse counts and the same cache
    contents as the JAX server."""
    prompts = _prefix_prompts()
    jsrv = jserve.InferenceServer(shared["jp"], shared["jc"], prefix_cache=True,
                                  **PREFIX_SERVER, **opt)
    srv = tserve.InferenceServer(shared["tp"], shared["tc"], device="cpu",
                                 prefix_cache=True, **PREFIX_SERVER, **opt)
    _, jevents, jlps = _drive(jsrv, prompts)
    _, events, lps = _drive(srv, prompts)
    assert events == jevents
    np.testing.assert_allclose(lps, jlps, rtol=0,
                               atol=Q_LP_ATOL if opt else LP_ATOL)
    js, ts = jsrv.throughput_stats(), srv.throughput_stats()
    for key in ("prefix_hit_pages", "prefix_fresh_pages", "cached_pages",
                "pages_available", "completed"):
        assert ts[key] == js[key], key
    assert ts["prefix_hit_pages"] > 0
    # eviction happened: fewer pages stayed cached than were ever published
    assert ts["cached_pages"] < sum(len(p) // 8 for p in prompts)
    assert ts["cached_pages"] + ts["pages_available"] == 13
    assert sorted(srv._page_refs.values()) == [1] * ts["cached_pages"]


@PREFIX_OPTS
@pytest.mark.parametrize("pressure", [False, True], ids=["", "pressure"])
def test_prefix_cache_changes_no_output(shared, opt, pressure):
    """A server with the cache gives the output of one without it, also
    when an admission must evict while its own reused pages are the oldest
    entries: they are pinned first.  (The JAX server takes its references
    after the allocation and, in the `pressure` order, evicts and re-issues
    a page it is reusing: see
    test_jax_server_reissues_a_reused_page_in_the_pressure_order.)  fp32: the same tokens, log-probs within LP_ATOL
    (prefill over the suffix sums in another order).  int8 KV: a reused
    page is read back dequantized where the uncached prefill saw the fp
    values, one int8 step apart at most: Q_LP_ATOL."""
    prompts = _prefix_prompts(pressure)
    runs = []
    for cache in (True, False):
        srv = tserve.InferenceServer(shared["tp"], shared["tc"], device="cpu",
                                     prefix_cache=cache, **PREFIX_SERVER,
                                     **opt)
        rids = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
        out = srv.run()
        runs.append(([out[r] for r in rids],
                     np.concatenate([srv.requests[r].logprobs for r in rids]),
                     srv.throughput_stats()))
    (toks, lps, stats), (toks0, lps0, stats0) = runs
    assert stats["prefix_hit_pages"] > 0 and stats0["prefix_hit_pages"] == 0
    assert stats["prefix_fresh_pages"] < stats0["prefix_fresh_pages"]
    np.testing.assert_allclose(lps, lps0, rtol=0,
                               atol=Q_LP_ATOL if opt else LP_ATOL)
    if not opt:
        assert toks == toks0


def _serve_watching_tables(srv, prompts):
    """Run `prompts`; returns (tokens, log-probs per request, the slot page
    lists seen after each admission round that name one page twice)."""
    inner, twice = srv._admit, []

    def admit():
        inner()
        twice.extend(list(pages) for pages in srv.slot_pages
                     if len(set(pages)) < len(pages))

    srv._admit = admit
    rids = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
    out = srv.run()
    return ([out[r] for r in rids],
            [np.asarray(srv.requests[r].logprobs) for r in rids], twice)


def test_jax_server_reissues_a_reused_page_in_the_pressure_order(shared):
    """Why `_admit` pins reused pages BEFORE it evicts, where the JAX
    server takes its references after the allocation: in the `pressure`
    order the JAX server evicts the pages the admission is about to reuse,
    gets them back from the pool as fresh pages, and builds a page table
    that names one page twice; that request's prefill then overwrites its
    own reused prefix and its output leaves the JAX server's own uncached
    run by tenths of a nat.  The port, on the same weights and order, names
    no page twice and stays with both uncached runs."""
    prompts = _prefix_prompts(pressure=True)

    def run(module, params, cfg, cache, **kw):
        return _serve_watching_tables(
            module.InferenceServer(params, cfg, prefix_cache=cache,
                                   **PREFIX_SERVER, **kw), prompts)

    jtoks, jlps, jtwice = run(jserve, shared["jp"], shared["jc"], True)
    jtoks0, jlps0, jtwice0 = run(jserve, shared["jp"], shared["jc"], False)
    toks, lps, twice = run(tserve, shared["tp"], shared["tc"], True,
                           device="cpu")
    assert jtwice and not jtwice0 and not twice
    far = [float(np.abs(a - b).max()) for a, b in zip(jlps, jlps0)]
    assert max(far) > 0.1 and jtoks != jtoks0
    # every request that kept its pages agrees, the port's all do
    assert sorted(far)[-2] <= LP_ATOL
    assert toks == jtoks0
    np.testing.assert_allclose(np.concatenate(lps), np.concatenate(jlps0),
                               rtol=0, atol=LP_ATOL)


def test_prefix_index_lru_semantics_match_jax():
    """The same operations on the port's PrefixIndex and the JAX package's
    (native or fallback): the same answers and the same LRU order."""
    jidx, tidx = jserve.PrefixIndex(), tserve.PrefixIndex()
    prompt = np.arange(40, dtype=np.int32) % 7
    jkeys = jidx.hash_chain(prompt, 8, 0)
    tkeys = tidx.hash_chain(prompt, 8, 0)
    assert len(jkeys) == len(tkeys) == 5 and len(set(tkeys)) == 5
    # the chain commits to the whole prefix and to the seed
    assert tidx.hash_chain(prompt[:16], 8, 0) == tkeys[:2]
    assert tidx.hash_chain(prompt, 8, 1)[0] != tkeys[0]
    other = prompt.copy()
    other[0] += 1
    assert all(a != b for a, b in zip(tidx.hash_chain(other, 8, 0), tkeys))
    assert tidx.hash_chain(prompt[:7], 8, 0) == []
    for idx, keys in ((jidx, jkeys), (tidx, tkeys)):
        assert all(idx.put(k, 10 + i) for i, k in enumerate(keys))
        assert not idx.put(keys[1], 99) and idx.get(keys[1]) == 11
        idx.touch(keys[0])  # oldest becomes newest
        assert idx.get(keys[2]) == 12  # get does not touch
        assert idx.erase(keys[3]) == 13 and idx.erase(keys[3]) is None
        assert keys[3] not in idx and keys[4] in idx and len(idx) == 4
        assert [p for _, p in idx.lru_items()] == [11, 12, 14, 10]
        assert idx.lru_items()[0][0] == keys[1]


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
