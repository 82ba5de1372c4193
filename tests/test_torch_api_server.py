"""Port parity: the HTTP front end (kfunca_tpu_torch/models/api_server.py)
against the JAX package's, each over its own InferenceServer on the same
weights and the same tokenizer.  The same requests, sent in the same order
to both, must give the same tokens, finish_reason, usage and SSE events
(log-probs within LP_ATOL), and the same 400 and 404 bodies."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from kfunca_tpu.models import serve as jserve
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.models.api_server import ApiServer as JaxApi
from kfunca_tpu.models.tokenizer import BPETokenizer as JaxBPE
from kfunca_tpu_torch.models import serve as tserve
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.api_server import (
    CHAT_SPECIALS, ApiServer, _Utf8Carry, chatml_prompt)
from kfunca_tpu_torch.models.tokenizer import BPETokenizer
from kfunca_tpu_torch.models.weights import params_from_jax

LP_ATOL = 1e-4  # fp32 logits summed in another order (test_torch_serve.py)
CORPUS = "the sea rose and the wind sang over the naïve café 🚀 " * 40
SERVER = dict(batch_slots=2, page_size=8, n_pages=64, max_pages_per_seq=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: one intra-op thread runs them faster than
    many, and leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    """(port ApiServer, JAX ApiServer, port tokenizer, engine factory),
    both servers on one set of weights whose vocab is the tokenizer's."""
    jtok = JaxBPE.train(CORPUS, 300).with_special_tokens(CHAT_SPECIALS)
    ttok = BPETokenizer(jtok.merges, CHAT_SPECIALS)
    kw = dict(vocab_size=ttok.vocab_size, d_model=64, n_heads=4,
              n_kv_heads=2, n_layers=2, d_ff=128, max_seq_len=128,
              dtype="float32")
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jp, tc, device="cpu")

    def engine():
        return tserve.InferenceServer(tp, tc, device="cpu", **SERVER)

    ours = ApiServer(engine(), tokenizer=ttok).start()
    theirs = JaxApi(jserve.InferenceServer(jp, jc, **SERVER),
                    tokenizer=jtok).start()
    yield ours, theirs, ttok, engine
    ours.shutdown()
    theirs.shutdown()


def _call(srv, path, body=None, raw=None):
    """(status, parsed body or SSE event list)."""
    url = f"http://{srv.host}:{srv.port}{path}"
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=120)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    if resp.headers.get("Content-Type") == "text/event-stream":
        events = []
        for line in resp:
            line = line.strip()
            if line.startswith(b"data: "):
                events.append(line[6:].decode())
        return resp.status, events
    return resp.status, json.loads(resp.read())


def _same(got, want):
    """Equal bodies but for log-probs, which agree within LP_ATOL."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            if k in ("logprobs", "logprob"):
                np.testing.assert_allclose(got[k], want[k], atol=LP_ATOL,
                                           rtol=0)
            else:
                _same(got[k], want[k])
    elif isinstance(got, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        assert got == want


REQUESTS = [
    ("tokens", "/v1/completions", {"prompt": list(range(3, 19)),
                                   "max_tokens": 9}),
    ("text", "/v1/completions", {"prompt": "the sea rose", "max_tokens": 7}),
    ("multibyte", "/v1/completions", {"prompt": "naïve café 🚀",
                                      "max_tokens": 6}),
    ("stop", "/v1/completions", {"prompt": list(range(5, 12)),
                                 "max_tokens": 12, "stop": [[7, 9]]}),
    ("penalties", "/v1/completions", {
        "prompt": "the wind sang", "max_tokens": 10,
        "repetition_penalty": 1.5, "presence_penalty": 0.5,
        "frequency_penalty": 0.3, "logit_bias": {"5": 4.0, "9": -30.0}}),
    ("chat", "/v1/chat/completions", {"messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "the sea?"}], "max_tokens": 8}),
    ("stream", "/v1/completions", {"prompt": "café the sea",
                                   "max_tokens": 8, "stream": True}),
]


@pytest.mark.parametrize("name,path,body", REQUESTS,
                         ids=[r[0] for r in REQUESTS])
def test_responses_match_jax(pair, name, path, body):
    """Each request goes to both servers in the same order, so ids match
    too; streamed events are compared event for event."""
    ours, theirs, _, _ = pair
    code, got = _call(ours, path, body)
    wcode, want = _call(theirs, path, body)
    assert code == wcode == 200
    if body.get("stream"):
        assert got[-1] == want[-1] == "[DONE]"
        got = [json.loads(e) for e in got[:-1]]
        want = [json.loads(e) for e in want[:-1]]
        assert [e["finished"] for e in got] == [False] * (len(got) - 1) + [
            True]
    _same(got, want)


def test_requests_match_direct_submits(pair):
    """Tokens over HTTP are those of the engine itself, and concurrent
    requests each get their own."""
    ours, _, tok, engine = pair
    prompts = [list(range(i, i + 6 + i)) for i in range(1, 5)]
    direct = engine()
    rids = [direct.submit(p, max_new=8) for p in prompts]
    want = direct.run()
    got = [None] * len(prompts)

    def one(i):
        got[i] = _call(ours, "/v1/completions",
                       {"prompt": prompts[i], "max_tokens": 8})[1]

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [g["choices"][0]["tokens"] for g in got] == [want[r] for r in rids]
    assert all(g["choices"][0]["text"] == tok.decode(want[r])
               for g, r in zip(got, rids))


BAD = [
    ("bad_json", "/v1/completions", None, b"{not json"),
    ("no_prompt", "/v1/completions", {"max_tokens": 3}, None),
    ("bad_lora", "/v1/completions", {"prompt": [1, 2], "lora_id": 3}, None),
    ("bad_messages", "/v1/chat/completions", {"messages": "hi"}, None),
    ("unknown_post", "/v1/nothing", {"prompt": [1]}, None),
]


@pytest.mark.parametrize("name,path,body,raw", BAD, ids=[b[0] for b in BAD])
def test_errors_match_jax(pair, name, path, body, raw):
    ours, theirs, _, _ = pair
    got = _call(ours, path, body, raw)
    want = _call(theirs, path, body, raw)
    assert got[0] in (400, 404) and got == want


def test_get_endpoints_match_jax(pair):
    ours, theirs, _, _ = pair
    assert _call(ours, "/v1/models") == _call(theirs, "/v1/models")
    assert _call(ours, "/v1/unknown") == _call(theirs, "/v1/unknown")
    code, stats = _call(ours, "/v1/stats")
    wcode, wstats = _call(theirs, "/v1/stats")
    assert code == wcode == 200
    # the port's stats add decode_steps; every JAX key is there
    assert set(wstats) <= set(stats) and stats["queued"] == 0


def test_text_needs_a_tokenizer():
    """Without a tokenizer, a string prompt and a chat request are 400s."""
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=1, d_ff=64, dtype="float32")
    srv = ApiServer(tserve.InferenceServer(
        ttf.init_params(0, cfg, device="cpu"), cfg, device="cpu",
        **SERVER)).start()
    try:
        assert _call(srv, "/v1/completions", {"prompt": "hi"}) == (400, {
            "error": "string prompt needs a server tokenizer; send token "
                     "ids"})
        assert _call(srv, "/v1/chat/completions", {"messages": []}) == (
            400, {"error": "chat needs a server tokenizer"})
        assert _call(srv, "/v1/cancel", {"id": 99}) == (200, {
            "cancelled": False})
    finally:
        srv.shutdown()


def test_cancel_ends_a_streaming_request(pair):
    ours, _, _, _ = pair
    url = f"http://{ours.host}:{ours.port}/v1/completions"
    req = urllib.request.Request(url, data=json.dumps({
        "prompt": [1, 2, 3], "max_tokens": 40, "stream": True}).encode())
    resp = urllib.request.urlopen(req, timeout=120)
    first = json.loads(next(l for l in resp if l.startswith(b"data: "))[6:])
    assert _call(ours, "/v1/cancel", {"id": first["id"]}) == (200, {
        "cancelled": True})
    rest = [l.strip() for l in resp if l.startswith(b"data: ")]
    assert rest[-1] == b"data: [DONE]" and len(rest) < 40
    assert ours.engine.requests[first["id"]].cancelled


def test_chatml_and_utf8_carry():
    tok = BPETokenizer.train(CORPUS, 280).with_special_tokens(CHAT_SPECIALS)
    jtok = JaxBPE(tok.merges, CHAT_SPECIALS)
    from kfunca_tpu.models.api_server import chatml_prompt as jax_chatml

    msgs = [{"role": "user", "content": "naïve 🚀"}]
    np.testing.assert_array_equal(chatml_prompt(tok, msgs),
                                  jax_chatml(jtok, msgs))
    with pytest.raises(KeyError):
        chatml_prompt(BPETokenizer.train(CORPUS, 260), msgs)
    carry = _Utf8Carry()
    data = "é🚀".encode()
    assert carry.feed(data[:1]) == "" and carry.pending == data[:1]
    assert carry.feed(data[1:3]) == "é" and carry.feed(data[3:]) == "🚀"
    assert carry.feed(b"\xff") == "�" and carry.pending == b""
