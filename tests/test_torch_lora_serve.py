"""Port parity: multi-LoRA serving (InferenceServer(max_loras=...),
register_lora, submit(lora_id=...)).

The JAX InferenceServer and the port's serve the same mixed-adapter
requests with the same weights and the same adapters (numpy arrays handed
to both register_lora): greedy tokens equal in fp32, log-probs within
LP_ATOL, over the fused pool with the prefix cache, split pools with a
decode burst, and int8 weights (tokens equal, log-probs within QLP_ATOL,
as the quantized server tests hold them).  Each adapter's tokens are
those of generate over merge_lora(params, adapter); the prefix cache keys
pages by adapter; the registry refuses what the JAX one refuses; tp = 2 on
a LocalMesh gives the single device's tokens; the HTTP front end forwards
lora_id.
"""

import functools
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from kfunca_tpu.models import serve as jserve
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import generate as tgen
from kfunca_tpu_torch.models import lora as tlora
from kfunca_tpu_torch.models import serve as tserve
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.api_server import ApiServer
from kfunca_tpu_torch.models.weights import params_from_jax
from kfunca_tpu_torch.parallel import mesh as tmesh

# 4 heads over 2 kv heads of 64: kv_heads * hd = 128, so both engines pick
# the fused [k | v] pool, and tp = 2 splits attention by whole heads
CFG = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=256, max_seq_len=128, dtype="float32")
SERVER = dict(batch_slots=3, page_size=8, n_pages=48, max_pages_per_seq=6,
              max_loras=3, lora_rank=4)
PROMPT = list(range(40, 52))  # a full page and a part, shared by requests
LENGTHS = (5, 7, 3, 6)  # one prefill bucket of 8 tokens
MAX_NEW = 8
LP_ATOL = 1e-4
QLP_ATOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _model():
    jc, tc = jtf.TransformerConfig(**CFG), ttf.TransformerConfig(**CFG)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    return jc, jp, tc, params_from_jax(jp, tc, device="cpu")


@functools.lru_cache(maxsize=None)
def _adapters(n=2, rank=4):
    """n serving adapters ([{"A", "B"}] a layer, numpy) large enough to
    move the greedy tokens."""
    rng = np.random.default_rng(7)
    qkv = ttf.TransformerConfig(**CFG).qkv_out
    return [[{"A": rng.normal(0, 0.5, (CFG["d_model"], rank)).astype(
                 np.float32),
              "B": rng.normal(0, 0.5, (rank, qkv)).astype(np.float32)}
             for _ in range(CFG["n_layers"])] for _ in range(n)]


def _requests():
    """(prompt, lora_id): adapters 0-2 mixed in one batch, the shared
    prompt under adapter 1 twice and under adapter 2 once."""
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 256, n).tolist(), i % 3)
            for i, n in enumerate(LENGTHS)]
    return reqs + [(PROMPT, 1), (PROMPT, 2), (PROMPT, 1)]


def _serve(srv, reqs=None):
    for ads in _adapters():
        assert srv.register_lora(ads) == srv._n_loras
    reqs = _requests() if reqs is None else reqs
    rids = [srv.submit(p, max_new=MAX_NEW, lora_id=lid) for p, lid in reqs]
    out = srv.run()
    return ([out[r] for r in rids],
            [np.asarray(srv.requests[r].logprobs) for r in rids])


CASES = {"fused_prefix": dict(prefix_cache=True),
         "split_burst": dict(fused_pool=False, decode_burst=3),
         "w8_prefix": dict(quantize_weights=True, prefix_cache=True)}


@functools.lru_cache(maxsize=None)
def _jax_run(case, slots=SERVER["batch_slots"]):
    jc, jp, _, _ = _model()
    return _serve(jserve.InferenceServer(
        jp, jc, **{**SERVER, **CASES[case], "batch_slots": slots}))


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_adapters_match_the_jax_server(case):
    """The mixed batch: the JAX server's tokens and log-probs.  With int8
    weights the JAX server is not batch-invariant: the adapter delta's
    fp32 einsum over 3 slots rounds otherwise than over 1, an int8
    activation rounding then flips, and one request's log-probs move by
    5.6e-3 nat between batch_slots 1 and 3 (parting a near tie five tokens
    on).  The port's server gives the same tokens whatever the slots, and
    is held to the JAX server run one slot at a time there."""
    _, _, tc, tp = _model()
    w8 = "w8" in case
    want, want_lp = _jax_run(case, 1 if w8 else SERVER["batch_slots"])
    srv = tserve.InferenceServer(tp, tc, device="cpu", **SERVER,
                                 **CASES[case])
    got, got_lp = _serve(srv)
    assert got == want
    tol = QLP_ATOL if w8 else LP_ATOL
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    assert srv.slot_lora.tolist() == [0] * SERVER["batch_slots"]
    if w8:
        one, one_lp = _serve(tserve.InferenceServer(
            tp, tc, device="cpu", **{**SERVER, **CASES[case],
                                     "batch_slots": 1}))
        assert one == got
        for g, w in zip(got_lp, one_lp):
            np.testing.assert_allclose(g, w, atol=LP_ATOL, rtol=0)


def test_each_adapter_is_generate_over_its_merged_weights():
    """Every request's greedy tokens are those of generate over
    merge_lora(params, adapter) (adapter 0: the base params), and a
    max_loras=0 server gives the base requests' tokens."""
    _, _, tc, tp = _model()
    got, _ = _serve(tserve.InferenceServer(tp, tc, device="cpu", **SERVER))
    merged = [tp] + [tlora.merge_lora(tp, {"blocks": [
        {"wqkv": {k: torch.from_numpy(v) for k, v in layer.items()}}
        for layer in ads], "scale": 1.0}) for ads in _adapters()]
    for (prompt, lid), toks in zip(_requests(), got):
        want = tgen.generate(merged[lid], torch.tensor([prompt]), tc,
                             MAX_NEW)
        assert toks == want[0].tolist()
    base = [(p, 0) for p, lid in _requests() if lid == 0]
    plain = tserve.InferenceServer(tp, tc, device="cpu",
                                   **{**SERVER, "max_loras": 0})
    rids = [plain.submit(p, max_new=MAX_NEW) for p, _ in base]
    out = plain.run()
    want = [t for (p, lid), t in zip(_requests(), got) if lid == 0]
    assert [out[r] for r in rids] == want


def test_prefix_pages_are_keyed_by_adapter():
    """One prompt under two adapters shares no page; the same adapter
    repeated reuses its pages."""
    _, _, tc, tp = _model()
    srv = tserve.InferenceServer(tp, tc, device="cpu", prefix_cache=True,
                                 **{**SERVER, "batch_slots": 1})
    for ads in _adapters():
        srv.register_lora(ads)
    pages = len(PROMPT) // SERVER["page_size"]
    reused = (len(PROMPT) - 1) // SERVER["page_size"]

    def hits(lid):
        before = srv.prefix_hit_pages
        srv.submit(PROMPT, max_new=2, lora_id=lid)
        srv.run()
        return srv.prefix_hit_pages - before

    assert hits(1) == 0
    assert hits(2) == 0  # another adapter: its own pages
    assert hits(0) == 0  # the base: its own pages
    assert hits(1) == reused
    assert hits(2) == reused
    assert len(srv._pcache) == 3 * pages
    keys = [srv._prefix_hashes(np.asarray(PROMPT), lid) for lid in (0, 1, 2)]
    assert len({k for ks in keys for k in ks}) == 3 * pages


def test_registry_and_submit_refuse_what_the_jax_server_refuses():
    jc, jp, tc, tp = _model()
    ads = _adapters()[0]
    for srv in (jserve.InferenceServer(jp, jc, batch_slots=1, n_pages=8),
                tserve.InferenceServer(tp, tc, device="cpu", batch_slots=1,
                                       n_pages=8)):
        with pytest.raises(ValueError, match="max_loras=0"):
            srv.register_lora(ads)
        with pytest.raises(ValueError, match="unknown lora_id 1"):
            srv.submit([1, 2, 3], lora_id=1)
    for srv in (jserve.InferenceServer(jp, jc, batch_slots=1, n_pages=8,
                                       max_loras=1, lora_rank=4),
                tserve.InferenceServer(tp, tc, device="cpu", batch_slots=1,
                                       n_pages=8, max_loras=1, lora_rank=4)):
        with pytest.raises(ValueError, match="unknown lora_id 1"):
            srv.submit([1, 2, 3], lora_id=1)
        assert srv.register_lora(ads) == 1
        srv.submit([1, 2, 3], lora_id=1)
        with pytest.raises(ValueError, match="lora registry full"):
            srv.register_lora(ads)
        with pytest.raises(ValueError, match="unknown lora_id 2"):
            srv.submit([1, 2, 3], lora_id=2)
    srv = tserve.InferenceServer(tp, tc, device="cpu", batch_slots=1,
                                 n_pages=8, max_loras=1, lora_rank=8)
    with pytest.raises(ValueError, match="the server takes"):
        srv.register_lora(ads)  # rank 4 adapters into rank-8 slots
    with pytest.raises(ValueError, match="adapter layers"):
        srv.register_lora(ads[:1])
    assert srv._n_loras == 0  # a refused adapter takes no slot


@pytest.mark.parametrize("kw", [{}, dict(quantize_weights=True,
                                         quantize_kv=True)],
                         ids=["fp32", "w8kv8"])
def test_tp2_matches_the_single_device(kw):
    """tp = 2 on a LocalMesh: each rank adds its heads' columns of the
    delta; the single device's tokens (log-probs within LP_ATOL in fp32,
    QLP_ATOL with int8 weights and KV)."""
    _, _, tc, tp = _model()
    opts = {**SERVER, "fused_pool": False, **kw}
    want, want_lp = _serve(tserve.InferenceServer(tp, tc, device="cpu",
                                                  **opts))
    srv = tserve.InferenceServer(tp, tc, mesh=tmesh.LocalMesh(1, 2, "cpu"),
                                 device="cpu", **opts)
    got, got_lp = _serve(srv)
    assert srv._decode_params.attn_split
    assert srv._lora_B_ranks[0].shape[-1] == tc.qkv_out // 2
    assert got == want
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, atol=QLP_ATOL if kw else LP_ATOL,
                                   rtol=0)


def test_the_http_front_end_forwards_lora_id():
    """/v1/completions with lora_id: the tokens of the engine's own submit
    under that adapter; an unregistered id is a 400."""
    _, _, tc, tp = _model()

    def engine():
        srv = tserve.InferenceServer(tp, tc, device="cpu", **SERVER)
        for ads in _adapters():
            srv.register_lora(ads)
        return srv

    direct = engine()
    prompt = _requests()[1][0]
    rids = [direct.submit(prompt, max_new=MAX_NEW, lora_id=lid)
            for lid in (0, 2)]
    want = direct.run()
    api = ApiServer(engine()).start()
    try:
        def call(body):
            req = urllib.request.Request(
                f"http://{api.host}:{api.port}/v1/completions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                resp = urllib.request.urlopen(req, timeout=120)
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())
            return resp.status, json.loads(resp.read())

        for lid, rid in zip((0, 2), rids):
            code, body = call({"prompt": prompt, "max_tokens": MAX_NEW,
                               "lora_id": lid})
            assert code == 200
            assert body["choices"][0]["tokens"] == want[rid]
        assert want[rids[0]] != want[rids[1]]
        code, body = call({"prompt": prompt, "lora_id": 3})
        assert code == 400 and "lora_id" in json.dumps(body)
    finally:
        api.shutdown()
