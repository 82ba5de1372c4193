"""Port parity: tensor-parallel serving (InferenceServer(mesh=...)).

The JAX InferenceServer over make_mesh(n, dp=1, tp=n) of the conftest's
virtual CPU devices (GSPMD over the XLA gather engine) and the port's over
LocalMesh(1, tp, "cpu") (each rank its own heads and pools, the paged
kernels' plain versions) serve the same requests with the same weights
(the JAX init_params carried across by models/weights).  Greedy tokens
are compared exactly and log-probs within LP_ATOL; with int8 weights and
KV, whose roundings can move where the two frameworks sum in another
order, within QLP_ATOL.  Speculative decoding under tp is held to the JAX
greedy generate of the target, as the JAX dryrun holds its own.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import generate as jgen
from kfunca_tpu.models import serve as jserve
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.parallel import mesh as jmesh
from kfunca_tpu_torch.models import generate as tgen
from kfunca_tpu_torch.models import serve as tserve
from kfunca_tpu_torch.models import speculative as tspec
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax
from kfunca_tpu_torch.parallel import mesh as tmesh

# 4 heads over 2 kv heads: tp 2 splits attention by heads; tp 4 does not
# divide the kv heads, so attention is replicated and the MLP split
GQA = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
           n_layers=2, d_ff=256, max_seq_len=128, dtype="float32")
# the JAX dryrun's _tiny_cfg in fp32: 2 heads under tp 4
TINY = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
            max_seq_len=128, dtype="float32")
SERVER = dict(batch_slots=2, page_size=8, n_pages=32, max_pages_per_seq=4)
PROMPTS = ([3, 5, 7], [9, 1, 4, 4, 7, 2, 8, 8, 6, 5, 3, 11])
MAX_NEW = 8
LP_ATOL = 1e-4  # fp32 logits summed in another order (test_torch_serve)
QLP_ATOL = 0.05  # an int8 rounding may flip (test_torch_serve, quantized)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _weights(cfg_items, seed=3):
    kw = dict(cfg_items)
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jc)
    return jc, jp, tc, params_from_jax(jp, tc, device="cpu")


def _serve(srv, prompts=PROMPTS):
    rids = [srv.submit(list(p), max_new=MAX_NEW) for p in prompts]
    out = srv.run()
    return ([out[r] for r in rids],
            [np.asarray(srv.requests[r].logprobs) for r in rids])


CASES = {
    "gqa_tp2_w8kv8": (GQA, 2, dict(quantize_weights=True, quantize_kv=True)),
    "gqa_tp4_w8kv8": (GQA, 4, dict(quantize_weights=True, quantize_kv=True)),
    "gqa_tp2_fp32": (GQA, 2, {}),
    "tiny_tp4_w8kv8": (TINY, 4, dict(quantize_weights=True,
                                     quantize_kv=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_server_matches_the_jax_mesh_server(case):
    cfg, tp, kw = CASES[case]
    jc, jp, tc, tparams = _weights(tuple(sorted(cfg.items())))
    jsrv = jserve.InferenceServer(
        jp, jc, mesh=jmesh.make_mesh(tp, dp=1, tp=tp), **SERVER, **kw)
    want, want_lp = _serve(jsrv)
    srv = tserve.InferenceServer(tparams, tc, mesh=tmesh.LocalMesh(1, tp,
                                                                  "cpu"),
                                 device="cpu", **SERVER, **kw)
    got, got_lp = _serve(srv)
    assert got == want
    tol = QLP_ATOL if kw else LP_ATOL
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    assert srv._decode_params.attn_split == (tc.kv_heads % tp == 0)
    pool = srv.pools_k[0][0] if kw.get("quantize_kv") else srv.pools_k[0]
    assert pool.shape[3] == (
        tc.kv_heads // tp if tc.kv_heads % tp == 0 else tc.kv_heads)


def test_w4_tp_server_matches_the_single_device_server():
    """int4 weights under tp = 2 (group scales split with their rows of a
    row-parallel matrix; the ranks' dequantized partial sums added): the
    single-device server's tokens, log-probs within LP_ATOL."""
    cfg = dict(GQA, d_model=256, d_ff=512)  # two int4 groups a rank's rows
    _, _, tc, tparams = _weights(tuple(sorted(cfg.items())))
    kw = dict(quantize_weights="int4", fused_pool=False)
    want, want_lp = _serve(tserve.InferenceServer(
        tparams, tc, device="cpu", **SERVER, **kw))
    got, got_lp = _serve(tserve.InferenceServer(
        tparams, tc, mesh=tmesh.LocalMesh(1, 2, "cpu"), device="cpu",
        **SERVER, **kw))
    assert got == want
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, atol=LP_ATOL, rtol=0)


def test_beam_search_under_tp():
    """beam_search over shard_params trees (each rank reorders the cache
    of its own kv heads): the unsharded beams and scores."""
    _, _, tc, tparams = _weights(tuple(sorted(GQA.items())))
    prompt = torch.tensor([[2, 9, 4, 7], [5, 5, 1, 3]])
    want = tgen.beam_search(tparams, prompt, tc, max_new=5, beam=3)
    got = tgen.beam_search(tmesh.shard_params(
        tparams, tmesh.LocalMesh(1, 2, "cpu"), cfg=tc), prompt, tc,
        max_new=5, beam=3)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)


def test_tp_server_equals_the_single_device_server_token_for_token():
    """The port's own single-device server, w8 + kv8: the row-parallel
    products scale each activation row by the WHOLE row's max and add the
    ranks' exact integer sums, and the prefill runs on the unsharded
    params, so a tp decode step makes the single device's products: the
    same tokens and bitwise-equal log-probs."""
    jc, jp, tc, tparams = _weights(tuple(sorted(GQA.items())))
    kw = dict(quantize_weights=True, quantize_kv=True)
    want, want_lp = _serve(tserve.InferenceServer(
        tparams, tc, device="cpu", fused_pool=False, **SERVER, **kw))
    got, got_lp = _serve(tserve.InferenceServer(
        tparams, tc, mesh=tmesh.LocalMesh(1, 2, "cpu"), device="cpu",
        **SERVER, **kw))
    assert got == want
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_array_equal(g, w)


def test_prefix_cache_under_tp():
    """The dryrun's prefix-cache phase: the second request reuses the
    first's published pages and every run gives the JAX cache-less
    server's tokens."""
    jc, jp, tc, tparams = _weights(tuple(sorted(TINY.items())))
    kw = dict(batch_slots=1, page_size=8, n_pages=32, max_pages_per_seq=4)
    prompt = list(range(1, 17)) + [50]
    jsrv = jserve.InferenceServer(jp, jc, **kw)
    rid = jsrv.submit(prompt, max_new=3)
    want = jsrv.run()[rid]
    srv = tserve.InferenceServer(tparams, tc, mesh=tmesh.LocalMesh(1, 4,
                                                                  "cpu"),
                                 prefix_cache=True, device="cpu", **kw)
    rid = srv.submit(prompt, max_new=3)
    first = srv.run()[rid]
    rid = srv.submit(prompt, max_new=3)
    second = srv.run()[rid]
    assert first == second == want
    assert srv.prefix_hit_pages >= 2


@pytest.mark.parametrize("tp", [2, 4])
def test_speculative_decoding_under_tp(tp):
    """speculative_generate over sharded target and draft (the dryrun
    passes shard_params trees): the JAX greedy generate of the target."""
    jc, jp, tc, tparams = _weights(tuple(sorted(GQA.items())), seed=5)
    _, _, _, dparams = _weights(tuple(sorted(GQA.items())), seed=6)
    prompt = np.asarray([[2, 9, 4, 7]], np.int32)
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), jc, max_new=8))
    mesh = tmesh.LocalMesh(1, tp, "cpu")
    got, rounds = tspec.speculative_generate(
        tmesh.shard_params(tparams, mesh, cfg=tc), tc,
        tmesh.shard_params(dparams, mesh, cfg=tc), tc,
        torch.from_numpy(prompt), max_new=8)
    assert np.array_equal(got.numpy(), want)
    assert 1 <= rounds <= 8
    greedy = tgen.generate(tmesh.shard_params(tparams, mesh), torch.from_numpy(
        prompt), tc, max_new=8)
    assert np.array_equal(greedy.numpy(), want)


def test_mesh_server_refuses_a_fused_pool_and_keeps_lora_for_later():
    _, _, tc, tparams = _weights(tuple(sorted(GQA.items())))
    mesh = tmesh.LocalMesh(1, 2, "cpu")
    with pytest.raises(ValueError, match="split pools"):
        tserve.InferenceServer(tparams, tc, mesh=mesh, fused_pool=True,
                               device="cpu", **SERVER)
    # multi-LoRA serving under a mesh is ported
    # (tests/test_torch_lora_serve.py): the server takes max_loras and
    # refuses an id nothing registered
    srv = tserve.InferenceServer(tparams, tc, mesh=mesh, max_loras=2,
                                 device="cpu", **SERVER)
    with pytest.raises(ValueError, match="unknown lora_id 1"):
        srv.submit([1, 2, 3], lora_id=1)
