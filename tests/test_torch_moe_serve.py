"""Port parity: InferenceServer over MoE models (Mixtral and DeepSeek
routing with MHA attention) against the JAX server, and over tp.

The same weights (the JAX init_params carried across by
models/weights.params_from_jax, the embedding scaled up so that the logits
stand apart, router biases drawn from a seed) and the same prompts go
through both servers on the CPU.  fp32 tokens are equal token for token and
log-probs within 1e-4 (fp32 sums in other orders).  With int8 or int4
weights every routed expert's three matrices are quantized on both sides
(quantize_decode_params); an int8 rounding of an activation a hair from a
.5 boundary may flip between the two frameworks, so tokens are compared
exactly and log-probs within 0.05 nat (tests/test_torch_serve.py's
convention).  Over tp the port is held to its own single-device server.
"""

import dataclasses

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
    decode_params_from_jax, params_from_jax,
)
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.utils.tree import tree_leaves

BASE = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=128, max_seq_len=64, dtype="float32")
MIXTRAL = dict(BASE, n_experts=4, moe_top_k=2)
# DeepSeek-V3's routing under MHA attention: sigmoid scores, a selection
# bias, 4 groups of which 2 stay, a routed scale, a shared expert
DEEPSEEK = dict(BASE, n_experts=8, moe_top_k=2, moe_score="sigmoid",
                moe_score_bias=True, moe_n_group=4, moe_topk_group=2,
                moe_routed_scale=2.5, n_shared_experts=1, moe_d_ff=32,
                moe_first_dense=1)
SERVER = dict(batch_slots=2, page_size=8, n_pages=32, max_pages_per_seq=4)
PROMPTS = ([3, 5, 7], [9, 1, 4, 4, 7, 2, 8, 8, 6, 5, 3, 11], [20, 21],
           [40, 2, 2, 9, 13])
MAX_NEW = 8
LP_ATOL = 1e-4
Q_LP_ATOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_CACHE = {}


def _weights(name):
    if name not in _CACHE:
        kw = {"mixtral": MIXTRAL, "deepseek": DEEPSEEK}[name]
        jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
        jp = jtf.init_params(jax.random.PRNGKey(4), jc)
        jp["embed"] = jp["embed"] * 40.0
        rng = np.random.default_rng(5)
        for blk in jp["blocks"]:
            if "router_bias" in blk:
                blk["router_bias"] = jnp.asarray(
                    rng.uniform(-0.1, 0.1, blk["router_bias"].shape),
                    jnp.float32)
        _CACHE[name] = (jc, jp, tc, params_from_jax(jp, tc, device="cpu"))
    return _CACHE[name]


def _serve(srv, prompts=PROMPTS):
    rids = [srv.submit(list(p), max_new=MAX_NEW) for p in prompts]
    out = srv.run()
    return ([out[r] for r in rids],
            [np.asarray(srv.requests[r].logprobs) for r in rids])


def _jax_served(name, **options):
    key = (name, tuple(sorted(options.items())))
    if key not in _CACHE:
        jc, jp, _, _ = _weights(name)
        _CACHE[key] = _serve(jserve.InferenceServer(jp, jc, **SERVER,
                                                    **options))
    return _CACHE[key]


def _widen_int4(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.int8) if x.dtype == jnp.int4 else x, tree)


@pytest.mark.parametrize("name,bits", [("mixtral", 8), ("deepseek", 8),
                                       ("deepseek", 4)])
def test_quantize_decode_params_quantizes_every_routed_expert(name, bits):
    """As the JAX function: each routed expert's three matrices become
    (intN, scale) pairs, bit for bit JAX's; the router, router_bias and the
    shared expert stay fp32."""
    jc, jp, tc, tp = _weights(name)
    want = decode_params_from_jax(
        _widen_int4(jserve.quantize_decode_params(jp, bits=bits)),
        device="cpu")
    got = tserve.quantize_decode_params(tp, bits=bits)
    blk = got["blocks"][-1]
    for ex in blk["experts"]:
        for w in ex.values():
            assert isinstance(w, tuple)
            assert w[0].dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert not isinstance(blk["router"], tuple)
    if "shared" in blk:
        assert all(not isinstance(w, tuple) for w in blk["shared"].values())
        assert not isinstance(blk["router_bias"], tuple)
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("name", ["mixtral", "deepseek"])
def test_fp32_server_matches_the_jax_server(name):
    jc, jp, tc, tp = _weights(name)
    want, want_lp = _jax_served(name)
    got, got_lp = _serve(tserve.InferenceServer(tp, tc, **SERVER,
                                                device="cpu"))
    assert got == want
    assert len({t for out in got for t in out}) > 2
    for a, b in zip(got_lp, want_lp):
        np.testing.assert_allclose(a, b, atol=LP_ATOL)


@pytest.mark.parametrize("name,option", [
    ("mixtral", "int8"), ("mixtral", "int4"), ("deepseek", "int8"),
    ("deepseek", "int4")])
def test_quantized_server_matches_the_jax_server(name, option):
    """w8a8 and w4a8 over every routed expert (K5's plain version over each
    expert's routed rows on the port's side)."""
    jc, jp, tc, tp = _weights(name)
    want, want_lp = _jax_served(name, quantize_weights=option)
    srv = tserve.InferenceServer(tp, tc, **SERVER, quantize_weights=option,
                                 device="cpu")
    got, got_lp = _serve(srv)
    assert all(isinstance(w, tuple) for ex in
               srv._decode_params["blocks"][-1]["experts"] for w in ex.values())
    assert got == want
    for a, b in zip(got_lp, want_lp):
        np.testing.assert_allclose(a, b, atol=Q_LP_ATOL)


def test_bursts_chunked_prefill_and_prefix_cache_keep_the_tokens():
    """decode_burst 4, prefill_chunk 8 and the prefix cache reach the MoE
    MLP through the same decode step: the plain server's tokens."""
    _, _, tc, tp = _weights("deepseek")
    want, _ = _serve(tserve.InferenceServer(tp, tc, **SERVER, device="cpu"))
    prompts = PROMPTS + (PROMPTS[1] + [4, 4],)
    want += _serve(tserve.InferenceServer(tp, tc, **SERVER, device="cpu"),
                   prompts[-1:])[0]
    for kw in (dict(decode_burst=4), dict(prefill_chunk=8),
               dict(prefix_cache=True)):
        got, _ = _serve(tserve.InferenceServer(tp, tc, **SERVER, **kw,
                                               device="cpu"), prompts)
        assert got == want, kw


@pytest.mark.parametrize("options", [{}, dict(quantize_weights=True,
                                              quantize_kv=True)])
def test_tp_server_equals_the_single_device_server(options):
    """Mixtral over LocalMesh(1, 2): each rank its kv head's split pools
    and every expert's slices, one all-reduce a block's experts; the
    single device's tokens, log-probs within 1e-4 (fp) or 0.05 (int8)."""
    _, _, tc, tp = _weights("mixtral")
    want, want_lp = _serve(tserve.InferenceServer(tp, tc, **SERVER,
                                                  **options, device="cpu"))
    srv = tserve.InferenceServer(tp, tc, **SERVER, **options,
                                 mesh=tmesh.LocalMesh(1, 2, "cpu"))
    got, got_lp = _serve(srv)
    assert got == want
    tol = Q_LP_ATOL if options else LP_ATOL
    for a, b in zip(got_lp, want_lp):
        np.testing.assert_allclose(a, b, atol=tol)
    ex = srv._decode_params.local[1]["blocks"][0]["experts"][0]
    w_gate = ex["w_gate"][0] if options else ex["w_gate"]
    assert w_gate.shape == (64, 64)  # its half of d_ff 128


def test_decode_param_specs_give_experts_as_jax_does():
    from jax.sharding import PartitionSpec as JP

    jc, jp, tc, tp = _weights("mixtral")
    for q in (False, True):
        jparams = jserve.quantize_decode_params(jp) if q else jp
        tparams = tserve.quantize_decode_params(tp) if q else tp
        want = jserve.decode_param_specs(jparams)
        got = tserve.decode_param_specs(tparams)
        flat_w = jax.tree_util.tree_leaves(
            want, is_leaf=lambda x: isinstance(x, JP))
        flat_g = [s for s in _spec_leaves(got)]
        assert [tuple(s) for s in flat_g] == [tuple(s) for s in flat_w]


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k])
    elif isinstance(tree, list) or (isinstance(tree, tuple) and not
                                    isinstance(tree, tmesh.P)):
        for v in tree:
            yield from _spec_leaves(v)
    else:
        yield tree


def test_tp_serving_refuses_what_the_jax_server_cannot_shard():
    """DeepSeek routing keeps "shared" and "router_bias", for which the JAX
    decode_param_specs has no spec: the JAX server fails on them under a
    mesh (a KeyError) and the port refuses them by name."""
    from jax.sharding import Mesh

    jc, jp, tc, tp = _weights("deepseek")
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    with pytest.raises(KeyError):
        jserve.InferenceServer(jp, jc, **SERVER, mesh=mesh)
    with pytest.raises(NotImplementedError, match="shared.*router_bias"):
        tserve.InferenceServer(tp, tc, **SERVER,
                               mesh=tmesh.LocalMesh(1, 2, "cpu"))
    plain = dataclasses.replace(tc, moe_score_bias=False,
                                n_shared_experts=0)
    params = ttf.init_params(0, plain, device="cpu")
    tserve.InferenceServer(params, plain, **SERVER,
                           mesh=tmesh.LocalMesh(1, 2, "cpu"))
