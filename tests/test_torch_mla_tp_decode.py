"""Port parity: an MLA model decoding under tensor parallelism.

generate, beam_search and speculative_generate over a ShardedParams of an
MLA TransformerConfig (d_model 64, 4 heads, kv_lora_rank 16; dense, and
with 4 routed experts behind a dense first layer): each rank keeps its own
latent cache and attends with its own heads over the replicated latent.
The tokens are held to the JAX functions over jmesh.shard_params on the
conftest's virtual CPU devices, in fp32, exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import generate as jgen
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.parallel import mesh as jmesh
from kfunca_tpu_torch.models import generate as tgen
from kfunca_tpu_torch.models import speculative as tspec
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax
from kfunca_tpu_torch.parallel import mesh as tmesh
from torch_parity import one_thread  # noqa: F401

MLA = dict(vocab_size=96, d_model=64, n_heads=4, n_layers=2, d_ff=96,
           max_seq_len=64, dtype="float32", attention="mla",
           kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, rope_interleave=True)
MOE = dict(n_experts=4, moe_top_k=2, moe_d_ff=32, moe_first_dense=1)
KINDS = {"dense": {}, "routed": MOE}
PROMPT = np.asarray([[5, 17, 3, 40, 9, 2]], np.int32)
PROMPTS = np.asarray([[5, 17, 3, 40, 9, 2], [8, 8, 61, 4, 30, 77]], np.int32)
MAX_NEW = 8


@functools.lru_cache(maxsize=None)
def _model(kind):
    kw = {**MLA, **KINDS[kind]}
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(7), jc)
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    for blk in jp["blocks"]:  # norms off 1, as a trained model's
        for key in ("attn_norm", "mlp_norm", "kv_norm", "q_norm"):
            blk[key] = blk[key] + rng.normal(0, 0.1, blk[key].shape).astype(
                np.float32)
    return jc, jp, tc, params_from_jax(jp, tc, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_sharded(kind, tp):
    jc, jp, _, _ = _model(kind)
    mesh = jmesh.make_mesh(tp, dp=1, tp=tp)
    sharded = jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, jp),
                                 mesh)
    with mesh:
        greedy = np.asarray(jgen.generate(sharded, jnp.asarray(PROMPTS), jc,
                                          max_new=MAX_NEW))
        seqs, scores = jgen.beam_search(sharded, jnp.asarray(PROMPT), jc,
                                        max_new=MAX_NEW, beam=3)
    return greedy, np.asarray(seqs), np.asarray(scores)


def _sharded(kind, tp):
    _, _, tc, tparams = _model(kind)
    return tmesh.shard_params(tparams, tmesh.LocalMesh(1, tp, "cpu"), cfg=tc)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_mla_generate_gives_the_jax_tokens(kind, tp):
    """Greedy tokens over tp equal the JAX sharded generate's, and the
    unsharded port's."""
    want, _, _ = _jax_sharded(kind, tp)
    sp = _sharded(kind, tp)
    assert sp.attn_split
    got = tgen.generate(sp, torch.from_numpy(PROMPTS), _model(kind)[2],
                        MAX_NEW)
    assert np.array_equal(got.numpy(), want)
    single = tgen.generate(_model(kind)[3], torch.from_numpy(PROMPTS),
                           _model(kind)[2], MAX_NEW)
    assert np.array_equal(single.numpy(), want)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_mla_beam_search_gives_the_jax_beams(kind, tp):
    """Beams over tp (the latent caches reordered by parent each step)
    equal the JAX sharded beam_search's; scores within 1e-4."""
    _, want, want_scores = _jax_sharded(kind, tp)
    seqs, scores = tgen.beam_search(_sharded(kind, tp),
                                    torch.from_numpy(PROMPT),
                                    _model(kind)[2], MAX_NEW, beam=3)
    assert np.array_equal(seqs.numpy(), want)
    np.testing.assert_allclose(scores.numpy(), want_scores, atol=1e-4)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_mla_speculative_gives_the_jax_greedy_tokens(kind, tp):
    """speculative_generate over a sharded MLA target and draft (the draft
    the same model with other weights): the JAX sharded greedy tokens of
    the target."""
    want, _, _ = _jax_sharded(kind, tp)
    _, _, tc, _ = _model(kind)
    jd = jtf.init_params(jax.random.PRNGKey(8), jtf.TransformerConfig(
        **{**MLA, **KINDS[kind]}))
    draft = tmesh.shard_params(params_from_jax(jd, tc, device="cpu"),
                               tmesh.LocalMesh(1, tp, "cpu"), cfg=tc)
    got, rounds = tspec.speculative_generate(
        _sharded(kind, tp), tc, draft, tc, torch.from_numpy(PROMPT),
        max_new=MAX_NEW, gamma=3)
    assert np.array_equal(got.numpy(), want[:1])
    assert 1 <= rounds <= MAX_NEW


def test_each_rank_keeps_a_latent_cache_of_its_own():
    """new_cache under tp: one latent cache a rank, (B, L, kv_lora_rank)
    and (B, L, rope) a layer whatever the rank's heads."""
    sp = _sharded("dense", 2)
    caches = tgen.new_cache(sp, _model("dense")[2], 2, 16)
    assert len(caches) == 2
    for cache in caches:
        assert [sorted(c) for c in cache] == [["ckv", "kpe"]] * 2
        assert cache[0]["ckv"].shape == (2, 16, 16)
        assert cache[0]["kpe"].shape == (2, 16, 8)
    assert caches[0][0]["ckv"].data_ptr() != caches[1][0]["ckv"].data_ptr()
