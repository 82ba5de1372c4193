"""Port parity: MLAServer (models/mla_serve.py) against the JAX MLAServer.

The same weights (the JAX init_params carried across by
models/weights.params_from_jax, the embedding scaled up so that the
logits stand apart) and the same prompts go through both servers in fp32
on the CPU; greedy tokens must be equal token for token over mixed prompt
lengths, more requests than slots, EOS and a max_seq_len that is not a
power of two.  Sampled tokens draw from a torch.Generator, so they match
the JAX server in distribution only: they are checked for range and for
reproducibility within the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import mla_serve as jms
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import mla_serve as tms
from kfunca_tpu_torch.models import serve as tserve
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.generate import generate
from kfunca_tpu_torch.models.weights import params_from_jax

MLA = dict(vocab_size=96, d_model=64, n_heads=4, n_layers=2, d_ff=96,
           max_seq_len=64, dtype="float32", attention="mla", kv_lora_rank=16,
           qk_nope_head_dim=8, qk_rope_head_dim=8)
# DeepSeek-V3's form: a low-rank query, interleaved rope, unequal head dims,
# a dense first layer and a sigmoid-routed, group-limited MoE after it
DEEPSEEK = dict(MLA, q_lora_rank=24, qk_nope_head_dim=16, v_head_dim=16,
                rope_interleave=True, n_experts=8, moe_top_k=2,
                moe_score="sigmoid", moe_score_bias=True, moe_n_group=4,
                moe_topk_group=2, moe_routed_scale=2.5, n_shared_experts=1,
                moe_d_ff=32, moe_first_dense=1)
LENGTHS = (3, 9, 17, 5, 30, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_CACHE = {}


def _weights(name):
    if name not in _CACHE:
        kw = {"mla": MLA, "deepseek": DEEPSEEK}[name]
        jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
        jp = jtf.init_params(jax.random.PRNGKey(2), jc)
        jp["embed"] = jp["embed"] * 40.0
        rng = np.random.default_rng(3)
        for blk in jp["blocks"]:
            if "router_bias" in blk:
                blk["router_bias"] = jnp.asarray(
                    rng.uniform(-0.1, 0.1, blk["router_bias"].shape),
                    jnp.float32)
        _CACHE[name] = (jc, jp, tc, params_from_jax(jp, tc, device="cpu"))
    return _CACHE[name]


def _prompts(seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 96, n).tolist() for n in lengths]


def _drive(srv, prompts, max_new=8):
    rids = [srv.submit(p, max_new=max_new) for p in prompts]
    out = srv.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("name", ["mla", "deepseek"])
def test_greedy_tokens_equal_the_jax_server(name):
    """Six requests over two slots, prompt lengths 1 to 30 (buckets 1 to
    32), 8 new tokens each."""
    jc, jp, tc, tp = _weights(name)
    prompts = _prompts()
    want = _drive(jms.MLAServer(jp, jc, batch_slots=2, max_seq_len=48),
                  prompts)
    srv = tms.MLAServer(tp, tc, batch_slots=2, max_seq_len=48, device="cpu")
    got = _drive(srv, prompts)
    assert got == want
    assert len({t for out in got for t in out}) > 2
    assert srv.decode_steps > 0


def test_greedy_tokens_equal_generate():
    """The served tokens are generate's (the batch-1 cached forward) for
    each prompt."""
    _, _, tc, tp = _weights("deepseek")
    prompts = _prompts(1, (4, 11, 7))
    got = _drive(tms.MLAServer(tp, tc, batch_slots=3, max_seq_len=32,
                               device="cpu"), prompts, max_new=6)
    for p, out in zip(prompts, got):
        want = generate(tp, torch.tensor([p]), tc, max_new=6)[0].tolist()
        assert out == want


def test_eos_frees_the_slot():
    """A request stops at its EOS (kept as its last token; here the first
    token its prefill samples) and its slot takes the next request; tokens
    equal the JAX server's."""
    jc, jp, tc, tp = _weights("deepseek")
    prompts = _prompts(2, (5, 8, 3, 6))
    free = _drive(tms.MLAServer(tp, tc, batch_slots=2, max_seq_len=40,
                                device="cpu"), prompts, max_new=10)
    eos = free[0][0]
    want = _drive(jms.MLAServer(jp, jc, batch_slots=2, max_seq_len=40,
                                eos_token=eos), prompts, max_new=10)
    got = _drive(tms.MLAServer(tp, tc, batch_slots=2, max_seq_len=40,
                               eos_token=eos, device="cpu"), prompts,
                 max_new=10)
    assert got == want
    assert got[0] == [eos]
    assert all(out == free[k] for k, out in enumerate(got)
               if eos not in free[k])


def test_oversize_request_is_refused():
    _, _, tc, tp = _weights("mla")
    srv = tms.MLAServer(tp, tc, batch_slots=2, max_seq_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        srv.submit(list(range(10)), max_new=7)
    srv.submit(list(range(10)), max_new=6)  # 16 positions fit


def test_non_power_of_two_max_seq_len_clamps_the_bucket():
    """max_seq_len 40: a 30-token prompt buckets to 32, a 37-token one to
    40 (not 64, which would overrun the cache); tokens equal the JAX
    server's."""
    jc, jp, tc, tp = _weights("mla")
    prompts = _prompts(3, (37, 30))
    want = _drive(jms.MLAServer(jp, jc, batch_slots=2, max_seq_len=40),
                  prompts, max_new=3)
    got = _drive(tms.MLAServer(tp, tc, batch_slots=2, max_seq_len=40,
                               device="cpu"), prompts, max_new=3)
    assert got == want


def test_sampled_requests_reproduce_and_stay_in_range():
    """A sampled request beside greedy ones: the greedy ones keep the
    all-greedy tokens, the sampled one lies in the vocabulary and repeats
    under the same seed."""
    _, _, tc, tp = _weights("mla")
    prompts = _prompts(4, (6, 9, 4))

    def run(seed):
        srv = tms.MLAServer(tp, tc, batch_slots=3, max_seq_len=32,
                            seed=seed, device="cpu")
        rids = [srv.submit(p, max_new=8, temperature=t)
                for p, t in zip(prompts, (0.0, 1.0, 0.0))]
        out = srv.run()
        return [out[r] for r in rids]

    a, b = run(5), run(5)
    greedy = _drive(tms.MLAServer(tp, tc, batch_slots=3, max_seq_len=32,
                                  device="cpu"), prompts)
    assert a == b
    assert a[0] == greedy[0] and a[2] == greedy[2]
    assert all(0 <= t < 96 for t in a[1])


def test_latent_cache_is_small_and_the_paged_engine_points_to_it():
    """The slots hold (kv_lora_rank + qk_rope) values a position a layer;
    InferenceServer refuses an MLA config and names MLAServer."""
    _, _, tc, tp = _weights("deepseek")
    srv = tms.MLAServer(tp, tc, batch_slots=2, max_seq_len=16, device="cpu")
    assert srv.cache_bytes() == 2 * 2 * 16 * (16 + 8) * 4
    with pytest.raises(NotImplementedError, match="MLAServer"):
        tserve.InferenceServer(tp, tc, device="cpu")
    with pytest.raises(ValueError, match="MLA"):
        tms.MLAServer(tp, ttf.TransformerConfig(**dict(
            MLA, attention="mha")), device="cpu")
