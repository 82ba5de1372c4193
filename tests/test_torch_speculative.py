"""Port parity: speculative decoding (kfunca_tpu_torch/models/
speculative.py).  Greedy speculative generation must give the JAX
function's tokens and round count and the port's own generate's tokens,
whatever the draft.  The sampled form draws from a torch.Generator, so it
is held to the target's softmax by its distribution over many draws, never
to the JAX tokens."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import speculative as jspec
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.generate import forward_with_cache, generate
from kfunca_tpu_torch.models.generate import init_kv_cache
from kfunca_tpu_torch.models.speculative import (
    speculative_generate, speculative_generate_sampled)
from kfunca_tpu_torch.models.weights import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: one intra-op thread runs them faster than
    many, and leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mk(seed, layers=2, vocab=64):
    kw = dict(vocab_size=vocab, d_model=32, n_heads=2, n_layers=layers,
              d_ff=64, max_seq_len=128, dtype="float32")
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jc)
    return jp, jc, params_from_jax(jp, tc, device="cpu"), tc


@pytest.fixture(scope="module")
def models():
    return {"target": _mk(0), "weak": _mk(7), "shallow": _mk(0, layers=1)}


@pytest.mark.parametrize("draft,gamma,prompt,max_new", [
    ("weak", 3, [3, 11, 25, 2], 12), ("weak", 1, [1, 2, 3], 9),
    ("target", 3, [5, 9], 12), ("shallow", 4, [7], 10)],
    ids=["weak_g3", "weak_g1", "perfect_g3", "shallow_one_token_prompt"])
def test_greedy_matches_jax_and_generate(models, draft, gamma, prompt,
                                         max_new):
    jp_t, jc_t, tp_t, tc_t = models["target"]
    jp_d, jc_d, tp_d, tc_d = models[draft]
    got, rounds = speculative_generate(tp_t, tc_t, tp_d, tc_d,
                                       torch.tensor([prompt]), max_new, gamma)
    want, jrounds = jspec.speculative_generate(
        jp_t, jc_t, jp_d, jc_d, jnp.asarray([prompt], jnp.int32),
        max_new=max_new, gamma=gamma)
    assert got.dtype == torch.int32 and got.shape == (1, max_new)
    assert got.tolist() == np.asarray(want).tolist()
    assert rounds == int(jrounds)
    assert torch.equal(got, generate(tp_t, torch.tensor([prompt]), tc_t,
                                     max_new))
    if draft == "target":  # a perfect draft commits gamma + 1 a round
        assert rounds <= -(-max_new // (gamma + 1)) + 1


def test_refuses_a_batch(models):
    _, _, tp, tc = models["target"]
    with pytest.raises(ValueError, match="one sequence"):
        speculative_generate(tp, tc, tp, tc,
                             torch.zeros((2, 3), dtype=torch.long), 4)


def test_sampled_first_token_is_distributed_as_the_target():
    """With a draft that disagrees with the target (so both acceptance and
    rejection-resampling run), over 1000 generators the first sampled
    token's frequencies match softmax(target logits / T) (vocab 8): total
    variation below 0.08, about 2.4 times its expected sampling noise
    (~0.033)."""
    _, _, tp_t, tc_t = _mk(0, vocab=8)
    _, _, tp_d, tc_d = _mk(7, vocab=8)
    prompt = torch.tensor([[1, 5, 2]])
    temperature = 0.7
    cache = init_kv_cache(tc_t, 1, 3, "cpu")
    logits, _ = forward_with_cache(tp_t, prompt, cache, 0, tc_t)
    want = torch.softmax(logits[0, -1] / temperature, -1).numpy()
    counts = np.zeros(8)
    n = 1000
    for seed in range(n):
        out, rounds = speculative_generate_sampled(
            tp_t, tc_t, tp_d, tc_d, prompt, 1, gamma=1,
            temperature=temperature,
            generator=torch.Generator().manual_seed(seed))
        counts[int(out[0, 0])] += 1
        assert rounds == 1
    tv = 0.5 * np.abs(counts / n - want).sum()
    assert tv < 0.08, (counts / n, want)


def test_sampled_mechanics(models):
    """Deterministic for a given generator, every token in the vocab, and
    a perfect draft accepting everything at temperature ~0."""
    _, _, tp_t, tc_t = models["target"]
    _, _, tp_d, tc_d = models["weak"]
    prompt = torch.tensor([[3, 11, 25, 2]])
    a = speculative_generate_sampled(
        tp_t, tc_t, tp_d, tc_d, prompt, 10, gamma=3,
        generator=torch.Generator().manual_seed(4))
    b = speculative_generate_sampled(
        tp_t, tc_t, tp_d, tc_d, prompt, 10, gamma=3,
        generator=torch.Generator().manual_seed(4))
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    assert a[0].shape == (1, 10) and int(a[0].max()) < tc_t.vocab_size
    # near temperature 0 the draft and the target (here the same model,
    # whose one-token and four-token forwards sum in other orders) both
    # put their mass on the argmax: greedy tokens, most drafts accepted
    cold, rounds = speculative_generate_sampled(
        tp_t, tc_t, tp_t, tc_t, prompt, 12, gamma=3, temperature=1e-4)
    assert torch.equal(cold, generate(tp_t, prompt, tc_t, 12))
    assert rounds < 12
