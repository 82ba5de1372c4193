"""Port parity: generate() and beam_search() of kfunca_tpu_torch.

Both packages decode from the same fp32 weights (carried across by
models/weights.params_from_jax) and the same prompts.  Greedy tokens and
beam-search tokens must be equal; beam scores, sums of fp32 log-probs
computed in another summation order, agree to SCORE_ATOL.  Sampled
generation draws from torch.Generator where JAX draws from jax.random, so
it is checked for determinism per generator and by its distribution, never
against the JAX tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import generate as jgen
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import generate as tgen
from kfunca_tpu_torch.models import serve as tserve
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax

SMALL = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=256, max_seq_len=128, dtype="float32")
MAX_NEW = 8
# a beam's score sums up to MAX_NEW fp32 log-probs of about -5 each, every
# one off by ~1e-6 between the frameworks
SCORE_ATOL = 1e-4


@pytest.fixture(scope="module", params=[None, 6], ids=["full", "window6"])
def model(request):
    kw = dict(SMALL, attention_window=request.param)
    jc, tc = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(3), jc)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, (2, 11)).astype(np.int32)
    return dict(jc=jc, tc=tc, jp=jp, tp=params_from_jax(jp, tc, device="cpu"),
                prompt=prompt)


def test_greedy_generate_equals_jax(model):
    want = np.asarray(jgen.generate(model["jp"], jnp.asarray(model["prompt"]),
                                    model["jc"], MAX_NEW))
    got = tgen.generate(model["tp"], torch.from_numpy(model["prompt"]),
                        model["tc"], MAX_NEW)
    assert got.dtype == torch.int32 and got.shape == (2, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_equals_the_server(model):
    """generate() and the paged server decode the same tokens."""
    got = tgen.generate(model["tp"], torch.from_numpy(model["prompt"]),
                        model["tc"], MAX_NEW)
    srv = tserve.InferenceServer(model["tp"], model["tc"], device="cpu",
                                 batch_slots=2, page_size=4, n_pages=24,
                                 max_pages_per_seq=8)
    rids = [srv.submit(p.tolist(), max_new=MAX_NEW) for p in model["prompt"]]
    out = srv.run()
    assert [out[r] for r in rids] == got.tolist()


@pytest.mark.parametrize("kw", [dict(beam=3), dict(beam=4, length_penalty=0.8),
                                dict(beam=3, eos="pick"),
                                dict(beam=2, eos="pick", length_penalty=1.0)],
                         ids=["beam3", "beam4-penalty", "eos", "eos-penalty"])
def test_beam_search_equals_jax(model, kw):
    kw = dict(kw)
    if kw.get("eos") == "pick":
        # a token the greedy path emits early, so beams do finish
        greedy = tgen.generate(model["tp"], torch.from_numpy(model["prompt"]),
                               model["tc"], MAX_NEW)
        kw["eos"] = int(greedy[0, 2])
    jt, js = jgen.beam_search(model["jp"], jnp.asarray(model["prompt"]),
                              model["jc"], MAX_NEW, **kw)
    tt, ts = tgen.beam_search(model["tp"], torch.from_numpy(model["prompt"]),
                              model["tc"], MAX_NEW, **kw)
    assert tt.dtype == torch.int32 and tt.shape == (2, kw["beam"], MAX_NEW)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL,
                               rtol=0)
    assert (np.diff(ts.numpy(), axis=1) <= 0).all()  # best first
    if kw.get("eos") is not None:  # a finished beam emits eos from then on
        for seq in tt.reshape(-1, MAX_NEW).tolist():
            if kw["eos"] in seq:
                at = seq.index(kw["eos"])
                assert seq[at:] == [kw["eos"]] * (MAX_NEW - at)


def test_beam_one_is_greedy(model):
    prompt = torch.from_numpy(model["prompt"])
    toks, scores = tgen.beam_search(model["tp"], prompt, model["tc"], MAX_NEW,
                                    beam=1)
    greedy = tgen.generate(model["tp"], prompt, model["tc"], MAX_NEW)
    assert torch.equal(toks[:, 0], greedy)
    assert bool((scores < 0).all())


def test_sampled_generate_is_deterministic_per_generator(model):
    prompt = torch.from_numpy(model["prompt"])

    def draw(seed):
        return tgen.generate(model["tp"], prompt, model["tc"], MAX_NEW,
                             temperature=1.0,
                             generator=torch.Generator().manual_seed(seed))

    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))
    # no generator: seeded with 0, as the JAX function's key defaults to
    # PRNGKey(0)
    default = tgen.generate(model["tp"], prompt, model["tc"], MAX_NEW,
                            temperature=1.0)
    assert torch.equal(default, draw(0))


def test_sampled_first_token_follows_the_model_distribution(model):
    """4000 lanes of one prompt at temperature 1: the first sampled token's
    frequencies match softmax(logits) within 0.03 (about 4 binomial
    standard deviations at p = 0.05, far wider at this model's p < 0.02)."""
    prompt = torch.from_numpy(model["prompt"][:1]).repeat(4000, 1)
    toks = tgen.generate(model["tp"], prompt, model["tc"], 1, temperature=1.0,
                         generator=torch.Generator().manual_seed(5))
    logits, _ = tgen.forward_with_cache(
        model["tp"], prompt[:1], tgen.init_kv_cache(model["tc"], 1, 11, "cpu"),
        0, model["tc"])
    want = torch.softmax(logits[0, -1], dim=-1).numpy()
    freq = np.bincount(toks[:, 0].numpy(), minlength=256) / 4000
    np.testing.assert_allclose(freq, want, atol=0.03)
