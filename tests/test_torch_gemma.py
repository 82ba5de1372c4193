"""Port parity: the Gemma family at head dim 256 (google/gemma-2b's head
width), the width at which the CUDA attention kernels run their hd-256
instances.

A Gemma config (norm="rms_offset", GeGLU, sqrt(d) embedding scale, tied
head) with 2 query heads over 1 kv head of 256: d_model 512, 2 layers,
vocab 96, fp32.  The JAX init_params are carried across by
models/weights.params_from_jax, and the same numpy tokens go through both
packages on the CPU: forward logits, a train step's loss and every
gradient, InferenceServer's greedy tokens, and the HF export round trip.
Tolerances: logits 1e-4 of their largest magnitude, the loss 1e-5 and each
gradient leaf 1e-4 of its largest entry (fp32 sums in another order);
tokens exactly, log-probs 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import hf as jhf
from kfunca_tpu.models import serve as jserve
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.models import hf as thf
from kfunca_tpu_torch.models import serve as tserve
from kfunca_tpu_torch.models import train as ttr
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax, tree_to_numpy

from torch_parity import (close, leaf_close, one_thread,  # noqa: F401
                          trees_close)

GEMMA = dict(vocab_size=96, d_model=512, n_heads=2, n_kv_heads=1,
             n_layers=2, d_ff=1024, max_seq_len=64, dtype="float32",
             norm="rms_offset", mlp_type="geglu", embed_scale=True)
SERVER = dict(batch_slots=2, page_size=8, n_pages=24, max_pages_per_seq=6)
LENGTHS = (5, 6, 7)  # one prefill shape; decode crosses into a second page
MAX_NEW = 6


@pytest.fixture(scope="module")
def shared():
    jc, tc = jtf.TransformerConfig(**GEMMA), ttf.TransformerConfig(**GEMMA)
    assert tc.head_dim == 256 and tc.kv_heads == 1
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 96, (2, 24)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    return dict(jc=jc, tc=tc, jp=jp, tp=params_from_jax(jp, tc, device="cpu"),
                tokens=tokens, targets=targets)


def test_the_config_is_gemma_at_head_dim_256(shared):
    """The HF mapping of a Gemma config.json gives this config (tied head:
    no lm_head leaf)."""
    raw = dict(model_type="gemma", vocab_size=96, hidden_size=512,
               intermediate_size=1024, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=1,
               max_position_embeddings=64)
    cfg = thf.config_from_hf(thf.with_config_defaults(raw), dtype="float32")
    assert cfg == shared["tc"]
    assert "lm_head" not in shared["tp"]


def test_forward_logits_match_jax(shared):
    want = np.asarray(jax.jit(jtf.forward, static_argnums=2)(
        shared["jp"], jnp.asarray(shared["tokens"]), shared["jc"]))
    with torch.no_grad():
        got = ttf.forward(shared["tp"], torch.from_numpy(shared["tokens"]),
                          shared["tc"])
    close(got, want, 1e-4, "logits")


def test_train_step_loss_and_gradients_match_jax(shared):
    """loss_fn's value and every gradient leaf, then one AdamW step of
    make_train_step from the same state: the loss it reports is the JAX
    loss_fn's at these params."""
    jc, tc = shared["jc"], shared["tc"]
    tokens, targets = shared["tokens"], shared["targets"]
    want, jgrads = jax.jit(jax.value_and_grad(jtf.loss_fn),
                           static_argnums=3)(
        shared["jp"], jnp.asarray(tokens), jnp.asarray(targets), jc)
    leaves = [t.clone().requires_grad_(True)
              for t in jax.tree_util.tree_leaves(shared["tp"])]
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shared["tp"]), leaves)
    loss = ttf.loss_fn(params, torch.from_numpy(tokens),
                       torch.from_numpy(targets), tc)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want)) <= 1e-5
    trees_close(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shared["tp"]), list(grads)), jgrads,
        1e-4, leaf_close)

    toc = ttr.OptConfig(lr=1e-3)
    tp = jax.tree_util.tree_map(torch.clone, shared["tp"])
    step = ttr.make_train_step(tc, toc, device="cpu")
    _, _, tloss = step(tp, ttr.init_opt_state(tp, toc, device="cpu"),
                       tokens, targets)
    assert abs(float(tloss) - float(want)) <= 1e-5


def _drive(srv, prompts):
    rids = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
    lps = [lp for _, _, lp, _ in srv.stream()]
    return [list(srv.requests[r].tokens) for r in rids], np.asarray(lps)


@pytest.mark.usefixtures("one_thread")
def test_server_greedy_tokens_match_the_jax_server(shared):
    """Paged decode over the fused pool (1 kv head x 256 = a 256-wide [k|v]
    page row): the JAX server's greedy tokens, log-probs within 1e-4."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 96, n).tolist() for n in LENGTHS]
    want, want_lps = _drive(
        jserve.InferenceServer(shared["jp"], shared["jc"], **SERVER), prompts)
    srv = tserve.InferenceServer(shared["tp"], shared["tc"], device="cpu",
                                 **SERVER)
    assert srv.fused_pool
    got, got_lps = _drive(srv, prompts)
    assert got == want
    np.testing.assert_allclose(got_lps, want_lps, atol=1e-4, rtol=0)


def test_hf_export_round_trips_and_matches_jax(shared):
    """to_hf gives the JAX package's state dict (the same names, values
    bit for bit), with no lm_head.weight (tied), and params_from_hf reads
    it back to the same params."""
    got = thf.to_hf(shared["tp"], shared["tc"])
    want = jhf.to_hf(shared["jp"], shared["jc"])
    assert sorted(got) == sorted(want)
    assert "lm_head.weight" not in got
    for name, t in got.items():
        assert np.array_equal(t.numpy(), np.asarray(want[name], np.float32)), \
            name
    back = thf.params_from_hf(got, shared["tc"], device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(back)),
                    jax.tree_util.tree_leaves(tree_to_numpy(shared["tp"]))):
        assert np.array_equal(a, b)
