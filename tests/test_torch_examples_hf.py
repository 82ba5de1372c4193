"""The hermetic checkpoints of the examples serve_hf (a tiny Llama) and
serve_deepseek (a tiny DeepSeek-V3), which the port writes without
transformers (config.json and model.safetensors, the weights through
models/hf.to_hf), are real Hugging Face layouts: the JAX package's from_hf
reads each directory through transformers' AutoModelForCausalLM into the
config and the params the port's from_hf reads, leaf for leaf.  Kept apart
from tests/test_torch_examples.py because only these cases pay the
transformers import."""

import dataclasses

import numpy as np
import pytest

import jax

from kfunca_tpu_torch.examples import serve_deepseek, serve_hf
from kfunca_tpu_torch.models import hf as thf
from kfunca_tpu_torch.utils.tree import tree_leaves
from torch_parity import one_thread  # noqa: F401


@pytest.mark.parametrize("name", ["serve_hf", "serve_deepseek"])
def test_hermetic_checkpoint_reads_back_through_the_jax_from_hf(name,
                                                                tmp_path):
    from kfunca_tpu.models import hf as jhf

    write = {"serve_hf": serve_hf.write_tiny_llama,
             "serve_deepseek": serve_deepseek.write_tiny_deepseek}[name]
    write(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "config.json", "model.safetensors"]
    tp, tc = thf.from_hf(tmp_path, dtype="float32", device="cpu")
    jp, jc = jhf.from_hf(str(tmp_path), dtype="float32")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    got, want = tree_leaves(tp), jax.tree_util.tree_leaves(jp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
