"""Port parity: HF ViT checkpoints (kfunca_tpu_torch/models/hf_vision.py).

A directory written by transformers' ViTModel.save_pretrained (a tiny
random config) is read by the port's from_hf_vit without transformers and
by the JAX from_hf_vit from the model instance: the params are the same
numbers, and hf_vit_encode (CLS in slot 0) and hf_vit_pooled agree within
1e-5 x max(1, max |ref|) in fp32 on the CPU, and with transformers' own
outputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kfunca_tpu.models import hf_vision as jh
from kfunca_tpu_torch.models import hf as thf
from kfunca_tpu_torch.models import hf_vision as th
from kfunca_tpu_torch.models.weights import hf_vit_params_from_jax
from torch_parity import close, one_thread, trees_close  # noqa: F401

OUT_TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    transformers = pytest.importorskip("transformers")
    hc = transformers.ViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, image_size=32, patch_size=8, num_channels=3,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        attn_implementation="eager")
    torch.manual_seed(6)
    return transformers.ViTModel(hc).eval()


@pytest.fixture(scope="module")
def loaded(model, tmp_path_factory):
    path = tmp_path_factory.mktemp("vit")
    model.save_pretrained(path)
    jp, jc = jh.from_hf_vit(model)
    tp, tc = th.from_hf_vit(path, device="cpu")
    return jp, jc, tp, tc


def _images(seed, b=2):
    """(B, C, H, W) as transformers takes them, and (B, H, W, C)."""
    chw = np.random.default_rng(seed).uniform(-1, 1, (b, 3, 32, 32)).astype(
        np.float32)
    return chw, np.ascontiguousarray(np.transpose(chw, (0, 2, 3, 1)))


def test_directory_gives_the_jax_params(model, loaded):
    jp, jc, tp, tc = loaded
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.n_patches == 16 and "pooler_w" in tp
    trees_close(tp, jp, 0.0)  # the same numbers, bit for bit
    ip, icfg = th.from_hf_vit(model, device="cpu")
    assert icfg == tc
    trees_close(ip, tp, 0.0)


def test_encode_and_pooler_match_jax_and_transformers(model, loaded):
    jp, jc, tp, tc = loaded
    chw, hwc = _images(6)
    want = jh.hf_vit_encode(jp, jnp.asarray(hwc), jc)
    got = th.hf_vit_encode(tp, torch.from_numpy(hwc), tc)
    assert got.shape == (2, 17, 64)  # (B, N + 1, d), CLS in slot 0
    close(got, want, OUT_TOL)
    pooled = th.hf_vit_pooled(tp, torch.from_numpy(hwc), tc)
    close(pooled, jh.hf_vit_pooled(jp, jnp.asarray(hwc), jc), OUT_TOL)
    with torch.no_grad():
        ref = model(torch.from_numpy(chw))
    close(got, ref.last_hidden_state, 2e-4)
    close(pooled, ref.pooler_output, 2e-4)


def test_patch_matmul_is_the_conv(model, loaded):
    _, _, tp, tc = loaded
    chw, hwc = _images(7, 1)
    with torch.no_grad():
        want = model.embeddings.patch_embeddings(torch.from_numpy(chw))
    got = th._patchify(torch.from_numpy(hwc), tc) @ tp["patch_w"] \
        + tp["patch_b"]
    close(got, want, OUT_TOL)


def test_converter_checks_every_leaf(loaded):
    jp, jc, tp, tc = loaded
    host = {k: v for k, v in jp.items()}
    got = hf_vit_params_from_jax(host, tc, device="cpu")
    trees_close(got, tp, 0.0)
    host["cls"] = np.zeros((2, 64), np.float32)
    with pytest.raises(ValueError, match="cls"):
        hf_vit_params_from_jax(host, tc, device="cpu")


@pytest.mark.parametrize("mt", sorted(thf.FAMILY_CONFIG_DEFAULTS))
def test_family_config_defaults_are_transformers_defaults(mt):
    """The defaults the family loaders put under a config.json (Mamba,
    Mamba-2, BERT, ViT) are the ones transformers' config classes give."""
    transformers = pytest.importorskip("transformers")
    want = transformers.AutoConfig.for_model(mt).to_dict()
    for key, value in thf.FAMILY_CONFIG_DEFAULTS[mt].items():
        if value == "auto":  # MambaConfig derives it from hidden_size
            assert want[key] == -(-want["hidden_size"] // 16)
        else:
            assert want[key] == value, (mt, key)
