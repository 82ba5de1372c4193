"""Port parity: the encoder-decoder family's HF interop
(models/t5.from_hf_t5, models/whisper.from_hf_whisper, models/audio).

transformers models built from a config (no download) are saved with
save_pretrained, which drops the tied embedding copies, and the directory
is read by the port without transformers (config.json over
hf.FAMILY_CONFIG_DEFAULTS, then model.safetensors): the params equal the
model instance's and the JAX from_hf_*'s bit for bit, the logits
transformers' within 2e-5 x max(1, max |ref|), greedy generation (with a
forced prompt for Whisper) transformers' tokens exactly, and the log-mel
features WhisperFeatureExtractor's within 1e-4.  One module, so the
transformers import is paid once.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kfunca_tpu.models import t5 as jt5
from kfunca_tpu.models import whisper as jw
from kfunca_tpu_torch.models import audio as ta
from kfunca_tpu_torch.models import t5 as tt5
from kfunca_tpu_torch.models import whisper as tw
from torch_parity import close, one_thread, trees_close  # noqa: F401

transformers = pytest.importorskip("transformers")
HF_TOL = 2e-5


def _t5_model(gated, dec_layers=3):
    hc = transformers.T5Config(
        vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_decoder_layers=dec_layers, num_heads=4,
        relative_attention_num_buckets=16,
        relative_attention_max_distance=64, dropout_rate=0.0,
        feed_forward_proj="gated-gelu" if gated else "relu",
        tie_word_embeddings=not gated, decoder_start_token_id=0,
        pad_token_id=0, eos_token_id=1)
    torch.manual_seed(0)
    return transformers.T5ForConditionalGeneration(hc).eval()


def _ids(seed, shape, low=2, high=96):
    return np.random.default_rng(seed).integers(low, high, shape).astype(
        np.int32)


@pytest.mark.parametrize("gated", [False, True])
def test_t5_directory_matches_the_model_and_jax(gated, tmp_path):
    model = _t5_model(gated)
    model.save_pretrained(tmp_path)
    with open(tmp_path / "config.json") as f:
        raw = json.load(f)
    assert "num_decoder_layers" in raw  # 3, not the class default of 6
    tp, tc = tt5.from_hf_t5(tmp_path, dtype="float32", device="cpu")
    ip, icfg = tt5.from_hf_t5(model, dtype="float32", device="cpu")
    jp, jc = jt5.from_hf_t5(model, dtype="float32")
    assert tc == icfg and dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.n_dec_layers, tc.rel_buckets, tc.tied_head) == (3, 16,
                                                               not gated)
    trees_close(tp, ip, 0.0)
    trees_close(tp, jp, 0.0)
    enc, dec = _ids(1, (2, 9)), _ids(2, (2, 5))
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(enc).long(),
                    decoder_input_ids=torch.from_numpy(dec).long()).logits
    got = tt5.t5_forward(tp, torch.from_numpy(enc), torch.from_numpy(dec), tc)
    close(got, ref, HF_TOL)
    close(got, jt5.t5_forward(jp, jnp.asarray(enc), jnp.asarray(dec), jc),
          1e-5)


def test_t5_greedy_generation_is_transformers(tmp_path):
    """t5_generate against model.generate (greedy, one beam), up to each
    row's EOS (transformers' cache wants as many decoder layers as encoder
    layers)."""
    model = _t5_model(False, dec_layers=2)
    model.save_pretrained(tmp_path)
    tp, tc = tt5.from_hf_t5(tmp_path, dtype="float32", device="cpu")
    enc = _ids(3, (2, 7))
    with torch.no_grad():
        ref = model.generate(torch.from_numpy(enc).long(), max_new_tokens=8,
                             do_sample=False, num_beams=1).numpy()[:, 1:]
    got = tt5.t5_generate(tp, torch.from_numpy(enc), tc, 8, eos_id=1).numpy()
    for b in range(2):
        n = min(len(ref[b]), 8)
        assert np.array_equal(got[b, :n], ref[b, :n])


def _whisper_model():
    hc = transformers.WhisperConfig(
        vocab_size=96, num_mel_bins=8, d_model=32,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_layers=2, decoder_layers=2, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_source_positions=16,
        max_target_positions=32, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, activation_function="gelu",
        decoder_start_token_id=0, eos_token_id=1, pad_token_id=2,
        bos_token_id=3, suppress_tokens=[], begin_suppress_tokens=[])
    torch.manual_seed(0)
    return transformers.WhisperForConditionalGeneration(hc).eval()


def test_whisper_directory_matches_the_model_and_jax(tmp_path):
    model = _whisper_model()
    model.save_pretrained(tmp_path)
    tp, tc = tw.from_hf_whisper(tmp_path, dtype="float32", device="cpu")
    ip, icfg = tw.from_hf_whisper(model, dtype="float32", device="cpu")
    jp, jc = jw.from_hf_whisper(model, dtype="float32")
    assert tc == icfg and dataclasses.asdict(tc) == dataclasses.asdict(jc)
    trees_close(tp, ip, 0.0)
    trees_close(tp, jp, 0.0)
    feats = np.random.default_rng(4).normal(size=(2, 8, 32)).astype(
        np.float32)
    dec = _ids(5, (2, 5))
    with torch.no_grad():
        ref = model(input_features=torch.from_numpy(feats),
                    decoder_input_ids=torch.from_numpy(dec).long()).logits
    got = tw.whisper_forward(tp, torch.from_numpy(feats),
                             torch.from_numpy(dec), tc)
    close(got, ref, HF_TOL)
    close(got, jw.whisper_forward(jp, jnp.asarray(feats), jnp.asarray(dec),
                                  jc), 1e-5)


def test_whisper_forced_prompt_decoding_is_transformers(tmp_path):
    """A forced prompt conditions the continuation as teacher forcing
    through transformers does, token for token."""
    model = _whisper_model()
    model.save_pretrained(tmp_path)
    tp, tc = tw.from_hf_whisper(tmp_path, dtype="float32", device="cpu")
    feats = np.random.default_rng(6).normal(size=(1, 8, 32)).astype(
        np.float32)
    prompt = np.asarray([[5, 9]], np.int64)
    got = tw.whisper_generate(tp, torch.from_numpy(feats), tc, 4,
                              torch.from_numpy(prompt)).numpy()
    dec = np.concatenate([[[tc.decoder_start_id]], prompt], axis=1)
    with torch.no_grad():
        for i in range(4):
            logits = model(input_features=torch.from_numpy(feats),
                           decoder_input_ids=torch.from_numpy(dec)).logits
            nxt = int(logits[0, -1].argmax())
            assert nxt == got[0, i], (i, nxt, got[0])
            if nxt == tc.eos_id:
                assert (got[0, i:] == tc.eos_id).all()
                break
            dec = np.concatenate([dec, [[nxt]]], axis=1)


def test_log_mel_matches_whisper_feature_extractor():
    fe = transformers.WhisperFeatureExtractor()  # 80 mels, 16 kHz, 30 s
    audio = (np.random.default_rng(7).uniform(-1, 1, 16000) * 0.5).astype(
        np.float32)
    ref = fe(audio, sampling_rate=16000, return_tensors="np").input_features
    got = ta.whisper_features(torch.from_numpy(audio), tw.WhisperConfig())
    assert got.shape == ref.shape == (1, 80, 3000)
    close(got, ref, 1e-4)
