"""Port parity: the audio frontend (kfunca_tpu_torch/models/audio.py).

The port's copy of the Slaney mel bank against kfunca_tpu.models.audio's
(the same numpy, bit for bit), log_mel_spectrogram against the JAX
function on the same seeded waveforms (batched and 1-D, several lengths,
quiet clips that meet the 8 dB floor) within 1e-5 (pocketfft in both
packages here; the card's cuFFT is held at 1e-4 by chip_smoke.py), and
whisper_features (padding and trimming to the window) driving
whisper_generate end to end against the JAX package's tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.models import audio as ja
from kfunca_tpu.models import whisper as jw
from kfunca_tpu_torch.models import audio as ta
from kfunca_tpu_torch.models import whisper as tw
from kfunca_tpu_torch.models.weights import whisper_params_from_jax
from torch_parity import close, one_thread  # noqa: F401

MEL_TOL = 1e-5


@pytest.mark.parametrize("n_freqs,n_mels,rate", [
    (201, 80, 16000), (201, 128, 16000), (257, 40, 22050), (129, 64, 8000)])
def test_mel_bank_is_the_jax_bank(n_freqs, n_mels, rate):
    got = ta.mel_filter_bank(n_freqs, n_mels, rate)
    want = ja.mel_filter_bank(n_freqs, n_mels, rate)
    assert got.dtype == np.float32 and got.shape == (n_freqs, n_mels)
    assert np.array_equal(got, want)
    assert np.array_equal(ta.mel_filter_bank(201, 80, 16000, 50.0, 7000.0),
                          ja.mel_filter_bank(201, 80, 16000, 50.0, 7000.0))


def _wave(seed, shape, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,n_mels", [
    ((2, 3200), 80), ((16000,), 80), ((3, 4801), 128), ((1, 1600), 40)])
def test_log_mel_matches_jax(shape, n_mels):
    """Frames = N // hop (the last, centre-padded one dropped)."""
    audio = _wave(1, shape)
    want = np.asarray(ja.log_mel_spectrogram(jnp.asarray(audio),
                                             n_mels=n_mels))
    got = ta.log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels)
    assert got.shape == want.shape == (want.shape[0], n_mels,
                                       shape[-1] // 160)
    close(got, want, MEL_TOL)


def test_log_mel_floor_is_per_clip():
    """A near-silent clip beside a loud one: each clip's 8 dB floor under
    its own maximum, as the JAX function sets it."""
    audio = np.stack([_wave(2, 3200, 1.0), _wave(3, 3200, 1e-4)])
    audio[1, 1000:2000] = 0.0
    want = np.asarray(ja.log_mel_spectrogram(jnp.asarray(audio)))
    got = ta.log_mel_spectrogram(torch.from_numpy(audio))
    close(got, want, MEL_TOL)
    for clip in got:
        assert float(clip.max() - clip.min()) <= 2.0 + 1e-6  # 8 dB / 4


@pytest.mark.parametrize("seconds", [0.2, 0.5])
def test_whisper_features_pad_and_trim_as_jax(seconds):
    """A clip shorter than the window is zero-padded, a longer one
    trimmed; at most 2 x max_source_positions frames."""
    cfg = tw.WhisperConfig(n_mels=80, max_source_positions=20)
    audio = _wave(4, (2, 6000))
    want = np.asarray(ja.whisper_features(jnp.asarray(audio), cfg,
                                          chunk_seconds=seconds))
    got = ta.whisper_features(torch.from_numpy(audio), cfg,
                              chunk_seconds=seconds)
    assert got.shape == want.shape == (2, 80, min(40, int(seconds * 100)))
    close(got, want, MEL_TOL)


def test_an_array_goes_to_the_asked_device():
    audio = _wave(5, 1600)
    got = ta.log_mel_spectrogram(audio, device="cpu")
    assert got.device == torch.device("cpu") and got.shape == (1, 80, 10)
    close(got, ta.log_mel_spectrogram(torch.from_numpy(audio)), 0.0)


def test_raw_audio_drives_whisper_generate_as_jax():
    """whisper_features of a raw clip straight into whisper_generate: the
    JAX package's features and tokens (the model's matrices x3 so greedy
    decoding does not repeat one token)."""
    kw = dict(vocab_size=64, n_mels=80, d_model=32, n_heads=2,
              n_enc_layers=1, n_dec_layers=1, d_ff=64,
              max_source_positions=10, max_target_positions=16,
              dtype="float32")
    jc, tc = jw.WhisperConfig(**kw), tw.WhisperConfig(**kw)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * np.float32(3 if np.ndim(a) == 2 else 1),
        jw.init_whisper_params(jax.random.PRNGKey(0), jc))
    jp["enc_pos"] = jp["enc_pos"] / np.float32(3)
    jp["dec_pos"] = jp["dec_pos"] / np.float32(3)
    audio = _wave(6, 16000, 1.0)
    jf = ja.whisper_features(jnp.asarray(audio), jc, chunk_seconds=0.2)
    want = np.asarray(jw.whisper_generate(jp, jf, jc, max_new_tokens=6))
    tf = ta.whisper_features(torch.from_numpy(audio), tc, chunk_seconds=0.2)
    assert tf.shape == (1, 80, 20)
    close(tf, jf, MEL_TOL)
    got = tw.whisper_generate(whisper_params_from_jax(jp, tc, device="cpu"),
                              tf, tc, 6)
    assert np.array_equal(got.numpy(), want)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
