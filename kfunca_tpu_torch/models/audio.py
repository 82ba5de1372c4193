"""Audio frontend: Whisper's log-mel spectrogram in torch.

Counterpart of kfunca_tpu/models/audio.py: raw 16 kHz waveforms -> the
(n_mels, frames) input_features that models/whisper.py consumes, in the
structure of HF's WhisperFeatureExtractor (a Hann-windowed STFT centred by
reflect padding, the Slaney-scale Slaney-normalized triangular mel bank,
log10 with an 8 dB floor under each clip's maximum, (x + 4) / 4, the last
frame dropped).  The mel bank is a copy of the JAX module's numpy one,
built on the host and cached; framing is one strided view of the padded
waveform, the windowed rfft (torch.fft: cuFFT on the card) batches over
every frame, and the mel projection is one matmul.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime.backend import resolve_device


def _hertz_to_mel(freq):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(
        log_region, 15.0 + np.log(np.maximum(freq, 1e-10) / 1000.0) / logstep,
        mels)


def _mel_to_hertz(mels):
    mels = np.asarray(mels, np.float64)
    freq = 200.0 * mels / 3.0
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= 15.0, 1000.0 * np.exp(logstep * (mels - 15.0)),
                    freq)


@lru_cache(maxsize=8)
def mel_filter_bank(n_freqs: int, n_mels: int, sample_rate: int,
                    fmin: float = 0.0, fmax: float | None = None
                    ) -> np.ndarray:
    """(n_freqs, n_mels) Slaney-normalized triangular filters (the
    librosa / transformers construction; host-side numpy, cached)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    mel_pts = np.linspace(_hertz_to_mel(fmin), _hertz_to_mel(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hertz(mel_pts)  # (n_mels + 2,)
    fft_freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    slopes = hz_pts[None, :] - fft_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / np.maximum(hz_pts[1:-1] - hz_pts[:-2], 1e-10)
    up = slopes[:, 2:] / np.maximum(hz_pts[2:] - hz_pts[1:-1], 1e-10)
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])  # constant energy
    return (fb * enorm[None, :]).astype(np.float32)


def _waveform(audio, device):
    """audio as a 2-D fp32 tensor: a tensor stays on its device, an array
    goes to `device` (default: the CUDA device)."""
    if not isinstance(audio, torch.Tensor):
        audio = torch.as_tensor(np.asarray(audio),
                                device=resolve_device(device))
    if audio.ndim == 1:
        audio = audio[None]
    return audio.float()


def log_mel_spectrogram(audio, n_mels: int = 80, sample_rate: int = 16000,
                        n_fft: int = 400, hop: int = 160, device=None):
    """audio (B, N) or (N,) waveform -> (B, n_mels, N // hop) fp32 log-mel
    features (the Whisper convention), on the waveform's device."""
    audio = _waveform(audio, device)
    n = audio.shape[-1]
    pad = n_fft // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # (B, 1 + N // hop, n_fft), a view
    k = torch.arange(n_fft, dtype=torch.float32, device=audio.device)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * k / n_fft))  # periodic
    power = torch.fft.rfft(frames * window, dim=-1).abs().square()
    fb = torch.from_numpy(mel_filter_bank(n_fft // 2 + 1, n_mels,
                                          sample_rate)).to(audio.device)
    log_spec = torch.log10(torch.clamp(power @ fb, min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    log_spec = (torch.maximum(log_spec, floor) + 4.0) / 4.0
    return log_spec[:, :-1].transpose(1, 2)


def whisper_features(audio, cfg, sample_rate: int = 16000,
                     chunk_seconds: float = 30.0, device=None):
    """Raw waveform -> Whisper input_features: padded or trimmed to the
    30-second window, then log-mel, at most 2 * max_source_positions
    frames."""
    audio = _waveform(audio, device)
    target = int(chunk_seconds * sample_rate)
    n = audio.shape[-1]
    audio = (F.pad(audio, (0, target - n)) if n < target
             else audio[:, :target])
    feats = log_mel_spectrogram(audio, n_mels=cfg.n_mels,
                                sample_rate=sample_rate)
    return feats[:, :, : 2 * cfg.max_source_positions]
