"""Signal front end (port of vqvae_wavenet_tpu/ops/signal.py:25-113):
|STFT| -> log-mel -> MFCC for Encoder_2019, and strided pooling.

The MFCC follows tf.contrib.signal as the JAX package does: 25 ms
(400-sample) frames every 10 ms (160 samples), pad_end, a periodic Hann
window, fft_length = frame_length -> 201 magnitude bins; an 80-bin HTK mel
filterbank over 20..8000 Hz with its DC row zeroed; log(mel + 1e-6); an
unnormalized DCT-II times rsqrt(2 * num_mel_bins); the first 13
coefficients.  The mel and DCT matrices are numpy constants (copied here,
not imported).

``torch.stft`` is not used: it centres and pads by default, and the
reference does neither.  Frames are gathered explicitly on the index grid
and transformed with ``torch.fft.rfft`` (cuFFT on the card), and the two
matrix products are plain matmuls: the JAX package runs all of this
through XLA, with no Pallas kernel.  Float32 throughout (callers on CUDA
keep TF32 off, ops/conv.py::set_full_f32).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from vqvae_wavenet_torch.ops.conv import same_padding


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def linear_to_mel_weight_matrix(num_mel_bins=80, num_spectrogram_bins=201,
                                sample_rate=16000, lower_edge_hertz=20.0,
                                upper_edge_hertz=8000.0) -> np.ndarray:
    """HTK-mel triangular filterbank [bins, mel] (tf.signal semantics: the
    DC spectrogram bin is left out, then re-added as a zero row)."""
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[1:]
    spec_mels = _hz_to_mel(linear_freqs)[:, None]
    band_edges = np.linspace(_hz_to_mel(lower_edge_hertz),
                             _hz_to_mel(upper_edge_hertz),
                             num_mel_bins + 2)
    lower, center, upper = (band_edges[None, :-2], band_edges[None, 1:-1],
                            band_edges[None, 2:])
    lower_slopes = (spec_mels - lower) / (center - lower)
    upper_slopes = (upper - spec_mels) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    return np.pad(weights, [[1, 0], [0, 0]]).astype(np.float32)


def _dct2_matrix(n: int) -> np.ndarray:
    """Unnormalized DCT-II as a matrix: X_k = 2 sum_n x_n cos(pi k (2n+1)/(2N))."""
    k = np.arange(n)[None, :]
    m = np.arange(n)[:, None]
    return (2.0 * np.cos(np.pi * k * (2 * m + 1) / (2.0 * n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window(frame_length: int) -> torch.Tensor:
    """The periodic Hann window (a CPU tensor)."""
    n = np.arange(frame_length)
    return torch.from_numpy((0.5 - 0.5 * np.cos(
        2.0 * np.pi * n / frame_length)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _mel_dct(num_spectrogram_bins: int, num_mel_bins: int, sample_rate: int):
    """(mel matrix, DCT matrix) as CPU tensors."""
    mel = linear_to_mel_weight_matrix(
        num_mel_bins=num_mel_bins, num_spectrogram_bins=num_spectrogram_bins,
        sample_rate=sample_rate)
    return torch.from_numpy(mel), torch.from_numpy(_dct2_matrix(num_mel_bins))


def stft_magnitude(wav: torch.Tensor, frame_length: int = 400,
                   frame_step: int = 160, pad_end: bool = True
                   ) -> torch.Tensor:
    """|STFT| with a periodic Hann window.  wav: [B, T] -> [B, F, bins]
    (pad_end: F = ceil(T / step), zeros past T; else 1 + (T - L) // step)."""
    t = wav.shape[1]
    wav = wav.float()
    if pad_end:
        num_frames = -(-t // frame_step)
        pad = (num_frames - 1) * frame_step + frame_length - t
        if pad > 0:
            wav = F.pad(wav, (0, pad))
    else:
        num_frames = 1 + (t - frame_length) // frame_step
    idx = (torch.arange(num_frames)[:, None] * frame_step
           + torch.arange(frame_length)[None, :]).to(wav.device)
    window = _window(frame_length).to(wav.device)
    frames = wav[:, idx]                                   # [B, F, L]
    return torch.abs(torch.fft.rfft(frames * window, dim=-1))


def mfcc(wav: torch.Tensor, sample_rate: int = 16000, num_mfccs: int = 13,
         num_mel_bins: int = 80, pad_end: bool = True) -> torch.Tensor:
    """MFCC features of Encoder_2019.  wav: [B, T] float in [-1, 1] ->
    float32 [B, ceil(T / 160), 13] (pad_end=False: 1 + (T - 400) // 160
    frames)."""
    frame_length = int(25 / 1000 * sample_rate)
    frame_step = int(10 / 1000 * sample_rate)
    mag = stft_magnitude(wav, frame_length, frame_step, pad_end=pad_end)
    mel_m, dct_m = _mel_dct(frame_length // 2 + 1, num_mel_bins, sample_rate)
    mel = mag @ mel_m.to(mag.device)
    log_mel = torch.log(mel + 1e-6)
    mfccs = (log_mel @ dct_m.to(mag.device)) * (1.0 / np.sqrt(
        2.0 * num_mel_bins))
    return mfccs[..., :num_mfccs]


def pool1d(x: torch.Tensor, hop_length: int, mode: str = "avg") -> torch.Tensor:
    """Strided pooling over time with TF 'SAME' padding (window = stride =
    hop_length).  'avg': padded positions are zeros and every window is
    divided by hop_length, as lax.reduce_window + divide does; 'max':
    padded positions are -inf.  x: [B, T, C] -> [B, ceil(T / hop), C]."""
    if mode not in ("avg", "max"):
        raise ValueError(mode)
    b, t, c = x.shape
    lo, hi = same_padding(t, hop_length, hop_length)
    if lo or hi:
        x = F.pad(x, (0, 0, lo, hi),
                  value=0.0 if mode == "avg" else float("-inf"))
    windows = x.reshape(b, -1, hop_length, c)
    if mode == "max":
        return windows.amax(dim=2)
    return windows.sum(dim=2) / float(hop_length)
