"""Mu-law companding codec (port of vqvae_wavenet_tpu/ops/mu_law.py:18-61).

Keeps the reference's ``+0.5`` rounding when quantizing to integer bins and
the ``[-1, 1]`` clip after decoding (f32 pow overshoots the extremes by
~1e-6).  All math is float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def mu_law_encode(x: torch.Tensor, quantization_channels: int = 256,
                  to_int: bool = False) -> torch.Tensor:
    """Compand a float waveform in [-1, 1]; int64 bins in [0, mu] when
    ``to_int``."""
    mu = float(quantization_channels - 1)
    x = torch.clamp(x.float(), -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    if to_int:
        # [-1, 1] float -> [0, mu] int; +0.5 because the cast floors
        y = ((y + 1.0) / 2.0 * mu + 0.5).to(torch.int64)
    return y


def mu_law_decode(y: torch.Tensor,
                  quantization_channels: int = 256) -> torch.Tensor:
    """Expand mu-law bins [0, mu] (int or float) back to a waveform."""
    mu = float(quantization_channels - 1)
    y = 2.0 * y.float() / mu - 1.0
    x = torch.sign(y) * (torch.pow(1.0 + mu, torch.abs(y)) - 1.0) / mu
    return torch.clamp(x, -1.0, 1.0)


def mu_law_decode_np(y, quantization_channels: int = 256) -> np.ndarray:
    """``mu_law_decode`` on the host in numpy float32, without the clip
    (vqvae_wavenet_tpu/ops/mu_law.py:58-61)."""
    mu = np.float32(quantization_channels - 1)
    y = (2.0 * np.asarray(y, dtype=np.float32) / mu) - 1.0
    return np.sign(y) * ((1.0 + mu) ** np.abs(y) - 1.0) / mu
