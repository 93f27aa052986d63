"""Signal helpers (port of vqvae_wavenet_tpu/ops/signal.py:100-107).

Only average pooling is ported: the Magenta encoder uses it.  The MFCC
front end waits for Encoder_2019.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vqvae_wavenet_torch.ops.conv import same_padding


def pool1d(x: torch.Tensor, hop_length: int, mode: str = "avg") -> torch.Tensor:
    """Strided average pooling over time with TF 'SAME' padding (window =
    stride = hop_length; padded positions are zeros and every window is
    divided by hop_length, as lax.reduce_window + divide does).
    x: [B, T, C] -> [B, ceil(T / hop_length), C]."""
    if mode != "avg":
        raise NotImplementedError(f"pool1d mode {mode!r} is not ported")
    b, t, c = x.shape
    lo, hi = same_padding(t, hop_length, hop_length)
    xp = F.pad(x, (0, 0, lo, hi)) if lo or hi else x
    return xp.reshape(b, -1, hop_length, c).sum(dim=2) / float(hop_length)
