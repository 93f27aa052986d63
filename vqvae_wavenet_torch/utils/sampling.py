"""Host-side sampling of prediction pdfs (port of
vqvae_wavenet_tpu/utils/sampling.py, the reference's utils.py:13-46).

Generation samples on the device, inside its kernel
(ops/gen_kernels.py); these numpy functions keep the reference's API and
its cumsum/searchsorted sampling for checking that distribution.
"""
from __future__ import annotations

import numpy as np

from vqvae_wavenet_torch.ops.mu_law import mu_law_decode_np


def sample(pdf, quantization_channels: int = 256, rng=None) -> np.ndarray:
    """Sample a bin from each row of the pdfs [b, Q] (one uniform draw a
    row, searched in the row's cumulative sum) -> the mu-law-decoded
    floats [b] (utils.py:13-27)."""
    rng = rng or np.random.default_rng()
    cdf = np.cumsum(pdf, axis=1)
    draws = rng.random(cdf.shape[0])
    bins = np.array([row.searchsorted(p) for row, p in zip(cdf, draws)],
                    dtype=np.float32)
    return mu_law_decode_np(bins, quantization_channels)


def decode(predictions, mode: str = "sample",
           quantization_channels: int = 256, rng=None) -> np.ndarray:
    """'sample' or 'greedy' (argmax) decode of prediction pdfs [b, Q]
    (utils.py:30-46)."""
    if mode == "sample":
        return sample(predictions, quantization_channels, rng)
    if mode == "greedy":
        return mu_law_decode_np(np.argmax(predictions, axis=-1),
                                quantization_channels)
    raise NotImplementedError(f"decode mode {mode} not implemented")
