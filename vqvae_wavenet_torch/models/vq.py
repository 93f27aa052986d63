"""Vector quantization at inference (port of
vqvae_wavenet_tpu/models/vq.py:52-92, forward only): nearest-code search
(the CUDA kernel on the card), lookup, straight-through z_q, perplexity and
the closed-form mean distance.  Losses and the EMA codebook wait for the
training port.
"""
from __future__ import annotations

import torch

from vqvae_wavenet_torch.ops.vq_kernels import vq_nearest


def quantize(params, z_e: torch.Tensor, *, mode: str = "st"):
    """Discretize z_e [..., d] against the codebook [k, d].

    Returns dict with z_q, e_k, q_z_x (int64 code indices), perplexity and
    distances_mean."""
    embedding = params["embedding"]
    k, d = embedding.shape
    flat = z_e.reshape(-1, d)
    q_z_x = vq_nearest(flat, embedding)
    e_k = embedding[q_z_x].reshape(z_e.shape)
    q_z_x = q_z_x.reshape(z_e.shape[:-1])
    # E[||z-e||^2] = E||z||^2 + E||e||^2 - 2 E[z].E[e] (vq.py:71-77)
    distances_mean = (torch.mean(torch.sum(flat ** 2, -1))
                      + torch.mean(torch.sum(embedding ** 2, -1))
                      - 2.0 * torch.dot(flat.mean(0), embedding.mean(0)))
    if mode in ("st", "ema"):
        z_q = z_e + (e_k - z_e).detach()
    elif mode == "joint":
        z_q = e_k
    else:
        raise ValueError(f"unknown vq mode {mode}")
    counts = torch.bincount(q_z_x.reshape(-1), minlength=k).float()
    avg_probs = counts / max(q_z_x.numel(), 1)
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    return {"z_q": z_q, "e_k": e_k, "q_z_x": q_z_x, "perplexity": perplexity,
            "distances_mean": distances_mean}
