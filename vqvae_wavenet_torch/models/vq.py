"""Vector quantization (port of vqvae_wavenet_tpu/models/vq.py:52-156):
nearest-code search (the CUDA kernel on the card; gradients never flow
through it), lookup, straight-through z_q = z_e + (e_k - z_e).detach(),
perplexity and the closed-form mean distance; the losses of the three
modes (st, joint, ema) and the EMA codebook update (Magenta/sonnet.py:
224-241, Laplace-smoothed cluster sizes).  Under data or sequence
parallelism the statistics span every rank (``sh``), under tensor
parallelism the data group, with the same bits on every rank of a model
row (``comm.replicated_sum_``).
"""
from __future__ import annotations

import torch

from vqvae_wavenet_torch.ops.vq_kernels import vq_nearest
from vqvae_wavenet_torch.parallel.comm import replicated_sum_


def quantize(params, z_e: torch.Tensor, *, mode: str = "st", sh=None):
    """Discretize z_e [..., d] against the codebook [k, d].

    Returns dict with z_q, e_k, q_z_x (int64 code indices), perplexity and
    distances_mean.  With ``sh`` (parallel.Shards: z_e is this rank's part
    of equal parts) the perplexity counts the codes of every rank and
    distances_mean is the mean over the ranks -- linear in the parts'
    means, so it is the whole batch's (vq.py:71-77)."""
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
    if sh is not None:
        replicated_sum_(counts, sh)
        distances_mean = replicated_sum_(
            distances_mean.detach().reshape(1).clone(), sh)[0] / sh.data_world
    avg_probs = counts / counts.sum().clamp_min(1.0)
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    return {"z_q": z_q, "e_k": e_k, "q_z_x": q_z_x, "perplexity": perplexity,
            "distances_mean": distances_mean}


def vq_losses(z_e: torch.Tensor, e_k: torch.Tensor, beta: float, *,
              mode: str = "st"):
    """(vq_loss, commitment_loss) per mode (vq.py:95-108)."""
    if mode == "st":
        vq_loss = torch.mean((z_e.detach() - e_k) ** 2)
        commitment = beta * torch.mean((z_e - e_k.detach()) ** 2)
    elif mode == "joint":
        vq_loss = torch.mean((z_e - e_k) ** 2)
        commitment = beta * torch.mean((z_e - e_k) ** 2)
    elif mode == "ema":
        vq_loss = torch.zeros((), dtype=z_e.dtype, device=z_e.device)
        commitment = beta * torch.mean((z_e - e_k.detach()) ** 2)
    else:
        raise ValueError(f"unknown vq mode {mode}")
    return vq_loss, commitment


def ema_codebook_update(params, state, z_e: torch.Tensor,
                        q_z_x: torch.Tensor, *, decay: float = 0.99,
                        epsilon: float = 1e-5, sh=None):
    """The EMA codebook step (vq.py:111-156): returns ({"embedding"},
    {"ema_cluster_size", "ema_means"}).  With ``sh`` the cluster sizes and
    code-wise sums are summed over the ranks first (vq.py:111-125)."""
    k, d = params["embedding"].shape
    flat = z_e.detach().reshape(-1, d).float()
    onehot = torch.nn.functional.one_hot(q_z_x.reshape(-1).long(), k).float()
    cluster_size = onehot.sum(dim=0)
    dw = onehot.T @ flat
    if sh is not None:
        replicated_sum_(cluster_size, sh)
        replicated_sum_(dw, sh)
    new_cluster_size = (decay * state["ema_cluster_size"]
                        + (1 - decay) * cluster_size)
    new_means = decay * state["ema_means"] + (1 - decay) * dw
    n = torch.sum(new_cluster_size)
    smoothed = ((new_cluster_size + epsilon) / (n + k * epsilon)) * n
    return ({"embedding": new_means / smoothed[:, None]},
            {"ema_cluster_size": new_cluster_size, "ema_means": new_means})
