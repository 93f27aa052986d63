"""Encoder_64 at inference (port of vqvae_wavenet_tpu/models/encoders.py:
58-149): 6 x [conv k=5 s=2 SAME -> relu -> norm] -> 1x1 conv to latent_dim
-> norm.  Batch norm runs in eval mode on the running statistics; group
norm is batch-independent.  Statistics are float32 with eps = 1e-3.

Encoder_Magenta and Encoder_2019 are not ported yet.
"""
from __future__ import annotations

import torch

from vqvae_wavenet_torch.ops.conv import conv1d

EPS = 1e-3


def batch_norm_eval(params, state, x: torch.Tensor) -> torch.Tensor:
    """Keras BatchNorm at inference (encoders.py:79-84)."""
    xf = x.float()
    inv = torch.rsqrt(state["var"].float() + EPS) * params["scale"].float()
    out = (xf - state["mean"].float()) * inv + params["bias"].float()
    return out.to(x.dtype)


def group_norm(params, x: torch.Tensor, num_groups: int = 8) -> torch.Tensor:
    """GroupNorm over (T, C/G) per group (encoders.py:87-99)."""
    b, t, c = x.shape
    g = num_groups if c % num_groups == 0 else 1
    xg = x.float().reshape(b, t, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
    xg = (xg - mean) * torch.rsqrt(var + EPS)
    out = (xg.reshape(b, t, c) * params["scale"].float()
           + params["bias"].float())
    return out.to(x.dtype)


def encoder_64_forward(params, state, x: torch.Tensor,
                       norm: str = "batch") -> torch.Tensor:
    """x: [B, T, 1] raw float wav -> z_e [B, T/64, latent_dim]."""

    def normalize(i, net):
        if norm == "batch":
            return batch_norm_eval(params["bn"][i], state["bn"][i], net)
        return group_norm(params["bn"][i], net)

    net = x
    for i, conv in enumerate(params["convs"]):
        net = conv1d(net, conv["kernel"], conv["bias"], stride=2,
                     padding="SAME")
        net = normalize(i, torch.relu(net))
    net = conv1d(net, params["out"]["kernel"], params["out"]["bias"],
                 padding="VALID")
    return normalize(len(params["convs"]), net)


def encoder_forward(name: str, params, state, x: torch.Tensor,
                    norm: str = "batch") -> torch.Tensor:
    if name != "64":
        raise NotImplementedError(
            f"encoder {name!r} is not ported to torch yet (only '64')")
    return encoder_64_forward(params, state, x, norm=norm)
