"""Encoder_64 (port of vqvae_wavenet_tpu/models/encoders.py:58-149):
6 x [conv k=5 s=2 SAME -> relu -> norm] -> 1x1 conv to latent_dim -> norm.
Batch norm uses the running statistics at inference and the batch's own
in training (var = E[x^2] - E[x]^2, momentum 0.99, returning the new
running statistics); group norm is batch-independent.  Statistics are
float32 with eps = 1e-3, whatever the activations' type.

Encoder_Magenta and Encoder_2019 are not ported yet.
"""
from __future__ import annotations

import torch

from vqvae_wavenet_torch.ops.conv import conv1d

EPS = 1e-3
MOMENTUM = 0.99


def batch_norm(params, state, x: torch.Tensor, *, train: bool = False):
    """Keras BatchNorm over (B, T) (encoders.py:58-84).  Returns (out in
    x's dtype, new running statistics)."""
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 1))
        var = (xf * xf).mean(dim=(0, 1)) - mean * mean
        new_state = {
            "mean": (MOMENTUM * state["mean"]
                     + (1 - MOMENTUM) * mean.detach()),
            "var": MOMENTUM * state["var"] + (1 - MOMENTUM) * var.detach()}
    else:
        mean, var = state["mean"].float(), state["var"].float()
        new_state = state
    inv = torch.rsqrt(var + EPS) * params["scale"].float()
    out = (xf - mean) * inv + params["bias"].float()
    return out.to(x.dtype), new_state


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


def encoder_64_forward(params, state, x: torch.Tensor, norm: str = "batch",
                       train: bool = False):
    """x: [B, T, 1] raw float wav -> (z_e [B, T/64, latent_dim], new
    state {"bn": [...]})."""
    new_bn = []

    def normalize(i, net):
        if norm == "batch":
            net, s = batch_norm(params["bn"][i], state["bn"][i], net,
                                train=train)
        else:
            net, s = group_norm(params["bn"][i], net), state["bn"][i]
        new_bn.append(s)
        return net

    net = x
    for i, conv in enumerate(params["convs"]):
        net = conv1d(net, conv["kernel"], conv["bias"], stride=2,
                     padding="SAME")
        net = normalize(i, torch.relu(net))
    net = conv1d(net, params["out"]["kernel"], params["out"]["bias"],
                 padding="VALID")
    return normalize(len(params["convs"]), net), {"bn": new_bn}


def encoder_forward(name: str, params, state, x: torch.Tensor,
                    norm: str = "batch", train: bool = False):
    if name != "64":
        raise NotImplementedError(
            f"encoder {name!r} is not ported to torch yet (only '64')")
    return encoder_64_forward(params, state, x, norm=norm, train=train)
