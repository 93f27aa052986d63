"""WaveNet prior over VQ code indices (port of
vqvae_wavenet_tpu/models/prior.py): a small autoregressive gated dilated
conv stack over the code sequence q(z|x) [B, T_lat], optionally globally
conditioned on the speaker vector.  With a trained prior, novel audio is
generated end to end: codes sampled from the prior, codebook lookup, the
WaveNet decoder (vqvae_wavenet_torch/prior.py).

Structure (as the JAX package's): the shift-right code embedding, a causal
preprocess conv, eight gated residual layers at dilations [1, 2, 4, 8] * 2
with skip and residual 1x1 projections (and an optional per-layer gc
projection), relu -> post1 -> relu -> post2 -> logits over the k codes.

Numerics follow the JAX code under a cast of the parameters: the skip sum
starts as float32 zeros, so with bfloat16 parameters it is float32 and so
are the heads after it; the residual stream stays in the parameters'
type; ``prior_loss`` takes the log-softmax in float32 whatever the compute
type.  The JAX package runs the prior through XLA, with no Pallas kernel,
so it is plain torch here.  Random draws (dropout, sampling) take an
explicit ``torch.Generator`` and are drawn on its device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vqvae_wavenet_torch.ops.conv import causal_conv1d

PRIOR_DILATIONS = (1, 2, 4, 8, 1, 2, 4, 8)


def init_prior_params_np(k: int, *, embed_dim: int = 64, filters: int = 128,
                         kernel_size: int = 3,
                         gc_channels: Optional[int] = None, seed: int = 1):
    """The prior's parameters in the JAX shapes and init limits
    (prior.py:31-59): uniform unit scaling kernels (limit sqrt(3 / fan_in)),
    zero biases; float32 numpy arrays from a numpy seed."""
    rng = np.random.default_rng(seed)

    def uus(shape):
        lim = np.sqrt(3.0 / float(np.prod(shape[:-1])))
        return rng.uniform(-lim, lim, size=shape).astype(np.float32)

    def zeros(n):
        return np.zeros(n, np.float32)

    layers = []
    for _ in PRIOR_DILATIONS:
        layer = {"kernel": uus((kernel_size, filters, 2 * filters)),
                 "bias": zeros(2 * filters),
                 "skip_kernel": uus((filters, filters)),
                 "skip_bias": zeros(filters),
                 "res_kernel": uus((filters, filters)),
                 "res_bias": zeros(filters)}
        if gc_channels is not None:
            layer["gc_kernel"] = uus((gc_channels, 2 * filters))
        layers.append(layer)
    return {"embed": uus((k, embed_dim)),
            "preprocess": {"kernel": uus((kernel_size, embed_dim, filters)),
                           "bias": zeros(filters)},
            "layers": layers,
            "post1": {"kernel": uus((filters, filters)), "bias": zeros(filters)},
            "post2": {"kernel": uus((filters, k)), "bias": zeros(k)}}


def _dense(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """einsum('btc,cf->btf') in the promoted type of its operands."""
    dt = torch.promote_types(x.dtype, kernel.dtype)
    return x.to(dt) @ kernel.to(dt)


def prior_logits(params, codes: torch.Tensor,
                 gc: Optional[torch.Tensor] = None, *,
                 generator: Optional[torch.Generator] = None,
                 dropout_rate: float = 0.0) -> torch.Tensor:
    """Teacher-forced logits.  codes: int [B, T] -> [B, T, k]; position t
    sees codes[< t] only (shift-right embedding).  gc: [B, 1, C_gc] or
    None.  Dropout on the gated units when a generator is given and
    dropout_rate > 0 (kept with probability 1 - rate, scaled by 1 / (1 -
    rate))."""
    emb = params["embed"][codes.long()]                       # [B, T, E]
    emb = F.pad(emb, (0, 0, 1, 0))[:, :-1, :]                 # shift right
    # the biases are added after the conv's rounding, as the JAX code's
    # conv-then-add does in the compute type
    net = causal_conv1d(emb, params["preprocess"]["kernel"]) \
        + params["preprocess"]["bias"]
    skip_sum = torch.zeros(net.shape, dtype=torch.float32, device=net.device)
    f = net.shape[-1]
    for layer, d in zip(params["layers"], PRIOR_DILATIONS):
        pre = causal_conv1d(net, layer["kernel"], dilation=d) + layer["bias"]
        if gc is not None and "gc_kernel" in layer:
            pre = pre + _dense(gc, layer["gc_kernel"])
        gated = torch.tanh(pre[..., :f]) * torch.sigmoid(pre[..., f:])
        if generator is not None and dropout_rate > 0:
            u = torch.rand(gated.shape, generator=generator,
                           device=generator.device).to(gated.device)
            gated = torch.where(u < 1 - dropout_rate,
                                gated / (1 - dropout_rate),
                                torch.zeros_like(gated))
        skip_sum = skip_sum + _dense(gated, layer["skip_kernel"]) \
            + layer["skip_bias"]
        net = net + _dense(gated, layer["res_kernel"]) + layer["res_bias"]
    net = torch.relu(skip_sum)
    net = torch.relu(_dense(net, params["post1"]["kernel"])
                     + params["post1"]["bias"])
    return _dense(net, params["post2"]["kernel"]) + params["post2"]["bias"]


def prior_loss(params, codes: torch.Tensor,
               gc: Optional[torch.Tensor] = None, *,
               generator: Optional[torch.Generator] = None,
               dropout_rate: float = 0.0) -> torch.Tensor:
    """Mean NLL of the codes under the prior, log-softmax in float32."""
    logits = prior_logits(params, codes, gc, generator=generator,
                          dropout_rate=dropout_rate)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, codes.long()[..., None])[..., 0].mean()


@torch.no_grad()
def prior_sample(params, generator: Optional[torch.Generator], *,
                 batch_size: int, length: int,
                 gc: Optional[torch.Tensor] = None,
                 temperature: float = 1.0) -> torch.Tensor:
    """Autoregressive code sampling: step t recomputes the logits of the
    whole (zero-filled past t) sequence, as the JAX package does (latent
    sequences are short), and draws code t by Gumbel-max over logits /
    temperature with uniform noise [B, k] from ``generator`` (on its own
    device).  Returns int64 codes [B, length] on the parameters' device."""
    device = params["embed"].device
    k = params["embed"].shape[0]
    gdev = generator.device if generator is not None else torch.device("cpu")
    codes = torch.zeros((batch_size, length), dtype=torch.int64,
                        device=device)
    tiny = torch.finfo(torch.float32).tiny
    for t in range(length):
        logits = prior_logits(params, codes, gc)[:, t].float()
        u = torch.rand((batch_size, k), generator=generator,
                       device=gdev).to(device).clamp_min(tiny)
        codes[:, t] = torch.argmax(logits / temperature
                                   - torch.log(-torch.log(u)), dim=-1)
    return codes
