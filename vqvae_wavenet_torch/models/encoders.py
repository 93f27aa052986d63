"""The three encoders (port of vqvae_wavenet_tpu/models/encoders.py:58-273).

  * Encoder_64: 6 x [conv k=5 s=2 SAME -> relu -> norm] -> 1x1 conv to
    latent_dim -> norm.  Batch norm uses the running statistics at
    inference and the batch's own in training (var = E[x^2] - E[x]^2,
    momentum 0.99, returning the new running statistics); group norm is
    batch-independent.  Statistics are float32 with eps = 1e-3, whatever
    the activations' type.
  * Encoder_Magenta: shift_right, the mu-law *float* encode, a causal
    preprocess conv (k=5), then six layers of [1x1 stride-2 VALID "down"
    conv -> gate/filter causal convs at dilations 1, 2, 4, 8, 16, 16 ->
    tanh * sigmoid -> causal 1x1 residual added to the down output], a
    causal 1x1 postprocess to latent_dim.  64x downsample.
  * Encoder_2019: MFCC (ops/signal.py), two SAME k=3 convs with a
    residual, a SAME k=4 stride-2 conv, two residual k=3 convs, four
    "relu layers" kept as the reference has them (net = r + r, i.e.
    2 * relu(conv(net)), not net + relu), a SAME 1x1 to latent_dim.
    320 samples a frame (160-sample hop x stride 2).

Neither Encoder_Magenta nor Encoder_2019 has model state; both return
the state they are given.  Under data or sequence parallelism Encoder_64's
batch norms take their statistics over every rank (``sh``).  All three run in the JAX package through XLA
(no Pallas kernel), so their convs are ``F.conv1d`` here.

Under tensor parallelism (``sh.n_model`` > 1, parallel/mesh.py) the 768-wide
convs of Encoder_64 and Encoder_2019 arrive as the rank's output columns
(a kernel narrower than its bias) and run column-parallel: each reads the
whole input, joined over the model row (``comm.gather_split``; before the
replicated ``out`` conv ``comm.gather_replicated``), and makes the rank's
channels, whose bias, batch norm and residuals are the rank's slices; the
batch-norm statistics span the data group, and the new running statistics
are joined over the row, so the model state stays whole.  Encoder_Magenta
(128 wide) is never split.
"""
from __future__ import annotations

import torch

from vqvae_wavenet_torch.ops.conv import causal_conv1d, conv1d, shift_right
from vqvae_wavenet_torch.ops.mu_law import mu_law_encode
from vqvae_wavenet_torch.ops.signal import mfcc
from vqvae_wavenet_torch.parallel.comm import (all_gather_, gather_replicated,
                                              gather_split, model_slice,
                                              own_slice, pmean)

EPS = 1e-3
MOMENTUM = 0.99


def batch_norm(params, state, x: torch.Tensor, *, train: bool = False,
               sh=None):
    """Keras BatchNorm over (B, T) (encoders.py:58-84).  Returns (out in
    x's dtype, new running statistics).  With ``sh`` (parallel.Shards: the
    batch or the time axis split over ranks) training takes the mean and
    the mean square over the data group (``comm.pmean``, whose gradient
    averages over the ranks): sync-BN, the single-device statistics of the
    whole batch."""
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 1))
        mean_sq = (xf * xf).mean(dim=(0, 1))
        if sh is not None:
            mean = pmean(mean, sh, sh.data_group)
            mean_sq = pmean(mean_sq, sh, sh.data_group)
        var = mean_sq - mean * mean
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


def group_norm(params, x: torch.Tensor, num_groups: int = 8,
               sh=None) -> torch.Tensor:
    """GroupNorm over (T, C/G) per group (encoders.py:87-99).  With ``sh``
    (a time shard of a row of more than one) the f32 mean and mean square
    are averaged over the time row, var = E[x^2] - E[x]^2: the statistics
    of the whole clip (timeshard.py:159-173)."""
    b, t, c = x.shape
    g = num_groups if c % num_groups == 0 else 1
    xg = x.float().reshape(b, t, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    if sh is not None and sh.n_time > 1:
        mean_sq = pmean((xg * xg).mean(dim=(1, 3), keepdim=True), sh,
                        sh.time_group)
        mean = pmean(mean, sh, sh.time_group)
        var = mean_sq - mean * mean
    else:
        var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
    xg = (xg - mean) * torch.rsqrt(var + EPS)
    out = (xg.reshape(b, t, c) * params["scale"].float()
           + params["bias"].float())
    return out.to(x.dtype)


def _split(conv, sh) -> bool:
    """A conv whose kernel holds this rank's output columns (narrower than
    its bias) under tensor parallelism."""
    return (sh is not None and sh.n_model > 1
            and conv["kernel"].shape[-1] != conv["bias"].shape[-1])


def _bias(conv, sh):
    """The bias of the conv's output channels on this rank."""
    return model_slice(conv["bias"], 0, sh) if _split(conv, sh) \
        else conv["bias"]


def _whole(net, sh, split: bool, feeds_split: bool):
    """A split conv's output channels joined over the model row, for a
    split or a replicated consumer; anything else as it is."""
    if not split:
        return net
    return (gather_split if feeds_split else gather_replicated)(net, -1, sh)


def encoder_64_forward(params, state, x: torch.Tensor, norm: str = "batch",
                       train: bool = False, sh=None):
    """x: [B, T, 1] raw float wav -> (z_e [B, T/64, latent_dim], new
    state {"bn": [...]}); ``sh``: the batch norms' statistics over the
    ranks of a data-parallel run, and the split convs of a
    tensor-parallel one."""
    new_bn = []

    def normalize(i, net, split):
        p, s = params["bn"][i], state["bn"][i]
        if split:        # this rank's channels of the norm
            p = {k: model_slice(v, 0, sh) for k, v in p.items()}
        if norm == "batch":
            mine = ({k: own_slice(v, 0, sh) for k, v in s.items()}
                    if split else s)
            net, new = batch_norm(p, mine, net, train=train, sh=sh)
            if split and train:
                new = {k: all_gather_(v, sh, 0, sh.model_group)
                       for k, v in new.items()}
            s = new if train else s
        else:
            groups = 8
            if split:
                if p["scale"].shape[0] * sh.n_model % 8 or 8 % sh.n_model:
                    raise NotImplementedError(
                        f"group norm of 8 groups over {sh.n_model} model "
                        f"ranks")
                groups = 8 // sh.n_model
            net = group_norm(p, net, num_groups=groups)
        new_bn.append(s)
        return net

    net = x
    convs = params["convs"]
    for i, conv in enumerate(convs):
        split = _split(conv, sh)
        net = conv1d(net, conv["kernel"], _bias(conv, sh), stride=2,
                     padding="SAME")
        net = normalize(i, torch.relu(net), split)
        net = _whole(net, sh, split,
                     i + 1 < len(convs) and _split(convs[i + 1], sh))
    net = conv1d(net, params["out"]["kernel"], params["out"]["bias"],
                 padding="VALID")
    return normalize(len(convs), net, False), {"bn": new_bn}


MAGENTA_DILATIONS = (1, 2, 4, 8, 16, 16)


def encoder_magenta_forward(params, state, x: torch.Tensor,
                            norm: str = "batch", train: bool = False,
                            sh=None):
    """x: [B, T, 1] -> (z_e [B, T/64, latent_dim], state) in x's dtype
    (encoders.py:181-201: causal convs throughout, the reference's 'VALID'
    convs still left-pad)."""
    net = mu_law_encode(shift_right(x)).to(x.dtype)
    en = causal_conv1d(net, params["preprocess"]["kernel"],
                       params["preprocess"]["bias"])
    for layer, dil in zip(params["layers"], MAGENTA_DILATIONS):
        d = conv1d(en, layer["down"]["kernel"], layer["down"]["bias"],
                   stride=2, padding="VALID")
        g = causal_conv1d(d, layer["gate"]["kernel"], layer["gate"]["bias"],
                          dilation=dil)
        f = causal_conv1d(d, layer["filter"]["kernel"],
                          layer["filter"]["bias"], dilation=dil)
        gated = torch.tanh(g) * torch.sigmoid(f)
        en = d + causal_conv1d(gated, layer["residual"]["kernel"],
                               layer["residual"]["bias"])
    z = causal_conv1d(en, params["postprocess"]["kernel"],
                      params["postprocess"]["bias"])
    return z, state


def encoder_2019_forward(params, state, x: torch.Tensor,
                         norm: str = "batch", train: bool = False, sh=None):
    """x: [B, T, 1] -> (z_e [B, ceil(ceil(T/160)/2), latent_dim], state),
    float32 (encoders.py:224-247).  Under tensor parallelism ``net`` holds
    this rank's channels and each conv reads them joined over the model
    row."""
    split = _split(params["pre1"], sh)

    def conv(net, p, stride=1, last=False):
        net = _whole(net, sh, split, not last)
        return conv1d(net, p["kernel"], _bias(p, sh), stride=stride,
                      padding="SAME")

    net = torch.relu(conv1d(mfcc(x[..., 0]), params["pre1"]["kernel"],
                            _bias(params["pre1"], sh), padding="SAME"))
    net = torch.relu(conv(net, params["pre2"])) + net
    net = torch.relu(conv(net, params["strided"], stride=2))
    for p in params["res"]:
        net = torch.relu(conv(net, p)) + net
    for p in params["relu"]:
        r = torch.relu(conv(net, p))
        net = r + r          # the reference's oddity: 2 * relu(conv(net))
    return conv(net, params["out"], last=True), state


# name -> (forward, samples per latent frame)
ENCODERS = {
    "64": (encoder_64_forward, 64),
    "Magenta": (encoder_magenta_forward, 64),
    "2019": (encoder_2019_forward, 320),
}


def _entry(name: str):
    if name not in ENCODERS:
        raise NotImplementedError(f"encoder {name!r} not implemented")
    return ENCODERS[name]


def encoder_forward(name: str, params, state, x: torch.Tensor,
                    norm: str = "batch", train: bool = False, sh=None):
    """Encoder ``name``; ``sh`` syncs Encoder_64's batch norms over the
    ranks (Encoder_Magenta has no batch statistics and ignores it) and
    splits the 768-wide convs of a tensor-parallel run."""
    return _entry(name)[0](params, state, x, norm=norm, train=train, sh=sh)


def encoder_downsample_rate(name: str) -> int:
    """Samples per latent frame: 64, 64, 320."""
    return _entry(name)[1]
