"""Sequence-parallel (SP) training: the time axis of each batch split over N
ranks, with halo exchanges (port of vqvae_wavenet_tpu/parallel/
timeshard.py, ``time_sharded_loss`` with ``decoder_halo='fused'`` and the
step of ``make_sp_train_step``).

Per rank, on its shard x_l [B, T/N, 1]:
  encoder   Encoder_64: each stride-2 SAME conv (k=5) pulls 1 column from
            the left neighbour and 3 from the right; the batch norms'
            statistics are means over all ranks (``pmean``), so they equal
            the single-device statistics.
  VQ        per shard, through the VQ kernel; the perplexity counts codes
            over all ranks.
  decoder   shift_right and the preprocess conv over shard boundaries, then
            one call of the residual-stack kernels per dilation cycle on
            the shard extended by that cycle's receptive field (rounded up
            to q rows), with start = max(halo - rank * T_l, 0): the rows
            that would lie before the sequence start are left out, which is
            the causal zero pad (ops/train_kernels.py, the SP variants).
            Every group but the last also returns its residual stream, whose
            last T_l rows feed the next group.  The heads are plain torch on
            the shard.
  loss      recon, vq and commitment losses are local means; the global
            loss is their mean over the ranks.

Gradients.  ``time_sharded_loss`` returns this rank's SHARE of the global
loss (its local loss / N).  Backward on the share on every rank, with the
exchanges' transposes carrying halo cotangents back to their owners and
``pmean``'s backward averaging the statistics' cotangents, and then a sum
of the parameter gradients over the ranks gives the gradient of the global
loss.  ``sp_loss_and_grads`` does that sum; train_loop.train_step with
it as ``grads_fn`` applies the fused Adam/EMA update, so every rank holds
the same train state.

bf16 (``train_dtype='bf16'``) follows JAX's contract (timeshard.py:
630-685): encoder convs and the decoder in bf16, norm statistics, VQ,
labels and loss in f32.  Left out, and raising NotImplementedError:
vq_mode 'ema', encoder_norm 'group', encoders other than '64', the
Magenta family, a composed data axis, and the 'layer' and 'recompute'
decoder halos (JAX falls back to them where its fused plan does not fit;
the port has no such path to fall back to, and with Encoder_64 every shard
of a multiple of 64 samples has a cycle plan).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from vqvae_wavenet_torch.models import vq as vq_mod
from vqvae_wavenet_torch.models.encoders import batch_norm
from vqvae_wavenet_torch.models.vqvae import _cast, build_local_condition
from vqvae_wavenet_torch.models.wavenet import wavenet_heads
from vqvae_wavenet_torch.ops.conv import conv1d
from vqvae_wavenet_torch.ops.mu_law import mu_law_encode
from vqvae_wavenet_torch.ops.train_kernels import fused_residual_stack
from vqvae_wavenet_torch.parallel import Shards
from vqvae_wavenet_torch.parallel.comm import (
    all_reduce_, exchange_both, left_halo, sharded_shift_right, sum_grads)
from vqvae_wavenet_torch.training.optimizer import tree_leaves, tree_unflatten
from vqvae_wavenet_torch.training.train_loop import _detach

RATIO = 64          # Encoder_64's downsample rate: samples per frame


def halo_sizes(wcfg, ratio: int) -> Tuple[int, int]:
    """(halo samples, halo frames): the receptive field rounded up to
    conditioning frames (timeshard.py:31-34)."""
    frames = -(-wcfg.receptive_field // ratio)
    return frames * ratio, frames


def fused_sp_groups(wcfg, ratio: int, t_l: int):
    """One layer group per dilation cycle, each with a recompute halo of its
    own receptive field sum((K-1)*d) rounded up to q, the largest of 512,
    256, 128, 64 dividing the shard length that is a whole number of
    frames (timeshard.py:383-412).  Returns ([(lo, hi, halo), ...], q) or
    None."""
    p = wcfg.num_cycle_layers
    q = next((t for t in (512, 256, 128, 64)
              if t_l % t == 0 and t % ratio == 0), None)
    if q is None:
        return None
    groups = []
    for c in range(wcfg.num_cycles):
        lo, hi = c * p, (c + 1) * p
        raw = sum((wcfg.kernel_size - 1) * int(d)
                  for d in wcfg.dilation_rates[lo:hi])
        groups.append((lo, hi, -(-raw // q) * q))
    return groups, q


def check_supported(cfg, length: int, world: int,
                    decoder_halo: str = "fused") -> List[Tuple[int, int, int]]:
    """Raise for what the port's SP path does not cover; return the group
    plan for clips of ``length`` samples on ``world`` ranks."""
    if decoder_halo not in ("auto", "fused"):
        raise NotImplementedError(
            f"-decoder_halo {decoder_halo} is not ported (only 'fused'; "
            f"ROADMAP.md queue A, SP)")
    if cfg.model_family == "magenta":
        raise NotImplementedError("SP training of the Magenta family is not "
                                  "ported (ROADMAP.md queue A, item 7: SP)")
    if cfg.model_family != "vqvae" or cfg.encoder != "64":
        raise NotImplementedError(
            "SP training covers the main family with Encoder_64 only "
            "(ROADMAP.md queue A, SP)")
    if cfg.encoder_norm != "batch":
        raise NotImplementedError("SP training with encoder_norm 'group' is "
                                  "not ported (ROADMAP.md queue A, SP)")
    if cfg.use_vq and cfg.vq_mode == "ema":
        raise NotImplementedError("SP training with vq_mode 'ema' is not "
                                  "ported (ROADMAP.md queue A, SP)")
    if cfg.time_jitter or cfg.condition_upsample:
        raise NotImplementedError("time_jitter and condition_upsample are "
                                  "not ported to training (ROADMAP.md queue "
                                  "A)")
    if world < 2 or length % (world * RATIO):
        raise ValueError(f"-length {length} must split into {world} shards "
                         f"of a multiple of {RATIO} samples")
    # shards of a multiple of 64 samples always have a plan (q = 64 at
    # worst): JAX's fallback for plans that fail is never needed here
    return fused_sp_groups(cfg.wavenet, RATIO, length // world)[0]


def time_sharded_encoder_64(params, state, x_l, sh: Shards, *,
                            train: bool = True):
    """Encoder_64 on a time shard (timeshard.py:176-218): x_l [B, T_l, 1]
    -> (z_e [B, T_l/64, latent], new state), this shard's frames of the
    single-device encoder.  XLA's SAME for k=5, s=2 reads in[2o-1 ..
    2o+3], so 1 column comes from the left and 3 from the right."""
    net = x_l
    new_bn = []
    for i, conv in enumerate(params["convs"]):
        net = conv1d(exchange_both(net, 1, 3, sh), conv["kernel"],
                     conv["bias"], stride=2, padding="VALID")
        net, s = batch_norm(params["bn"][i], state["bn"][i],
                            torch.relu(net), train=train, sh=sh)
        new_bn.append(s)
    net = conv1d(net, params["out"]["kernel"], params["out"]["bias"],
                 padding="VALID")
    i = len(params["convs"])
    net, s = batch_norm(params["bn"][i], state["bn"][i], net, train=train,
                        sh=sh)
    new_bn.append(s)
    return net, {"bn": new_bn}


def _sharded_causal_conv(x_l, kernel, bias, dilation: int, sh: Shards):
    """Causal dilated conv on a time shard: the (K-1)*d left-context
    columns from the neighbour(s), then VALID (timeshard.py:229-237)."""
    halo = (kernel.shape[0] - 1) * dilation
    ext = torch.cat([left_halo(x_l, halo, sh), x_l], dim=1)
    return conv1d(ext, kernel, bias, padding="VALID", dilation=dilation)


def time_sharded_wavenet_logits_fused(params, wcfg, x_l, local_condition,
                                      sh: Shards, groups, *,
                                      gate_order: str = "tanh_first"):
    """The WaveNet decoder on a time shard, one residual-stack kernel call
    per dilation cycle with its recompute halo (timeshard.py:415-487).
    x_l [B, T_l, 1] and local_condition [B, T_l/FR, C] in the compute
    type; returns the logits [B, T_l, Q] f32."""
    cd = x_l.dtype
    t_l = x_l.shape[1]
    ratio = t_l // local_condition.shape[1]
    net = mu_law_encode(sharded_shift_right(x_l, sh),
                        wcfg.quantization_channels).to(cd)
    net = _sharded_causal_conv(net, params["preprocess"]["kernel"],
                               params["preprocess"]["bias"], 1, sh)
    skip = (net.float() @ params["skip_start"]["kernel"][0].float()
            + params["skip_start"]["bias"].float())
    stream = net
    for gi, (lo, hi, halo) in enumerate(groups):
        last = gi == len(groups) - 1
        ext = torch.cat([left_halo(stream, halo, sh), stream], dim=1)
        lc_ext = torch.cat([left_halo(local_condition, halo // ratio, sh),
                            local_condition], dim=1)
        out = fused_residual_stack(
            params["layers"], wcfg, ext, lc_ext, None, gate_order=gate_order,
            start_rows=max(halo - sh.rank * t_l, 0), layer_range=(lo, hi),
            with_xout=not last)
        if last:
            skip_g = out
        else:
            skip_g, stream_ext = out
            stream = stream_ext[:, halo:]
        skip = skip + skip_g[:, halo:]
    return wavenet_heads(params, skip, local_condition, None, cd)


def time_sharded_loss(params, state, cfg, x_l, y, sh: Shards, *,
                      train: bool = True, decoder_halo: str = "fused"):
    """The VQVAE loss with the time axis sharded (timeshard.py:570-767,
    vq_mode 'st' or 'joint').  x_l: this rank's [B, T_l, 1] f32; y: one-hot
    [B, 1, speakers] (the whole batch's, on every rank).  Returns (share,
    aux): share = this rank's local loss / N (module docstring); aux holds
    the global loss and its parts, perplexity, distances_mean and the new
    model state (the same on every rank)."""
    groups = check_supported(cfg, x_l.shape[1] * sh.world, sh.world,
                             decoder_halo)
    bf16 = cfg.train_dtype == "bf16"
    if bf16:
        z_e, enc_state = time_sharded_encoder_64(
            _cast(params["encoder"], torch.bfloat16), state["encoder"],
            x_l.to(torch.bfloat16), sh, train=train)
    else:
        z_e, enc_state = time_sharded_encoder_64(
            params["encoder"], state["encoder"], x_l, sh, train=train)
    z_e = z_e.float()
    aux = {"state": {"encoder": enc_state}}
    if "vq" in state:
        aux["state"]["vq"] = state["vq"]
    scalars = {}
    if cfg.use_vq:
        # the perplexity and distances_mean of every rank's frames
        q = vq_mod.quantize(params["vq"], z_e, mode=cfg.vq_mode, sh=sh)
        z_q, e_k = q["z_q"], q["e_k"]
        aux["perplexity"] = q["perplexity"]
        aux["distances_mean"] = q["distances_mean"]
    else:
        z_q = e_k = z_e
    lc = build_local_condition(params, cfg, z_q, y)
    Q = cfg.wavenet.quantization_channels
    dec = _cast(params["decoder"], torch.bfloat16) if bf16 \
        else params["decoder"]
    cd = torch.bfloat16 if bf16 else torch.float32
    logits = time_sharded_wavenet_logits_fused(
        dec, cfg.wavenet, x_l.to(cd), lc.to(cd), sh, groups)
    labels = mu_law_encode(x_l[..., 0], Q, to_int=True)
    recon = F.cross_entropy(logits.reshape(-1, Q).float(),
                            labels.reshape(-1).long())
    local = recon
    scalars["reconstruction_loss"] = recon
    if cfg.use_vq:
        vq_loss, commit = vq_mod.vq_losses(z_e, e_k, cfg.beta,
                                           mode=cfg.vq_mode)
        local = local + vq_loss + commit
        scalars["vq_loss"] = vq_loss
        scalars["commitment_loss"] = commit
    scalars["loss"] = local
    names = sorted(scalars)
    means = all_reduce_(torch.stack([scalars[n].detach().float()
                                     for n in names]), sh) / sh.world
    aux.update({n: means[i] for i, n in enumerate(names)})
    return local / sh.world, aux


def sp_loss_and_grads(params, model_state, cfg, batch, sh: Shards, *,
                      decoder_halo: str = "fused"):
    """train_loop.loss_and_grads under SP: batch = {"x": this rank's
    [B, T_l, 1], "y": the whole batch's [B, 1, speakers]}.  Returns (the
    global loss, aux, grads): the gradient of the global loss, the same on
    every rank, in tree_leaves(params) order (zeros where the loss does not
    reach a parameter).  ``train_loop.train_step(..., grads_fn=...)`` with
    it is the SP step of timeshard.py:928-1019: the replicas stay
    identical."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        share, aux = time_sharded_loss(p, model_state, cfg, batch["x"],
                                       batch.get("y"), sh,
                                       decoder_halo=decoder_halo)
        grads = torch.autograd.grad(share, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return aux["loss"], _detach(aux), sum_grads(grads, sh)
