"""Sequence-parallel (SP) training: the time axis of each clip split over
the n_time ranks of a time row, with halo exchanges (port of
vqvae_wavenet_tpu/parallel/timeshard.py: ``time_sharded_loss``,
``time_sharded_magenta_loss`` and the step of ``make_sp_train_step``).
Under the data x time mesh (parallel/__init__.py) each time row holds its
own part of the batch.

Per rank, on its shard x_l [B_l, T/N, 1]:
  encoder   Encoder_64: each stride-2 SAME conv (k=5) pulls 1 column from
            the left neighbour and 3 from the right; the batch norms'
            statistics are means over every rank (``pmean``), the group
            norms' over the time row, so they equal the single-device
            statistics.  Encoder_Magenta and the Magenta family's encoder:
            causal convs with left halos only (the strided 1x1 downsamples
            and the window-2 pools are local on shards of a multiple of 64
            samples).  Encoder_2019: the MFCC front end takes a fixed right
            halo of 240 samples, every SAME conv on its frames a (1, 1)
            frame halo.
  VQ        per shard, through the VQ kernel; the perplexity counts codes
            over every rank, distances_mean is their mean.
  decoder   shift_right and the preprocess conv over shard boundaries, then
            the residual stack in layer groups (``sp_groups``), one call of
            the stack kernels per group on the shard extended by the
            group's halo, with start = max(halo - t * T_l, 0): the rows
            that would lie before the sequence start are left out, which is
            the causal zero pad (ops/train_kernels.py, the SP variants).
            Every group but the last also returns its residual stream, whose
            last T_l rows feed the next group.  The heads are plain torch on
            the shard.  Every ``decoder_halo`` is such a plan: 'fused'
            (= 'auto') a group per dilation cycle, 'recompute' one group of
            every layer with the receptive field as its halo, 'layer' a
            group per layer with its own (K-1)*d rows; each halo is a whole
            number of condition frames.
  loss      recon, VQ and commitment (and the Magenta family's
            regularization) losses are local means; the global loss is
            their mean over every rank.

Gradients.  The loss functions return this rank's SHARE of the global loss
(its local loss / world).  Backward on the share on every rank, with the
exchanges' transposes carrying halo cotangents back to their owners and
``pmean``'s backward averaging the statistics' cotangents, and then a sum
of the parameter gradients over the ranks gives the gradient of the global
loss.  ``sp_loss_and_grads`` does that sum; train_loop.train_step with
it as ``grads_fn`` applies the fused Adam/EMA update (and under vq_mode
'ema' the codebook's EMA over every rank's codes), so every rank holds the
same train state.

bf16 (``train_dtype='bf16'``) follows the single-device contract
(models/vqvae.py, models/magenta.py): encoder convs in bf16 (Encoder_2019
and the Magenta family's encoder stay f32), the decoder in bf16, norm
statistics, VQ, labels and loss in f32.  ``time_jitter`` and
``condition_upsample`` raise NotImplementedError under SP, as JAX's SP
asserts (vqvae_wavenet_tpu/parallel/timeshard.py:613); one device and DP
train both.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from vqvae_wavenet_torch.models import vq as vq_mod
from vqvae_wavenet_torch.models.encoders import (
    MAGENTA_DILATIONS, batch_norm, encoder_downsample_rate, group_norm)
from vqvae_wavenet_torch.models.magenta import (
    AE_NUM_STAGES, magenta_wavenet_config, regularization_loss)
from vqvae_wavenet_torch.models.vqvae import _cast, build_local_condition
from vqvae_wavenet_torch.models.wavenet import wavenet_heads
from vqvae_wavenet_torch.ops.conv import conv1d
from vqvae_wavenet_torch.ops.mu_law import mu_law_encode
from vqvae_wavenet_torch.ops.signal import mfcc, pool1d
from vqvae_wavenet_torch.ops.train_kernels import fused_residual_stack
from vqvae_wavenet_torch.parallel import Shards
from vqvae_wavenet_torch.parallel.comm import (
    all_reduce_, exchange_both, left_halo, sharded_shift_right, sum_grads)
from vqvae_wavenet_torch.training.optimizer import tree_leaves, tree_unflatten
from vqvae_wavenet_torch.training.train_loop import _detach

# 'layer' runs as 'recompute' past this depth (timeshard.py:614-619)
MAX_LAYER_HALO_LAYERS = 64


def halo_sizes(wcfg, ratio: int) -> Tuple[int, int]:
    """(halo samples, halo frames): the receptive field rounded up to
    conditioning frames (timeshard.py:31-34)."""
    frames = -(-wcfg.receptive_field // ratio)
    return frames * ratio, frames


def fused_sp_groups(wcfg, ratio: int, t_l: int):
    """One layer group per dilation cycle, each with a recompute halo of its
    own receptive field sum((K-1)*d) rounded up to q: JAX's q, the largest
    of 512, 256, 128, 64 dividing the shard length that is a whole number
    of frames (timeshard.py:383-412), or else the frame length itself (the
    port's kernels take any start).  Returns ([(lo, hi, halo), ...], q)."""
    p = wcfg.num_cycle_layers
    q = next((t for t in (512, 256, 128, 64)
              if t_l % t == 0 and t % ratio == 0), ratio)
    groups = []
    for c in range(wcfg.num_cycles):
        lo, hi = c * p, (c + 1) * p
        raw = sum((wcfg.kernel_size - 1) * int(d)
                  for d in wcfg.dilation_rates[lo:hi])
        groups.append((lo, hi, -(-raw // q) * q))
    return groups, q


def sp_groups(wcfg, ratio: int, t_l: int,
              decoder_halo: str = "fused") -> List[Tuple[int, int, int]]:
    """The decoder's layer groups [(lo, hi, halo rows), ...] for shards of
    ``t_l`` samples with ``ratio`` samples a frame (module docstring);
    'layer' past MAX_LAYER_HALO_LAYERS layers is 'recompute'."""
    L = wcfg.num_layers
    if decoder_halo == "layer" and L > MAX_LAYER_HALO_LAYERS:
        decoder_halo = "recompute"
    if decoder_halo in ("auto", "fused"):
        return fused_sp_groups(wcfg, ratio, t_l)[0]
    if decoder_halo == "recompute":
        return [(0, L, halo_sizes(wcfg, ratio)[0])]
    if decoder_halo == "layer":
        return [(l, l + 1,
                 -(-(wcfg.kernel_size - 1) * int(d) // ratio) * ratio)
                for l, d in enumerate(wcfg.dilation_rates)]
    raise ValueError(f"decoder_halo {decoder_halo!r}: want auto, fused, "
                     f"layer or recompute")


def check_supported(cfg, length: int, n_time: int,
                    decoder_halo: str = "fused") -> List[Tuple[int, int, int]]:
    """Raise for what the port's SP path does not cover; return the decoder's
    group plan for clips of ``length`` samples on ``n_time`` time shards."""
    if cfg.time_jitter or cfg.condition_upsample:
        raise NotImplementedError("time_jitter and condition_upsample do "
                                  "not train time-sharded (JAX's SP asserts "
                                  "the same); train them on one device or "
                                  "data-parallel")
    ratio = encoder_downsample_rate(cfg.encoder)
    if n_time < 2 or length % (n_time * ratio):
        raise ValueError(f"-length {length} must split into {n_time} shards "
                         f"of a multiple of {ratio} samples")
    wcfg = (magenta_wavenet_config() if cfg.model_family == "magenta"
            else cfg.wavenet)
    return sp_groups(wcfg, ratio, length // n_time, decoder_halo)


def _sharded_causal_conv(x_l, kernel, bias, dilation: int, sh: Shards):
    """Causal dilated conv on a time shard: the (K-1)*d left-context
    columns from the neighbour(s), then VALID (timeshard.py:229-237)."""
    halo = (kernel.shape[0] - 1) * dilation
    ext = torch.cat([left_halo(x_l, halo, sh), x_l], dim=1)
    return conv1d(ext, kernel, bias, padding="VALID", dilation=dilation)


def time_sharded_encoder_64(params, state, x_l, sh: Shards, *,
                            norm: str = "batch", train: bool = True):
    """Encoder_64 on a time shard (timeshard.py:176-218): x_l [B, T_l, 1]
    -> (z_e [B, T_l/64, latent], new state), this shard's frames of the
    single-device encoder.  XLA's SAME for k=5, s=2 reads in[2o-1 ..
    2o+3], so 1 column comes from the left and 3 from the right."""
    new_bn = []

    def normalize(i, net):
        if norm == "batch":
            net, s = batch_norm(params["bn"][i], state["bn"][i], net,
                                train=train, sh=sh)
        else:
            net, s = group_norm(params["bn"][i], net, sh=sh), state["bn"][i]
        new_bn.append(s)
        return net

    net = x_l
    for i, conv in enumerate(params["convs"]):
        net = conv1d(exchange_both(net, 1, 3, sh), conv["kernel"],
                     conv["bias"], stride=2, padding="VALID")
        net = normalize(i, torch.relu(net))
    net = conv1d(net, params["out"]["kernel"], params["out"]["bias"],
                 padding="VALID")
    return normalize(len(params["convs"]), net), {"bn": new_bn}


def time_sharded_encoder_magenta(params, state, x_l, sh: Shards, **_):
    """Encoder_Magenta on a time shard (timeshard.py:350-379): every conv
    is causal, so only left halos are exchanged; the 1x1 stride-2
    downsamples are local on shards of an even length."""
    net = mu_law_encode(sharded_shift_right(x_l, sh)).to(x_l.dtype)
    en = _sharded_causal_conv(net, params["preprocess"]["kernel"],
                              params["preprocess"]["bias"], 1, sh)
    for layer, dil in zip(params["layers"], MAGENTA_DILATIONS):
        d = conv1d(en, layer["down"]["kernel"], layer["down"]["bias"],
                   stride=2, padding="VALID")
        g = _sharded_causal_conv(d, layer["gate"]["kernel"],
                                 layer["gate"]["bias"], dil, sh)
        f = _sharded_causal_conv(d, layer["filter"]["kernel"],
                                 layer["filter"]["bias"], dil, sh)
        gated = torch.tanh(g) * torch.sigmoid(f)
        en = d + _sharded_causal_conv(gated, layer["residual"]["kernel"],
                                      layer["residual"]["bias"], 1, sh)
    return _sharded_causal_conv(en, params["postprocess"]["kernel"],
                                params["postprocess"]["bias"], 1, sh), state


# Encoder_2019's MFCC frames: 400-sample windows every 160 samples
MFCC_RIGHT_HALO = 400 - 160


def time_sharded_encoder_2019(params, state, x_l, sh: Shards, **_):
    """Encoder_2019 on a time shard (timeshard.py:525-567), float32.  Frame
    f reads samples [160 f, 160 f + 400), so a shard of T_l samples (T_l %
    320 == 0) takes a right halo of 240 samples (the last shard's zeros
    are the single-device pad_end zeros) and frames it without padding;
    every SAME conv on the frames takes a (1, 1) frame halo (XLA's SAME
    for k=3, and for k=4 with stride 2 on an even length)."""
    net = mfcc(exchange_both(x_l, 0, MFCC_RIGHT_HALO, sh)[..., 0],
               pad_end=False)                             # [B, T_l/160, 13]

    def conv(h, p, stride=1):
        return conv1d(exchange_both(h, 1, 1, sh), p["kernel"], p["bias"],
                      stride=stride, padding="VALID")

    net = torch.relu(conv(net, params["pre1"]))
    net = torch.relu(conv(net, params["pre2"])) + net
    net = torch.relu(conv(net, params["strided"], stride=2))
    for p in params["res"]:
        net = torch.relu(conv(net, p)) + net
    for p in params["relu"]:
        r = torch.relu(conv(net, p))
        net = r + r          # the reference's oddity: 2 * relu(conv(net))
    return conv1d(net, params["out"]["kernel"], params["out"]["bias"],
                  padding="VALID"), state


SHARDED_ENCODERS = {"64": time_sharded_encoder_64,
                    "Magenta": time_sharded_encoder_magenta,
                    "2019": time_sharded_encoder_2019}


def time_sharded_wavenet_logits_fused(params, wcfg, x_l, local_condition,
                                      sh: Shards, groups, *,
                                      global_condition=None,
                                      gate_order: str = "tanh_first"):
    """The WaveNet decoder on a time shard, one residual-stack kernel call
    per layer group with its recompute halo (timeshard.py:415-487).
    x_l [B, T_l, 1], local_condition [B, T_l/FR, C] and global_condition
    [B, 1, C_gc] or None in the compute type; returns the logits
    [B, T_l, Q] f32."""
    cd = x_l.dtype
    t_l = x_l.shape[1]
    ratio = t_l // local_condition.shape[1]
    net = mu_law_encode(sharded_shift_right(x_l, sh),
                        wcfg.quantization_channels).to(cd)
    net = _sharded_causal_conv(net, params["preprocess"]["kernel"],
                               params["preprocess"]["bias"], 1, sh)
    skip = (net.float() @ params["skip_start"]["kernel"][0].float()
            + params["skip_start"]["bias"].float())
    gc = global_condition if "gc_kernel" in params["layers"] else None
    stream = net
    for gi, (lo, hi, halo) in enumerate(groups):
        last = gi == len(groups) - 1
        ext = torch.cat([left_halo(stream, halo, sh), stream], dim=1)
        lc_ext = torch.cat([left_halo(local_condition, halo // ratio, sh),
                            local_condition], dim=1)
        out = fused_residual_stack(
            params["layers"], wcfg, ext, lc_ext, gc, gate_order=gate_order,
            start_rows=max(halo - sh.time_rank * t_l, 0),
            layer_range=(lo, hi), with_xout=not last)
        if last:
            skip_g = out
        else:
            skip_g, stream_ext = out
            stream = stream_ext[:, halo:]
        skip = skip + skip_g[:, halo:]
    return wavenet_heads(params, skip, local_condition, global_condition, cd)


def _recon_loss(logits, x_l, Q: int):
    labels = mu_law_encode(x_l[..., 0], Q, to_int=True)
    return F.cross_entropy(logits.reshape(-1, Q).float(),
                           labels.reshape(-1).long())


def _share(scalars, aux, sh: Shards):
    """(this rank's share local / world of the loss, aux with every scalar's
    mean over the ranks added)."""
    names = sorted(scalars)
    means = all_reduce_(torch.stack([scalars[n].detach().float()
                                     for n in names]), sh) / sh.world
    aux.update({n: means[i] for i, n in enumerate(names)})
    return scalars["loss"] / sh.world, aux


def time_sharded_loss(params, state, cfg, x_l, y, sh: Shards, *,
                      train: bool = True, decoder_halo: str = "fused"):
    """The VQVAE loss with the time axis sharded (timeshard.py:570-767):
    any of the three encoders and norms, vq_mode 'st', 'joint' or 'ema'.
    x_l: this rank's [B_l, T_l, 1] f32; y: one-hot [B_l, 1, speakers] of
    this rank's clips (whole).  Returns (share, aux): share = this rank's
    local loss / world (module docstring); aux holds the global loss and
    its parts, perplexity, distances_mean and the new model state (the same
    on every rank), and this rank's z_e and q_z_x (for the EMA codebook)."""
    groups = check_supported(cfg, x_l.shape[1] * sh.n_time, sh.n_time,
                             decoder_halo)
    bf16 = cfg.train_dtype == "bf16"
    encode = SHARDED_ENCODERS[cfg.encoder]
    enc_state0 = state.get("encoder", {})
    if bf16 and cfg.encoder != "2019":
        z_e, enc_state = encode(
            _cast(params["encoder"], torch.bfloat16), enc_state0,
            x_l.to(torch.bfloat16), sh, norm=cfg.encoder_norm, train=train)
    else:
        z_e, enc_state = encode(params["encoder"], enc_state0, x_l, sh,
                                norm=cfg.encoder_norm, train=train)
    z_e = z_e.float()
    aux = {"state": {"encoder": enc_state}, "z_e": z_e}
    if "vq" in state:
        aux["state"]["vq"] = state["vq"]
    scalars = {}
    if cfg.use_vq:
        q = vq_mod.quantize(params["vq"], z_e, mode=cfg.vq_mode, sh=sh)
        z_q, e_k = q["z_q"], q["e_k"]
        aux.update(perplexity=q["perplexity"], q_z_x=q["q_z_x"],
                   distances_mean=q["distances_mean"])
    else:
        z_q = e_k = z_e
    lc = build_local_condition(params, cfg, z_q, y)
    dec = _cast(params["decoder"], torch.bfloat16) if bf16 \
        else params["decoder"]
    cd = torch.bfloat16 if bf16 else torch.float32
    logits = time_sharded_wavenet_logits_fused(
        dec, cfg.wavenet, x_l.to(cd), lc.to(cd), sh, groups)
    recon = _recon_loss(logits, x_l, cfg.wavenet.quantization_channels)
    local = recon
    scalars["reconstruction_loss"] = recon
    if cfg.use_vq:
        vq_loss, commit = vq_mod.vq_losses(z_e, e_k, cfg.beta,
                                           mode=cfg.vq_mode)
        local = local + vq_loss + commit
        scalars["vq_loss"] = vq_loss
        scalars["commitment_loss"] = commit
    scalars["loss"] = local
    return _share(scalars, aux, sh)


def time_sharded_magenta_encode(params, x_l, sh: Shards):
    """The Magenta family's encoder (models/magenta.py::magenta_encode) on a
    time shard (timeshard.py:770-797): 1x1 convs and causal gated pairs
    with left halos; the window-2 average pools are local on shards of a
    multiple of 64 samples."""
    en = conv1d(mu_law_encode(x_l), params["startconv"]["kernel"],
                params["startconv"]["bias"], padding="SAME")
    for i, layer in enumerate(params["layers"]):
        dilation = 2 ** (i % AE_NUM_STAGES)
        conv = _sharded_causal_conv(en, layer["conv"]["kernel"],
                                    layer["conv"]["bias"], dilation, sh)
        gate = _sharded_causal_conv(en, layer["gate"]["kernel"],
                                    layer["gate"]["bias"], dilation, sh)
        d = torch.tanh(conv) * torch.sigmoid(gate)
        en = en + conv1d(d, layer["res"]["kernel"], layer["res"]["bias"],
                         padding="SAME")
        en = pool1d(en, 2)
    return conv1d(en, params["bottleneck"]["kernel"],
                  params["bottleneck"]["bias"], padding="SAME")


def time_sharded_magenta_loss(params, cfg, x_l, y, sh: Shards, *,
                              decoder_halo: str = "fused"):
    """The Magenta family's training loss (models/magenta.py::
    magenta_forward) with the time axis sharded (timeshard.py:800-925):
    the encoder and VQ in f32, the decoder through the stack kernels with
    the speaker's global condition in every layer (sigmoid first), in bf16
    under train_dtype 'bf16'.  x_l [B_l, T_l, 1]; y one-hot [B_l, 1, S].
    Returns (share, aux) as ``time_sharded_loss``; the regularization
    loss, the same on every rank, is in every rank's local loss."""
    wcfg = magenta_wavenet_config()
    groups = check_supported(cfg, x_l.shape[1] * sh.n_time, sh.n_time,
                             decoder_halo)
    z_e = time_sharded_magenta_encode(params["encoder"], x_l, sh)
    q = vq_mod.quantize(params["vq"], z_e, mode="st", sh=sh)
    e_k, z_q = q["e_k"], q["z_q"]
    vq_loss, commit = vq_mod.vq_losses(z_e, e_k, 0.25, mode="st")
    gc = params["speaker_emb"][torch.argmax(y, dim=-1)]        # [B, 1, 64]
    dec, cd = params["decoder"], torch.float32
    if cfg.train_dtype == "bf16":
        dec, cd = _cast(dec, torch.bfloat16), torch.bfloat16
    logits = time_sharded_wavenet_logits_fused(
        dec, wcfg, x_l.to(cd), z_q.to(cd), sh, groups,
        global_condition=gc.to(cd), gate_order="sigmoid_first")
    recon = _recon_loss(logits, x_l, wcfg.quantization_channels)
    reg = regularization_loss(params)
    scalars = {"loss": recon + reg + vq_loss + commit,
               "reconstruction_loss": recon, "vq_loss": vq_loss,
               "commitment_loss": commit, "reg_loss": reg}
    aux = {"perplexity": q["perplexity"], "z_e": z_e, "q_z_x": q["q_z_x"],
           "distances_mean": q["distances_mean"]}
    return _share(scalars, aux, sh)


def sp_loss_and_grads(params, model_state, cfg, batch, sh: Shards, *,
                      decoder_halo: str = "fused"):
    """train_loop.loss_and_grads under SP: batch = {"x": this rank's
    [B_l, T_l, 1], "y": its clips' [B_l, 1, speakers]}.  Returns (the
    global loss, aux, grads): the gradient of the global loss, the same on
    every rank, in tree_leaves(params) order (zeros where the loss does not
    reach a parameter).  Routes by ``cfg.model_family`` (timeshard.py:
    951-966); ``train_loop.train_step(..., grads_fn=..., sh=sh)`` with it is
    the SP step of timeshard.py:928-1019: the replicas stay identical."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        if cfg.model_family == "magenta":
            share, aux = time_sharded_magenta_loss(
                p, cfg, batch["x"], batch["y"], sh,
                decoder_halo=decoder_halo)
        else:
            share, aux = time_sharded_loss(p, model_state, cfg, batch["x"],
                                           batch.get("y"), sh,
                                           decoder_halo=decoder_halo)
        grads = torch.autograd.grad(share, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return aux["loss"], _detach(aux), sum_grads(grads, sh)
