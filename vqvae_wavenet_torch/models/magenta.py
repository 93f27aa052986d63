"""The Magenta family: its voice-conversion path and its training forward
(port of vqvae_wavenet_tpu/models/magenta.py:39-69, 120-205, 217-257).

The hyperparameters are module constants, as in the JAX package (they are
hard-coded in the reference's Magenta/config.py:4-16); the port keeps its
own copy.  The decoder is the shared WaveNet with K=2, a startconv of
width 2 as its preprocess, per-layer biased global conditioning and the
gate halves swapped (sigmoid first).  Generation runs through the shared
whole-clip generation (generation/fast.py), so on the card it launches
the same kernel as the main family.

Training (``magenta_forward``) runs the decoder through the same
teacher-forced WaveNet as the main family (models/wavenet.py), so on the
card the stack goes through the training kernels with K=2, the gate
sigmoid first and the per-layer biased global condition folded into the
frame condition; the loss head is plain, as in JAX.  The loss adds the L2
regularization (``regularization_loss``) and the VQ losses (beta 0.25);
the optimizer is Adam with beta1 = 0.5 and MAGENTA_LR_SCHEDULE
(training/train_loop.py).

Reference quirk kept (magenta.py:245-246): an all-zero one-hot ('None'
speaker) argmax-selects index 0, so "no speaker" conditions on speaker 0's
embedding.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vqvae_wavenet_torch.config import WavenetConfig
from vqvae_wavenet_torch.models import vq as vq_mod
from vqvae_wavenet_torch.models.vqvae import _cast
from vqvae_wavenet_torch.models.wavenet import (split_decoder,
                                                wavenet_logits, wavenet_loss)
from vqvae_wavenet_torch.ops.conv import causal_conv1d, conv1d
from vqvae_wavenet_torch.ops.mu_law import mu_law_encode
from vqvae_wavenet_torch.ops.signal import pool1d
from vqvae_wavenet_torch.parallel.comm import reduce_model

MAGENTA_LR_SCHEDULE = {0: 1e-4, 60000: 8e-5, 80000: 6e-5, 100000: 4e-5,
                       120000: 2e-5, 140000: 1e-5}
MAGENTA_DECAY = 1e-6

# module-top hyperparams of Magenta/config.py:4-16
NUM_STAGES = 10
NUM_LAYERS = 50
FILTER_LENGTH = 2
WIDTH = 256
SKIP_WIDTH = 512
AE_NUM_STAGES = 5
AE_NUM_LAYERS = 6
AE_FILTER_LENGTH = 3
AE_WIDTH = 368
AE_BOTTLENECK_WIDTH = 64
K_CODES = 512


def magenta_wavenet_config() -> WavenetConfig:
    return WavenetConfig(
        quantization_channels=256,
        num_cycles=NUM_LAYERS // NUM_STAGES,
        num_cycle_layers=NUM_STAGES,
        dilation_rates=[2 ** (i % NUM_STAGES) for i in range(NUM_LAYERS)],
        kernel_size=FILTER_LENGTH,
        dilation_filters=WIDTH,
        skip_filters=SKIP_WIDTH,
        residual_filters=WIDTH,
        preprocess_kernel_size=FILTER_LENGTH,  # = 'startconv'
        preprocess_filters=WIDTH,
    )


def magenta_encode(params, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, 1] raw waveform -> z_e [B, T/64, 64] (config.py:200-249):
    a k=1 startconv, 6 x [causal gated conv pair (dilation 2^(i%5)),
    1x1 residual, avg-pool by 2], a 1x1 bottleneck."""
    en = conv1d(mu_law_encode(x), params["startconv"]["kernel"],
                params["startconv"]["bias"], padding="SAME")
    for i, layer in enumerate(params["layers"]):
        dilation = 2 ** (i % AE_NUM_STAGES)
        conv = causal_conv1d(en, layer["conv"]["kernel"],
                             layer["conv"]["bias"], dilation=dilation)
        gate = causal_conv1d(en, layer["gate"]["kernel"],
                             layer["gate"]["bias"], dilation=dilation)
        d = torch.tanh(conv) * torch.sigmoid(gate)
        en = en + conv1d(d, layer["res"]["kernel"], layer["res"]["bias"],
                         padding="SAME")
        en = pool1d(en, 2)
    return conv1d(en, params["bottleneck"]["kernel"],
                  params["bottleneck"]["bias"], padding="SAME")


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# the leaves a tensor-parallel rank holds its shard of (parallel/mesh.py)
SPLIT_LEAVES = ("/decoder/layers/skip_kernel", "/decoder/postprocess1/kernel")


def regularization_loss(params, sh=None) -> torch.Tensor:
    """Sum over the leaves of decay * ||w||^2, with decay * 10 on every
    leaf whose path holds "embedding" (the codebook vq/embedding; not
    speaker_emb), decay = MAGENTA_DECAY (magenta.py:139-148).  Under
    tensor parallelism (``sh``) the squares of a split leaf's shards are
    summed over the model row, so each counts once."""
    split = sh is not None and split_decoder(params["decoder"], sh)
    terms = {False: [], True: []}
    for path, leaf in _named_leaves(params):
        terms[split and path in SPLIT_LEAVES].append(
            MAGENTA_DECAY * (10.0 if "embedding" in path else 1.0)
            * torch.sum(torch.square(leaf)))
    if not terms[True]:
        return sum(terms[False])
    return sum(terms[False]) + reduce_model(sum(terms[True]), sh)


def magenta_forward(params, x: torch.Tensor, gc_one_hot: torch.Tensor,
                    train_dtype: str = "f32", sh=None):
    """The training forward (magenta.py:150-205).  x [B, T, 1] raw
    waveform, gc_one_hot [B, 1, num_speakers].  The encoder and the VQ run
    in float32; under train_dtype 'bf16' the decoder's parameters, its
    input, z_q and the speaker vector are cast to bfloat16 (master weights
    stay float32; labels and losses float32).  Returns (loss, aux).  With
    ``sh`` (a data-parallel rank's slice) the VQ statistics span the data
    group; the losses, the regularization included, are this rank's, whose
    mean over the ranks is the whole batch's.  On a data x model mesh the
    decoder's skip_kernel columns and postprocess1 rows are the rank's
    (models/wavenet.py); the encoder (368 wide) is whole."""
    cfg = magenta_wavenet_config()
    z_e = magenta_encode(params["encoder"], x)
    q = vq_mod.quantize(params["vq"], z_e, mode="st", sh=sh)
    e_k, z_q = q["e_k"], q["z_q"]
    vq_loss, commitment = vq_mod.vq_losses(z_e, e_k, 0.25, mode="st")
    gc = params["speaker_emb"][torch.argmax(gc_one_hot, dim=-1)]  # [B, 1, 64]
    Q = cfg.quantization_channels
    labels = mu_law_encode(x, Q, to_int=True).reshape(-1)
    dec, x_dec, z_q_dec, gc_dec = params["decoder"], x, z_q, gc
    if train_dtype == "bf16":
        bf = torch.bfloat16
        dec = _cast(dec, bf)
        x_dec, z_q_dec, gc_dec = x.to(bf), z_q.to(bf), gc.to(bf)
    logits = wavenet_logits(dec, cfg, x_dec, z_q_dec, gc_dec,
                            gate_order="sigmoid_first", sh=sh)
    recon = wavenet_loss(logits.float().reshape(-1, Q), labels)
    reg = regularization_loss(params, sh)
    loss = recon + reg + vq_loss + commitment
    return loss, {"reconstruction_loss": recon, "vq_loss": vq_loss,
                  "commitment_loss": commitment, "reg_loss": reg,
                  "perplexity": q["perplexity"], "z_e": z_e, "encoding": e_k,
                  "q_z_x": q["q_z_x"],
                  "distances_mean": q["distances_mean"]}


def magenta_generate(params, x_cond: torch.Tensor, gc_one_hot: torch.Tensor,
                     *, length: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     mode: str = "sample", dtype: torch.dtype = torch.float32,
                     verbose: bool = False, devices=None) -> torch.Tensor:
    """Encode the conditioning wav once, then generate with the decoder
    conditioned per layer on the codes (local) and the speaker (global).

    x_cond: [B, T, 1]; gc_one_hot: [B, 1, num_speakers]; ``length`` (a
    multiple of the frame ratio) may exceed T: the latent frames are
    zero-padded to it, and samples t < T never read the padded frames.
    ``dtype``: float32 | bfloat16 | int8 (generation/fast.py).  ``devices``
    shards the streams over them (parallel/genshard.py, magenta.py:247-253;
    default: x_cond's device).  Returns the float waveform [B, length]."""
    from vqvae_wavenet_torch.parallel.genshard import generate_sharded
    cfg = magenta_wavenet_config()
    length = length or x_cond.shape[1]
    z_e = magenta_encode(params["encoder"], x_cond)
    # config.py:278: the decoder sees e_k
    encoding = vq_mod.quantize(params["vq"], z_e, mode="st")["e_k"]
    if length > x_cond.shape[1]:
        ratio = x_cond.shape[1] // encoding.shape[1]
        if length % ratio:
            raise ValueError(f"length {length} is not a multiple of the frame "
                             f"ratio {ratio}")
        encoding = F.pad(encoding,
                         (0, 0, 0, (length - x_cond.shape[1]) // ratio))
    gc = params["speaker_emb"][torch.argmax(gc_one_hot, dim=-1)]  # [B, 1, 64]
    return generate_sharded(params["decoder"], cfg, encoding, length=length,
                            devices=devices or [x_cond.device],
                            generator=generator, mode=mode,
                            gate_order="sigmoid_first", dtype=dtype,
                            global_condition=gc, verbose=verbose)
