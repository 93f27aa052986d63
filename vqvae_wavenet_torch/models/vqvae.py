"""VQVAE assembly (port of vqvae_wavenet_tpu/models/vqvae.py:77-232):
encoder -> VQ -> speaker vector concatenated onto the local condition ->
WaveNet decoder; the training forward with the reference's loss, and the
generation-time encoding.

Training numerics (vqvae.py:122-215): under train_dtype 'f32' the stack
kernel runs in f32 and the heads and loss are plain torch; under 'bf16'
the encoder runs in bf16 with z_e back in f32 (Encoder_2019 stays f32, as
in JAX, vqvae.py:132: its MFCC front end frames and transforms the
waveform, which bf16 would degrade), the decoder parameters and
the local condition run in bf16, labels come from the f32 waveform, and
the stack kernel hands its skip sum to the loss-head kernel
(ops/epilogue_kernels.py).  ``condition_upsample`` runs the condition
through cond_conv and repeats it to one frame a sample (the kernels then
see T frames); ``time_jitter`` moves each latent frame by -1, 0 or +1
(vqvae.py:87-100), with the moves drawn apart from their application
(``jitter_moves``: the training loop draws them from the global step, as
JAX's train.py:222 seeds PRNGKey(gs + step)).

Reference quirk kept (vqvae.py:77-84): an all-zero one-hot ("None"
speaker) argmax-selects index 0, so "no speaker" conditions on speaker 0's
embedding when speaker_embedding > 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from vqvae_wavenet_torch.models import encoders as enc
from vqvae_wavenet_torch.models import vq as vq_mod
from vqvae_wavenet_torch.models.wavenet import (split_decoder,
                                                wavenet_forward,
                                                wavenet_logits, wavenet_loss)
from vqvae_wavenet_torch.ops.conv import conv1d
from vqvae_wavenet_torch.ops.epilogue_kernels import fused_epilogue
from vqvae_wavenet_torch.ops.mu_law import mu_law_encode
from vqvae_wavenet_torch.parallel.comm import gather_replicated


def speaker_vector(params, cfg, y: Optional[torch.Tensor]):
    """y: one-hot [B, 1, num_speakers] -> h [B, 1, C_gc] (model.py:19-32)."""
    if y is None:
        return None
    if cfg.speaker_embedding > 0:
        idx = torch.argmax(y, dim=-1)   # all-zero one-hot -> index 0
        return params["speaker_embedding"][idx]
    return y


JITTER_PROB = 0.12     # a frame moves with .06 to each side (vqvae.py:87)


def jitter_moves(seed: int, batch: int, frames: int) -> torch.Tensor:
    """The time jitter's moves [batch, frames] int64 in {-1, 0, +1} with
    probabilities .06, .88, .06, drawn per sequence from a CPU
    torch.Generator seeded with ``seed`` (the same on every rank, which
    takes its own rows).  JAX draws them with jax.random.categorical; the
    two agree in distribution only."""
    g = torch.Generator().manual_seed(int(seed))
    u = torch.rand((batch, frames), generator=g, dtype=torch.float64)
    return (u >= 1.0 - JITTER_PROB / 2).long() - (u < JITTER_PROB / 2).long()


def time_jitter(lc: torch.Tensor, moves: torch.Tensor) -> torch.Tensor:
    """lc [B, T, C] with frame t replaced by frame t + moves[b, t], edges
    reflected (an index below 0 moves +2, one at T or past it -2), per
    sequence (vqvae.py:87-100)."""
    t = lc.shape[1]
    idx = torch.arange(t, device=lc.device)[None, :] + moves.to(lc.device)
    idx = idx + 2 * (idx < 0).long() - 2 * (idx >= t).long()
    return torch.gather(lc, 1, idx[..., None].expand(-1, -1, lc.shape[2]))


def build_local_condition(params, cfg, z_q: torch.Tensor,
                          y: Optional[torch.Tensor],
                          target_len: Optional[int] = None,
                          moves: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """concat(z_q, tiled h), the time jitter when cfg.time_jitter and the
    ``moves`` [B, T_cond] are given (training), then conv_3_128 and the
    upsampling to ``target_len`` when cfg.condition_upsample.  Returns
    [B, T_cond, C_lc] (T_cond = target_len when upsampled)."""
    h = speaker_vector(params, cfg, y)
    lc = z_q
    if h is not None:
        lc = torch.cat([lc, h.to(lc.dtype).expand(lc.shape[0], lc.shape[1],
                                                   h.shape[-1])], dim=-1)
    if cfg.time_jitter and moves is not None:
        lc = time_jitter(lc, moves)
    if cfg.condition_upsample:
        lc = conv1d(lc, params["cond_conv"]["kernel"],
                    params["cond_conv"]["bias"], padding="SAME")
        if target_len is not None and target_len != lc.shape[1]:
            lc = torch.repeat_interleave(lc, target_len // lc.shape[1], dim=1)
    return lc


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def vqvae_forward(params, state, cfg, x: torch.Tensor,
                  y: Optional[torch.Tensor], *, train: bool = True,
                  sh=None, jitter: Optional[torch.Tensor] = None):
    """The training forward.  x: [B, T, 1] raw waveform; y: one-hot
    [B, 1, num_speakers] or None.  Returns (loss, aux): aux carries the
    individual losses, the metrics, the new model state (BN running
    statistics; the VQ EMA state passes through) and z_e, z_q, q_z_x.
    ``sh`` (parallel.Shards): x is this rank's slice of a data-parallel
    batch; the batch norms and the VQ statistics span the data group
    (vqvae.py:123-147 with axis_name), the losses stay this rank's.  On a
    data x model mesh the params are the rank's shards (parallel/mesh.py):
    the encoder and the decoder split their products over the model row,
    and under bf16 the loss head takes the whole skip sum and
    postprocess1's rows joined over the row.
    ``jitter``: the time jitter's moves [B, T_cond] (``jitter_moves``),
    applied when cfg.time_jitter and train (JAX's rng)."""
    bf16 = cfg.train_dtype == "bf16"
    # Encoder_Magenta and Encoder_2019 have no state, and their empty tree
    # leaves no key in an .npz checkpoint
    enc_state0 = state.get("encoder", {})
    if bf16 and cfg.encoder != "2019":
        z_e, enc_state = enc.encoder_forward(
            cfg.encoder, _cast(params["encoder"], torch.bfloat16),
            enc_state0, x.to(torch.bfloat16), norm=cfg.encoder_norm,
            train=train, sh=sh)
        z_e = z_e.float()
    else:
        z_e, enc_state = enc.encoder_forward(
            cfg.encoder, params["encoder"], enc_state0, x,
            norm=cfg.encoder_norm, train=train, sh=sh)
    aux = {"z_e": z_e, "state": {"encoder": enc_state}}
    if cfg.use_vq:
        q = vq_mod.quantize(params["vq"], z_e, mode=cfg.vq_mode, sh=sh)
        z_q, e_k = q["z_q"], q["e_k"]
        aux.update(q_z_x=q["q_z_x"], perplexity=q["perplexity"], z_q=z_q,
                   e_k=e_k, distances_mean=q["distances_mean"])
        if "vq" in state:
            aux["state"]["vq"] = state["vq"]
    else:
        z_q = e_k = z_e
        aux["z_q"] = z_q

    lc = build_local_condition(params, cfg, z_q, y, target_len=x.shape[1],
                               moves=jitter if train else None)
    Q = cfg.wavenet.quantization_channels
    if bf16:
        dec16 = _cast(params["decoder"], torch.bfloat16)
        labels = mu_law_encode(x, Q, to_int=True)[..., 0]          # [B, T]
        lc16 = lc.to(torch.bfloat16)
        skip = wavenet_logits(dec16, cfg.wavenet, x.to(torch.bfloat16), lc16,
                              return_skip=True, sh=sh)
        pp1 = dec16["postprocess1"]
        if split_decoder(dec16, sh):
            pp1 = dict(pp1, kernel=gather_replicated(pp1["kernel"], 1, sh))
        recon = fused_epilogue(pp1, dec16["postprocess2"], skip, lc16, None,
                               labels)
    else:
        logits, labels = wavenet_forward(params["decoder"], cfg.wavenet, x,
                                         lc, sh=sh)
        recon = wavenet_loss(logits, labels)
    loss = recon
    aux["reconstruction_loss"] = recon
    if cfg.use_vq:
        vq_loss, commitment = vq_mod.vq_losses(z_e, e_k, cfg.beta,
                                               mode=cfg.vq_mode)
        loss = loss + vq_loss + commitment
        aux["vq_loss"] = vq_loss
        aux["commitment_loss"] = commitment
    aux["loss"] = loss
    return loss, aux


def vqvae_encode(params, state, cfg, x: torch.Tensor,
                 y: Optional[torch.Tensor]):
    """Encode the conditioning wav x [B, T, 1] once: returns the decoder's
    local condition [B, T_cond, C_lc] and the code indices (or None)."""
    z_e, _ = enc.encoder_forward(cfg.encoder, params["encoder"],
                                 state.get("encoder", {}), x,
                                 norm=cfg.encoder_norm)
    if cfg.use_vq:
        q = vq_mod.quantize(params["vq"], z_e, mode=cfg.vq_mode)
        z_q, codes = q["z_q"], q["q_z_x"]
    else:
        z_q, codes = z_e, None
    lc = build_local_condition(params, cfg, z_q, y, target_len=x.shape[1])
    return lc, codes
