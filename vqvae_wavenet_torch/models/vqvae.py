"""VQVAE generation-time encoding (port of
vqvae_wavenet_tpu/models/vqvae.py:77-119, 218-232): encoder -> VQ ->
speaker vector concatenated onto the local condition.

Reference quirk kept (vqvae.py:77-84): an all-zero one-hot ("None"
speaker) argmax-selects index 0, so "no speaker" conditions on speaker 0's
embedding when speaker_embedding > 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from vqvae_wavenet_torch.models import encoders as enc
from vqvae_wavenet_torch.models import vq as vq_mod
from vqvae_wavenet_torch.ops.conv import conv1d


def speaker_vector(params, cfg, y: Optional[torch.Tensor]):
    """y: one-hot [B, 1, num_speakers] -> h [B, 1, C_gc] (model.py:19-32)."""
    if y is None:
        return None
    if cfg.speaker_embedding > 0:
        idx = torch.argmax(y, dim=-1)   # all-zero one-hot -> index 0
        return params["speaker_embedding"][idx]
    return y


def build_local_condition(params, cfg, z_q: torch.Tensor,
                          y: Optional[torch.Tensor],
                          target_len: Optional[int] = None) -> torch.Tensor:
    """concat(z_q, tiled h) (+ conv_3_128 and upsampling when
    cfg.condition_upsample), at train=False.  Returns [B, T_cond, C_lc]."""
    h = speaker_vector(params, cfg, y)
    lc = z_q
    if h is not None:
        lc = torch.cat([lc, h.to(lc.dtype).expand(lc.shape[0], lc.shape[1],
                                                   h.shape[-1])], dim=-1)
    if cfg.condition_upsample:
        lc = conv1d(lc, params["cond_conv"]["kernel"],
                    params["cond_conv"]["bias"], padding="SAME")
        if target_len is not None and target_len != lc.shape[1]:
            lc = torch.repeat_interleave(lc, target_len // lc.shape[1], dim=1)
    return lc


def vqvae_encode(params, state, cfg, x: torch.Tensor,
                 y: Optional[torch.Tensor]):
    """Encode the conditioning wav x [B, T, 1] once: returns the decoder's
    local condition [B, T_cond, C_lc] and the code indices (or None)."""
    z_e = enc.encoder_forward(cfg.encoder, params["encoder"],
                              state["encoder"], x, norm=cfg.encoder_norm)
    if cfg.use_vq:
        q = vq_mod.quantize(params["vq"], z_e, mode=cfg.vq_mode)
        z_q, codes = q["z_q"], q["q_z_x"]
    else:
        z_q, codes = z_e, None
    lc = build_local_condition(params, cfg, z_q, y, target_len=x.shape[1])
    return lc, codes
