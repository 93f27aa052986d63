"""Whole-clip autoregressive WaveNet generation (port of
vqvae_wavenet_tpu/generation/fast.py:47-306).

``generate`` packs the decoder once (float32, bfloat16 or int8 weights) and
runs the clip through ``ops.gen_kernels.generate_clip``: one persistent
CUDA launch for CUDA weights, the plain step loop (``gen_step``) for CPU
weights.  The fast-
WaveNet ring semantics are the reference's: per-layer rings start zeroed,
so taps read while t < j*d see zeros, every tap is read before the layer
writes its input, and sample i is conditioned on frame i // ratio with the
TF1 reference's floor ratio = length // T_cond (or a ratio the caller
gives from the real clip length); where i // ratio passes the last frame,
the last frame is read (ops/gen_kernels.py::condition_frames).
"""
from __future__ import annotations

from typing import Optional

import torch

from vqvae_wavenet_torch.ops.gen_kernels import (  # noqa: F401  (re-exported)
    condition_terms, gen_step, generate_clip, init_gen_state, pack_gen_params)
from vqvae_wavenet_torch.ops.mu_law import mu_law_decode


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """A 62-bit Philox key drawn from the caller's generator."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator).item())


def generate(params, cfg, local_condition: torch.Tensor, *, length: int,
             generator: Optional[torch.Generator] = None,
             mode: str = "sample", gate_order: str = "tanh_first",
             dtype: torch.dtype = torch.float32,
             global_condition: Optional[torch.Tensor] = None,
             verbose: bool = False,
             ratio: Optional[int] = None) -> torch.Tensor:
    """Generate ``length`` samples for each row of the local condition
    [B, T_cond, C_lc] from the decoder parameters ``params`` and
    WavenetConfig ``cfg``; sample i reads frame min(i // ratio, last
    frame), ratio = length // T_cond unless given.

    Weights and activations run in ``dtype`` (float32 | bfloat16) on the
    local condition's device, with float32 accumulation; ``torch.int8``
    quantizes the weights per row as the TPU kernel's int8 mode does and
    runs bf16 activations (the int8 kernel on CUDA, its plain twin on the
    CPU -- held to the quantized function everywhere, where the JAX package
    off the TPU falls back to unquantized bf16).  Sampling is always
    float32.  Returns the float waveform [B, length] in [-1, 1]."""
    if mode not in ("sample", "greedy"):
        raise NotImplementedError(f"decode mode {mode} not implemented")
    b = local_condition.shape[0]
    device = local_condition.device
    w = pack_gen_params(params, cfg, dtype, device)
    gcon, g_pp1 = condition_terms(params, w, b, global_condition)
    if verbose:
        print(f"[generate] device={device} dtype={w.dtype} length={length} "
              f"batch={b}")
    bins, _ = generate_clip(w, local_condition.to(w.dtype), gcon, g_pp1,
                            length=length, mode=mode,
                            seed=draw_seed(generator), gate_order=gate_order,
                            ratio=ratio)
    return mu_law_decode(bins, cfg.quantization_channels)


def teacher_forced_stepper(params, cfg, x: torch.Tensor,
                           local_condition: torch.Tensor,
                           gate_order: str = "tanh_first",
                           global_condition: Optional[torch.Tensor] = None,
                           ratio: Optional[int] = None) -> torch.Tensor:
    """Drive the generation step with ground-truth audio x [B, T, 1] and
    return the per-step float32 logits [B, T, Q] (fast.py:286-306)."""
    b, t_len, _ = x.shape
    w = pack_gen_params(params, cfg, torch.float32, local_condition.device)
    gcon, g_pp1 = condition_terms(params, w, b, global_condition)
    forced = torch.cat([torch.zeros((b, 1), dtype=torch.float32,
                                    device=x.device), x[:, :-1, 0].float()],
                       dim=1)
    _, logits = generate_clip(w, local_condition.to(w.dtype), gcon, g_pp1,
                              length=t_len, mode="greedy",
                              gate_order=gate_order, forced=forced,
                              want_logits=True, ratio=ratio)
    return logits
