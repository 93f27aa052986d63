"""WaveNet decoder, teacher-forced training forward (port of
vqvae_wavenet_tpu/models/wavenet.py:84-314).

preprocess causal conv (on the mu-law of the right-shifted input) ->
skip-start 1x1 -> the L-layer residual stack (``fused_residual_stack``:
the CUDA kernels on the card) -> relu -> 1x1 (+ per-frame condition) ->
relu -> 1x1 logits; loss = mean sparse softmax CE over B*T.

Under tensor parallelism (``sh.n_model`` > 1, parallel/mesh.py) the decoder
holds this rank's columns of ``layers/skip_kernel`` and rows of
``postprocess1/kernel``: skip_start makes the rank's S columns, the stack
kernel runs on them (ops/train_kernels.py), and the heads compute
postprocess1 row-parallel, relu(skip_local) @ pp1_rows summed over the
model row, before the bias, the conditions, relu and postprocess2, which
every rank of the row repeats.  With ``return_skip`` (the bf16 loss head)
the skip sum comes back whole, joined inside the stack.

The compute type follows the input: float32, or bfloat16 under
``train_dtype='bf16'`` (the caller casts the decoder parameters and the
input), with float32 sums and an f32 skip path and logits.  The stack
rounds where its kernel does (ops/train_kernels.py); the heads here are
plain torch, as the JAX package leaves them to XLA.

``make_standalone_trainer`` trains the WaveNet alone (the reference's
Wavenet.get_loss path, wavenet.py:175-198; JAX wavenet.py:317-352): Adam
in f32 over the six-point schedule, the stack kernels on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vqvae_wavenet_torch.ops.conv import (add_condition, causal_conv1d,
                                          shift_right)
from vqvae_wavenet_torch.ops.mu_law import mu_law_encode
from vqvae_wavenet_torch.ops.train_kernels import fused_residual_stack
from vqvae_wavenet_torch.parallel.comm import (copy_model, model_slice,
                                              reduce_model)


def split_decoder(params, sh) -> bool:
    """The decoder holds this rank's skip columns (tensor parallelism)."""
    lp = params["layers"]
    return (sh is not None and sh.n_model > 1
            and lp["skip_kernel"].shape[-1] != lp["skip_bias"].shape[-1])


def wavenet_logits(params, cfg, inputs: torch.Tensor,
                   local_condition: Optional[torch.Tensor] = None,
                   global_condition: Optional[torch.Tensor] = None, *,
                   gate_order: str = "tanh_first",
                   return_skip: bool = False, sh=None) -> torch.Tensor:
    """Teacher-forced logits [B, T, Q] f32 for the waveform inputs
    [B, T, 1] (in the compute type), or with ``return_skip`` the pre-relu
    skip sum [B, T, S] f32 that ``fused_epilogue`` consumes.  ``sh``: a
    tensor-parallel rank's place (module docstring)."""
    cd = inputs.dtype
    net = mu_law_encode(shift_right(inputs), cfg.quantization_channels).to(cd)
    net = causal_conv1d(net, params["preprocess"]["kernel"],
                        params["preprocess"]["bias"])
    tp = sh if split_decoder(params, sh) else None
    ss_in, ss_k, ss_b = (net, params["skip_start"]["kernel"][0],
                         params["skip_start"]["bias"])
    if tp is not None and not return_skip:      # the rank's S columns
        ss_in = copy_model(net, tp)
        ss_k, ss_b = model_slice(ss_k, 1, tp), model_slice(ss_b, 0, tp)
    skip = ss_in.float() @ ss_k.float() + ss_b.float()
    lp = params["layers"]
    gc = global_condition if "gc_kernel" in lp else None
    skip = skip + fused_residual_stack(lp, cfg, net, local_condition, gc,
                                       gate_order=gate_order, sh=tp,
                                       whole=return_skip)
    if return_skip:
        return skip
    return wavenet_heads(params, skip, local_condition, global_condition, cd,
                         sh=tp)


def wavenet_heads(params, skip: torch.Tensor,
                  local_condition: Optional[torch.Tensor],
                  global_condition: Optional[torch.Tensor],
                  cd: torch.dtype, sh=None) -> torch.Tensor:
    """relu -> 1x1 (+ conditions) -> relu -> 1x1: the logits [B, T, Q] f32
    from the skip sum [B, T, S] f32, activations rounded to the compute
    type ``cd`` (wavenet.py:286-301; timeshard.py:490-509 runs the same
    tail on a time shard).  With ``sh`` the skip sum and postprocess1's
    rows are this rank's, and the product is summed over the model row."""
    pp1, pp2 = params["postprocess1"], params["postprocess2"]
    net = torch.relu(skip).to(cd).float() @ pp1["kernel"][0].float()
    if sh is not None:
        net = reduce_model(net, sh)
    net = net + pp1["bias"].float()
    if "lc_kernel" in pp1 and local_condition is not None:
        net = add_condition(net, local_condition, pp1["lc_kernel"])
    if "gc_kernel" in pp1 and global_condition is not None:
        net = add_condition(net, global_condition, pp1["gc_kernel"])
        if "gc_bias" in pp1:
            net = net + pp1["gc_bias"].float()
    net = torch.relu(net).to(cd).float()
    return net @ pp2["kernel"][0].float() + pp2["bias"].float()


def wavenet_forward(params, cfg, inputs: torch.Tensor,
                    local_condition: Optional[torch.Tensor] = None,
                    global_condition: Optional[torch.Tensor] = None, *,
                    gate_order: str = "tanh_first", sh=None):
    """(logits [B*T, Q], labels [B*T] int64): the mu-law bins of the
    inputs are the targets (wavenet.py:84-105)."""
    labels = mu_law_encode(inputs, cfg.quantization_channels,
                           to_int=True).reshape(-1)
    logits = wavenet_logits(params, cfg, inputs, local_condition,
                            global_condition, gate_order=gate_order, sh=sh)
    return logits.reshape(-1, cfg.quantization_channels), labels


def wavenet_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sparse softmax CE over the flattened B*T (wavenet.py:310-314)."""
    return F.cross_entropy(logits.float(), labels.long())


def make_standalone_trainer(cfg, lc_channels: Optional[int] = None,
                            gc_channels: Optional[int] = None,
                            schedule: Optional[dict] = None):
    """The standalone WaveNet trainer for WavenetConfig ``cfg``: returns
    (init_fn(generator, device=None) -> state, step_fn(state, x, lc=None,
    gc=None) -> (state, metrics)).  ``generator`` is a numpy Generator
    (or seed) for the init (``params.random_wavenet_np``); the state is
    {"params", "opt_state": {"mu", "nu", "count"}, "step"}; a step is the
    mean cross-entropy of ``wavenet_forward`` on x [B, T, 1] with the
    optional lc [B, F, C] and gc [B, T_gc, C_gc], its gradients by
    autograd and one Adam update (b1 0.9, b2 0.999, eps 1e-8) at
    ``schedule`` (default WAVENET_STANDALONE_SCHEDULE) of the step count;
    metrics {"loss", "lr", "step"}."""
    import numpy as np
    from vqvae_wavenet_torch.params import random_wavenet_np, to_torch
    from vqvae_wavenet_torch.training.optimizer import (
        WAVENET_STANDALONE_SCHEDULE, fused_adam_ema_step,
        piecewise_constant_schedule, tree_leaves, tree_unflatten)

    lr_fn = piecewise_constant_schedule(schedule or
                                        WAVENET_STANDALONE_SCHEDULE)

    def init_fn(generator, device=None):
        seed = (int(generator.integers(2 ** 31))
                if isinstance(generator, np.random.Generator)
                else int(generator))
        params = to_torch(random_wavenet_np(cfg, lc_channels, gc_channels,
                                            seed), device)
        zeros = [torch.zeros_like(t) for t in tree_leaves(params)]
        return {"params": params,
                "opt_state": {"mu": tree_unflatten(params, zeros),
                              "nu": tree_unflatten(params, [
                                  torch.zeros_like(t) for t in zeros]),
                              "count": 0},
                "step": 0}

    def step_fn(state, x, lc=None, gc=None):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(state["params"])]
        p = tree_unflatten(state["params"], leaves)
        with torch.enable_grad():
            logits, labels = wavenet_forward(p, cfg, x, lc, gc)
            loss = wavenet_loss(logits, labels)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        params, _, opt_state = fused_adam_ema_step(
            state["params"], None, state["opt_state"], list(grads), lr_fn)
        step = state["step"] + 1
        return ({"params": params, "opt_state": opt_state, "step": step},
                {"loss": loss.detach(), "lr": lr_fn(state["step"]),
                 "step": step})

    return init_fn, step_fn
