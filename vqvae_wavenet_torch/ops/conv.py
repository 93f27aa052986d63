"""1-D convolution in the JAX package's layouts (port of
vqvae_wavenet_tpu/ops/conv.py:44-121: ``conv1d``, ``shift_right``,
``causal_conv1d`` and ``add_condition``).

Activations are ``[B, T, C]`` and kernels ``[K, C_in, C_out]`` ("WIO") at the
public interface; the transpose into torch's ``[C_out, C_in, K]`` happens
here.  This conv ran in XLA, not in a Pallas kernel, so it stays
``F.conv1d``.

TF ``SAME`` padding with a stride is asymmetric: the total pad is
``max((ceil(T/s) - 1) * s + K - T, 0)`` and the extra element goes on the
right, e.g. (1, 2) for even T, K=5, s=2.  ``F.conv1d(padding='same')``
refuses stride > 1, so the pad is explicit.

Float32 callers on CUDA must run with TF32 off (``set_full_f32``): cuDNN
computes f32 convolutions in TF32 by default.  A bfloat16 conv runs on its
values in float32 (exact products, f32 sums) and rounds the biased output
to bfloat16 once, as the TPU's bf16 convolution accumulates in f32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def set_full_f32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls, so float32
    means float32 on the card (cuDNN defaults to TF32 for f32 convs)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def same_padding(length: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1) -> Tuple[int, int]:
    """TF/XLA 'SAME' (low, high) padding for one spatial axis."""
    eff_k = (kernel_size - 1) * dilation + 1
    out = -(-length // stride)
    total = max((out - 1) * stride + eff_k - length, 0)
    return total // 2, total - total // 2


def conv1d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
           dilation: int = 1) -> torch.Tensor:
    """x: [B, T, C_in], kernel: [K, C_in, C_out] -> [B, T', C_out].
    padding: 'SAME' | 'VALID' | [(low, high)]."""
    k = kernel.shape[0]
    if padding == "SAME":
        lo, hi = same_padding(x.shape[1], k, stride, dilation)
    elif padding == "VALID":
        lo, hi = 0, 0
    else:
        (lo, hi), = padding
    xt = x.transpose(1, 2).float()                           # [B, C_in, T]
    if lo or hi:
        xt = F.pad(xt, (lo, hi))
    w = kernel.permute(2, 1, 0).float().contiguous()         # [C_out, C_in, K]
    out = F.conv1d(xt, w, None if bias is None else bias.float(),
                   stride=stride, dilation=dilation)
    return out.transpose(1, 2).to(x.dtype)


def shift_right(x: torch.Tensor) -> torch.Tensor:
    """Shift the time axis right by one, zero-filling t=0.  x: [B, T, C]."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  dilation: int = 1) -> torch.Tensor:
    """Causal dilated conv: left-pad dilation*(K-1), then VALID
    (conv1d_v2's CAUSAL path, wavenet_ops.py:81-87)."""
    k = kernel.shape[0]
    return conv1d(x, kernel, bias, padding=[(dilation * (k - 1), 0)],
                  dilation=dilation)


def add_condition(net: torch.Tensor, condition: Optional[torch.Tensor],
                  kernel: torch.Tensor) -> torch.Tensor:
    """Project ``condition`` [B, T_cond, C_cond] with a 1x1 no-bias conv
    (float32 sums) and broadcast-add it over each frame's block of samples
    of ``net`` [B, T, C] (wavenet_ops.py:93-101)."""
    if condition is None:
        return net
    b, t, c = net.shape
    t_cond = condition.shape[1]
    enc = torch.einsum("bsc,cf->bsf", condition.float(), kernel.float())
    net = net.reshape(b, t_cond, t // t_cond, c) + enc[:, :, None, :]
    return net.reshape(b, t, c)
