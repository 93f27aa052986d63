"""VQ nearest-code search: the CUDA kernel's wrapper and its plain twin.

``vq_nearest`` replaces vqvae_wavenet_tpu/ops/vq_pallas.py::vq_nearest
(Pallas kernel ``_vq_argmin_kernel`` :32 on TPU, jnp fallback elsewhere).
On a CUDA tensor it launches ``csrc/vq_argmin.cu``; on a CPU tensor it runs
``vq_nearest_plain``.  Forward only: gradients flow through the lookup.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.profiler import record_function

from vqvae_wavenet_torch.ops import _build

MAX_DIM = 256

# kernel launches: one added where vq_nearest_cuda launches, nowhere else
launches = 0


def vq_nearest_plain(z_flat: torch.Tensor,
                     embedding: torch.Tensor) -> torch.Tensor:
    """argmin_k ||e_k||^2 - 2 z.e_k in float32 -> int64 [N] (the same math
    as the jnp fallback, vq_pallas.py:89-93)."""
    z = z_flat.float()
    e = embedding.float()
    dist = torch.sum(e * e, dim=-1) - 2.0 * (z @ e.T)
    return torch.argmin(dist, dim=-1)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("vq_argmin")
    lib.vq_argmin.restype = ctypes.c_int
    lib.vq_argmin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p]
    return lib


def _aligned(t: torch.Tensor, d4: int) -> torch.Tensor:
    """t [rows, d] as the kernel reads it: d zero-padded to d4 (a multiple
    of 4: the rows of its TMA maps are whole 16-byte pieces; zeros change
    no dot product or norm) and 16-byte aligned.  Returns t itself at the
    shipped widths."""
    if t.shape[1] != d4:
        t = torch.nn.functional.pad(t, (0, d4 - t.shape[1]))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def vq_nearest_cuda(z_flat: torch.Tensor,
                    embedding: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; z_flat [N, d] and embedding [k, d] float32 CUDA
    tensors on one device, contiguous, d <= 256.  Returns int64 [N],
    written by the kernel itself."""
    global launches
    if not (z_flat.is_cuda and embedding.is_cuda
            and z_flat.device == embedding.device):
        raise ValueError("vq_nearest_cuda needs both tensors on one CUDA device")
    if z_flat.dtype != torch.float32 or embedding.dtype != torch.float32:
        raise TypeError("vq_nearest_cuda takes float32 z and codebook")
    if z_flat.dim() != 2 or embedding.dim() != 2 \
            or z_flat.shape[1] != embedding.shape[1]:
        raise ValueError(f"shapes {tuple(z_flat.shape)} vs "
                         f"{tuple(embedding.shape)}: want [N, d] and [k, d]")
    n, d = z_flat.shape
    k = embedding.shape[0]
    if not 1 <= d <= MAX_DIM or k < 1:
        raise ValueError(f"vq kernel takes 1 <= d <= {MAX_DIM}, k >= 1 "
                         f"(got d={d}, k={k})")
    if not (z_flat.is_contiguous() and embedding.is_contiguous()):
        raise ValueError("vq_nearest_cuda needs contiguous tensors")
    out = torch.empty((n,), dtype=torch.int64, device=z_flat.device)
    if n == 0:
        return out
    d4 = -(-d // 4) * 4
    z_flat, embedding = _aligned(z_flat, d4), _aligned(embedding, d4)
    lib = _lib()
    with torch.cuda.device(z_flat.device), record_function("vq_argmin"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vq_argmin(z_flat.data_ptr(), embedding.data_ptr(), n, k, d4,
                            out.data_ptr(), stream)
    _build.check(lib, err, "vq_argmin")
    launches += 1
    return out


def vq_nearest(z_flat: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Nearest code per row: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if z_flat.is_cuda:
        return vq_nearest_cuda(z_flat.detach().float().contiguous(),
                               embedding.detach().float().contiguous())
    return vq_nearest_plain(z_flat.detach(), embedding.detach())
