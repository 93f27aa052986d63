"""The WaveNet loss head (postprocess heads + mean sparse softmax cross
entropy): plain PyTorch forward and backward, the wrappers of the CUDA
kernel ``csrc/train_epilogue.cu`` (entry points ``train_epilogue_fwd`` and
``train_epilogue_bwd``), and the autograd Function that joins them.

Replaces vqvae_wavenet_tpu/ops/train_pallas.py::_make_epilogue (Pallas
calls at train_pallas.py:1981 and :2008, custom VJP :2086-2104).  The
per-frame condition of postprocess1 and its bias fold into ``enc2``
[F, B, S] (f32) outside the kernel, as JAX does (:2069-2081), so the
condition weights' gradients come from autograd against ``dlc2``.

Rounding points (kernel and plain version alike), compute type T:
  forward   h1 = T(relu(skip)) . W1 + enc2 (f32); a1 = T(relu(h1)) (saved);
            logits = a1 . W2 + b2 (f32); probs = T(softmax) (saved);
            loss = sum(logsumexp - logit[label]) / (B*T)
  backward  dlogits = (probs - onehot) * g / (B*T) in f32 (db2 its sums);
            T(dlogits) feeds dW2 and da1; dh1 = [a1 > 0] da1 (f32; dlc2
            its per-frame sums); T(dh1) feeds dW1 and dskip;
            dskip = T([skip > 0] (T(dh1) . W1^T)).

The kernel's forward also writes sk = T(relu(skip)), the operand its
products read through TMA, and its backward reads sk for dW1; the plain
version recomputes relu(skip) where it needs it.  Frames may have any
number of rows FR = T / F (64 for Encoder_64 and Encoder_Magenta, 320 for
Encoder_2019; 1 for an upsampled condition); the kernel joins the
per-frame sums of frames its 128-row tiles cut in a fixed order.  Any
number of classes Q that is a multiple of 8: past 256 the kernel walks
the classes in 256-column chunks, a pass of per-chunk max and sum of exp,
their join per row, and a pass writing the probabilities
(csrc/train_epilogue.cu).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.profiler import record_function

from vqvae_wavenet_torch.ops import _build

# kernel launches: one added where each wrapper launches, nowhere else
fwd_launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def epilogue_forward_plain(skip, w1, w2, b2, enc2, labels):
    """skip [B, T, S] f32, w1 [S, S] and w2 [S, Q] in the compute type,
    b2 [Q] f32, enc2 [F, B, S] f32, labels [B, T] int.  Returns (summed
    NLL f32 scalar, a1 [B, T, S], probs [B, T, Q]) in the compute type."""
    cd = w1.dtype
    B, T, S = skip.shape
    F = enc2.shape[0]
    sk16 = torch.relu(skip).to(cd).float()
    h1 = (sk16 @ w1.float()).reshape(B, F, T // F, S) \
        + enc2.permute(1, 0, 2)[:, :, None, :]
    a1 = torch.relu(h1.reshape(B, T, S)).to(cd)
    logits = a1.float() @ w2.float() + b2.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    probs = torch.softmax(logits, dim=-1).to(cd)
    return (lse - picked).sum(), a1, probs


def epilogue_backward_plain(g, skip, a1, probs, labels, w1, w2,
                            frames: int):
    """Backward of ``epilogue_forward_plain``'s loss sum / (B*T) for its
    cotangent g.  Returns (dskip [B, T, S] in the compute type, and float32
    dlc2 [F, B, S], dw1 [S, S], dw2 [S, Q], db2 [Q])."""
    cd = w1.dtype
    B, T, S = skip.shape
    Q = w2.shape[1]
    n = B * T
    onehot = torch.nn.functional.one_hot(labels.long(), Q).float()
    dlogits = (probs.float() - onehot) * (g.float() / n)
    db2 = dlogits.sum(dim=(0, 1))
    dl16 = dlogits.to(cd).float()
    dw2 = a1.float().reshape(n, S).T @ dl16.reshape(n, Q)
    da1 = dl16 @ w2.float().T
    dh1 = torch.where(a1.float() > 0, da1, torch.zeros_like(da1))
    dlc2 = dh1.reshape(B, frames, T // frames, S).sum(2).permute(1, 0, 2)
    dh16 = dh1.to(cd).float()
    sk16 = torch.relu(skip).to(cd).float()
    dw1 = sk16.reshape(n, S).T @ dh16.reshape(n, S)
    dsk = dh16 @ w1.float().T
    dskip = torch.where(skip > 0, dsk, torch.zeros_like(dsk)).to(cd)
    return dskip, dlc2, dw1, dw2, db2


# ----------------------------------------------------------------- kernels

def _check(cd, S, Q, *tensors):
    """Shapes first (so a width the kernel cannot take raises before any
    device check), then devices and layout.  Frames of any number of rows
    that divides T fit (the callers check T % F)."""
    if cd not in _DTYPES:
        raise TypeError(f"epilogue kernel takes float32 or bfloat16, not {cd}")
    if S % 8 or Q % 8 or not 8 <= Q:
        raise ValueError(f"epilogue kernel needs S, Q multiples of 8 "
                         f"(TMA rows of 16 bytes; got S={S}, Q={Q})")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError("the epilogue kernel needs CUDA tensors")
    for t in tensors:
        if t.device != dev:
            raise ValueError("all tensors must be on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("tensors must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("train_epilogue")
    lib.train_epilogue_fwd.restype = ctypes.c_int
    lib.train_epilogue_fwd.argtypes = ([ctypes.c_int] * 6
                                       + [ctypes.c_void_p] * 12)
    lib.train_epilogue_bwd.restype = ctypes.c_int
    lib.train_epilogue_bwd.argtypes = ([ctypes.c_int] * 6
                                       + [ctypes.c_void_p] * 17)
    # the scratch sizes, from the kernel's own row blocking
    lib.train_epilogue_fwd_part_floats.restype = ctypes.c_longlong
    lib.train_epilogue_fwd_part_floats.argtypes = [ctypes.c_int] * 3
    lib.train_epilogue_bwd_part_floats.restype = ctypes.c_longlong
    lib.train_epilogue_bwd_part_floats.argtypes = [ctypes.c_int] * 4
    return lib


def epilogue_forward_cuda(skip, w1, w2, b2, enc2, labels):
    """Launch the forward entry; ``epilogue_forward_plain``'s contract,
    and sk = T(relu(skip)) [B, T, S] in the compute type after probs (the
    backward entry's operand)."""
    global fwd_launches
    cd = w1.dtype
    B, T, S = skip.shape
    Q = w2.shape[1]
    F = enc2.shape[0]
    if w2.dtype != cd or tuple(w1.shape) != (S, S) or w2.shape[0] != S \
            or F < 1 or T % F or tuple(enc2.shape) != (F, B, S) \
            or tuple(labels.shape) != (B, T):
        raise ValueError("epilogue operands do not fit (shapes and types, "
                         "or F frames not dividing T)")
    dev = skip.device
    skip32 = skip.float().contiguous()
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    b2f = b2.float().contiguous()
    enc2 = enc2.float().contiguous()
    lab = labels.to(torch.int32).contiguous()
    _check(cd, S, Q, skip32, w1t, w2t, b2f, enc2, lab)
    a1 = torch.empty((B, T, S), dtype=cd, device=dev)
    probs = torch.empty((B, T, Q), dtype=cd, device=dev)
    sk = torch.empty((B, T, S), dtype=cd, device=dev)
    lib = _lib()
    part = torch.empty((lib.train_epilogue_fwd_part_floats(B, T, Q),),
                       dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), record_function("train_epilogue_fwd"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.train_epilogue_fwd(
            _DTYPES[cd], B, T, T // F, S, Q, skip32.data_ptr(),
            w1t.data_ptr(), w2t.data_ptr(), b2f.data_ptr(), enc2.data_ptr(),
            lab.data_ptr(), sk.data_ptr(), a1.data_ptr(), probs.data_ptr(),
            part.data_ptr(), total.data_ptr(), stream)
    _build.check(lib, err, "train_epilogue_fwd")
    fwd_launches += 1
    return total, a1, probs, sk


def epilogue_backward_cuda(g, skip, a1, probs, labels, w1, w2, frames: int,
                           sk):
    """Launch the backward entry; ``epilogue_backward_plain``'s contract,
    with the forward entry's sk last."""
    global bwd_launches
    cd = w1.dtype
    B, T, S = skip.shape
    Q = w2.shape[1]
    if frames < 1 or T % frames or a1.dtype != cd or probs.dtype != cd or sk.dtype != cd \
            or tuple(probs.shape) != (B, T, Q) \
            or tuple(sk.shape) != (B, T, S):
        raise ValueError("epilogue operands do not fit (shapes and types, "
                         "or F frames not dividing T)")
    dev = skip.device
    g32 = g.float().reshape(1).contiguous()
    skip32 = skip.float().contiguous()
    lab = labels.to(torch.int32).contiguous()
    w1c, w2c = w1.contiguous(), w2.contiguous()
    sk, a1, probs = sk.contiguous(), a1.contiguous(), probs.contiguous()
    _check(cd, S, Q, skip32, g32, lab, w1c, w2c, sk, a1, probs)
    n = B * T
    f32 = torch.float32
    dskip = torch.empty((B, T, S), dtype=cd, device=dev)
    dlc2 = torch.empty((frames, B, S), dtype=f32, device=dev)
    dw1 = torch.empty((S, S), dtype=f32, device=dev)
    dw2 = torch.empty((S, Q), dtype=f32, device=dev)
    db2 = torch.empty((Q,), dtype=f32, device=dev)
    dl = torch.empty((n, Q), dtype=cd, device=dev)
    dh16 = torch.empty((n, S), dtype=cd, device=dev)
    lib = _lib()
    part = torch.empty((lib.train_epilogue_bwd_part_floats(B, T, S, Q),),
                       dtype=f32, device=dev)
    with torch.cuda.device(dev), record_function("train_epilogue_bwd"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.train_epilogue_bwd(
            _DTYPES[cd], B, T, T // frames, S, Q, g32.data_ptr(),
            probs.data_ptr(), lab.data_ptr(), a1.data_ptr(), sk.data_ptr(),
            skip32.data_ptr(), w1c.data_ptr(), w2c.data_ptr(),
            dskip.data_ptr(), dlc2.data_ptr(), dw1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), dl.data_ptr(), dh16.data_ptr(),
            part.data_ptr(), stream)
    _build.check(lib, err, "train_epilogue_bwd")
    bwd_launches += 1
    return dskip, dlc2, dw1, dw2, db2


class _Epilogue(torch.autograd.Function):
    """Mean NLL of the heads over ``skip``: the kernel's entries for CUDA
    tensors (the forward's sk saved for the backward), their plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, w1, w2, b2, enc2, skip, labels):
        args = (skip, w1, w2, b2, enc2, labels)
        if skip.is_cuda:
            total, a1, probs, sk = epilogue_forward_cuda(*args)
        else:
            (total, a1, probs), sk = epilogue_forward_plain(*args), None
        ctx.save_for_backward(w1, w2, skip, a1, probs, labels, sk)
        ctx.frames = enc2.shape[0]
        return total / (skip.shape[0] * skip.shape[1])

    @staticmethod
    def backward(ctx, g):
        w1, w2, skip, a1, probs, labels, sk = ctx.saved_tensors
        args = (g, skip, a1, probs, labels, w1, w2, ctx.frames)
        dskip, dlc2, dw1, dw2, db2 = (
            epilogue_backward_cuda(*args, sk) if skip.is_cuda
            else epilogue_backward_plain(*args))
        return (dw1.to(w1.dtype), dw2.to(w2.dtype), db2, dlc2,
                dskip.float(), None)


def fused_epilogue(pp1, pp2, skip: torch.Tensor,
                   local_condition: torch.Tensor,
                   global_condition: Optional[torch.Tensor],
                   labels: torch.Tensor) -> torch.Tensor:
    """Mean sparse-softmax CE of the postprocess heads over the pre-relu
    skip sum ``skip`` [B, T, S] f32 (train_pallas.py:2042-2109).  pp1 /
    pp2: kernel [1, S, S] / [1, S, Q], bias, lc_kernel (and optional
    gc_kernel / gc_bias) in the compute type; local_condition [B, F, C];
    global_condition [B, 1, C_gc] or None; labels [B, T] mu-law bins."""
    cd = pp1["kernel"].dtype
    Q = pp2["kernel"].shape[2]
    enc2 = (torch.einsum("bfc,cs->fbs", local_condition.float(),
                         pp1["lc_kernel"].float())
            + pp1["bias"].float()[None, None, :])
    if global_condition is not None and "gc_kernel" in pp1:
        enc2 = enc2 + (global_condition[:, 0].float()
                       @ pp1["gc_kernel"].float())[None]
        if "gc_bias" in pp1:
            enc2 = enc2 + pp1["gc_bias"].float()
    return _Epilogue.apply(pp1["kernel"][0].to(cd), pp2["kernel"][0].to(cd),
                           pp2["bias"].float().reshape(Q),
                           enc2.contiguous(), skip, labels)
