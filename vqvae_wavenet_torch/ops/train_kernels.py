"""The WaveNet training residual stack: plain PyTorch forward and backward,
the wrappers of the CUDA kernels ``csrc/train_stack_fwd.cu``,
``csrc/train_stack_bwd.cu`` and ``csrc/train_stack_bwd2.cu``, and the
autograd Function that joins them.

The forward kernel replaces
vqvae_wavenet_tpu/ops/train_pallas.py::_make_fused_stack (Pallas call at
train_pallas.py:1502); the backward kernel replaces
``_make_bwd_sweep_kernel`` (call at :1100, driven from the custom VJP's
``fused_bwd`` :1560-1610).  Under ``BWD_FUSED_DK = "off"`` the backward
is instead the two-kernel form (:1612-1663): the chain kernel
(``_make_bwd_kernel``, call at :470) writes every layer's dpre and the
other gradients, then one dW launch (``_make_dk_kernel``, call at :638)
computes dk for every layer and tap; counters ``chain_launches`` and
``dk_launches``.  Both backwards compute one function with the same
rounding points.  ``fused_residual_stack`` keeps the JAX
signature and folds the per-layer condition and conv bias into
``lc_encb`` [L, F, B, 2D] (f32) outside the kernels, as JAX does
(:1820-1835), so the condition weights' gradients come from autograd
against the kernel's ``dlc``.

Two paths run these kernels: single-device training (the whole stack in
one call) and sequence-parallel training (parallel/timeshard.py, one call
per dilation cycle on a halo-extended time shard).  The second uses the
variants of the TPU kernels' ``with_start``/``with_xout``/``layer_range``
options (train_pallas.py:1198, :739, :1561-1593):
  start      rows t < start of every batch row lie outside the computation:
             the first kept row sees zero history (the causal pad), act,
             skip and xs[l >= 1] rows before start are zeros, and the
             backward gives zero dx0 there and leaves those rows out of
             every sum.  Equal to the stack on x0[:, start:] with
             lc_encb[:, start/FR:], zero-padded in front.
  with_xout  the forward also returns layer L-1's residual output
             xout = T((x + res) + res_b); the backward's f32 dX starts
             from T(dxout) instead of zeros.
  layer_range  ``fused_residual_stack`` slices the layer parameters and
             the dilations.
Calls with start > 0 or with_xout count in ``fwd_sp_launches`` /
``bwd_sp_launches``, the others in ``fwd_launches`` / ``bwd_launches``.

Under tensor parallelism (``sh``: parallel/mesh.py's model axis) skipw is
the rank's S/n_model columns of ``layers/skip_kernel``.  The forward kernel
runs on them (a skip column depends on its own skipw column alone, so the
rank's skip sum is exact), and with ``whole`` the skip sum is joined over
the model row inside the Function.  The backward kernel forms dg from
[dX | dskip] . [resw^T ; skipw^T] in one sum and walks every layer in one
launch, so a rank's partial sum could not be reduced between layers: it
runs on the whole dskip (joined over the row unless it arrived whole) and
the whole skipw, and keeps its columns of dsk.  Every other gradient then
comes out whole, the same on every rank of the row.

Rounding points (kernel and plain version alike), in the compute type T
(bfloat16 or float32) with float32 sums:
  forward   pre = conv + lc_encb (f32); f, g = gate(pre) each rounded to T
            (act); gated = T(f*g); skip sum in f32, rounded to T after
            the last layer; x_{l+1} = T((x_l + res) + res_b);
  backward  dX (gradient of a layer's output) in f32, dX16 = T(dX) feeds
            the products; dg = T([dX16 | dskip] . [resw^T ; skipw^T]);
            the gate derivative in T, factored as the TPU kernel does
            (train_pallas.py:876-893); dlc, drb, dk, dsk, drs summed in f32.

On a CUDA tensor the dispatchers launch the kernel or raise; on a CPU
tensor they run the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from vqvae_wavenet_torch.ops import _build
from vqvae_wavenet_torch.parallel.comm import (all_gather_, model_slice,
                                              own_slice)

# kernel launches: one added where each wrapper launches, nowhere else;
# the sequence-parallel variants (start > 0 or the stream output) apart
fwd_launches = 0
bwd_launches = 0
fwd_sp_launches = 0
bwd_sp_launches = 0
chain_launches = 0
dk_launches = 0

# the backward of a single-device stack call, read at call time (JAX's
# train_pallas._BWD_FUSED_DK, read at trace time): "auto" takes the layer
# sweep (train_stack_bwd.cu), "off" the two-kernel form
# (train_stack_bwd2.cu: the chain, then dk for every layer in one launch).
# Calls with start > 0 or a dxout take the sweep either way.  The sweep
# holds one layer's dpre, the two-kernel form every layer's
# ([L, B, T, 2D] in the compute type).
BWD_FUSED_DK = "auto"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _gate(pre: torch.Tensor, D: int, cd: torch.dtype, gate_order: str):
    a, b = pre[..., :D], pre[..., D:]
    if gate_order == "tanh_first":
        return torch.tanh(a).to(cd), torch.sigmoid(b).to(cd)
    return torch.sigmoid(a).to(cd), torch.tanh(b).to(cd)


def _zero_head(t: torch.Tensor, start: int) -> torch.Tensor:
    """t [B, T, ...] with rows t < start set to zero (a new tensor)."""
    if start == 0:
        return t
    out = t.clone()
    out[:, :start] = 0
    return out


def stack_forward_plain(kernel, skipw, resw, res_b, lc_encb, x0,
                        dils: Sequence[int], gate_order: str = "tanh_first",
                        *, start: int = 0, with_xout: bool = False):
    """Plain forward.  kernel [L, K, R, 2D], skipw [L, D, S], resw [L, D, R]
    and x0 [B, T, R] in the compute type; res_b [L, R]; lc_encb
    [L, F, B, 2D] f32.  Returns (skip_sum [B, T, S], act [L, B, T, 2D],
    xs [L, B, T, R]) in the compute type; xs[l] is layer l's input
    (xs[0] = x0 as given).  With ``start`` the rows before it are left out
    (module docstring); with ``with_xout`` the tuple ends with xout
    [B, T, R], layer L-1's residual output."""
    L, K, R, D2 = kernel.shape
    D, S = D2 // 2, skipw.shape[2]
    B, T, _ = x0.shape
    F = lc_encb.shape[1]
    cd, f32 = x0.dtype, torch.float32
    xs = torch.empty((L, B, T, R), dtype=cd, device=x0.device)
    act = torch.empty((L, B, T, D2), dtype=cd, device=x0.device)
    xs[0] = x0
    skip = xout = None
    for l, d in enumerate(dils):
        x = _zero_head(xs[l].float(), start)
        pre = torch.zeros((B, T, D2), dtype=f32, device=x0.device)
        for j in range(K):
            o = (K - 1 - j) * d
            if o < T:
                pre[:, o:] += x[:, :T - o] @ kernel[l, j].float()
        pre = (pre.reshape(B, F, T // F, D2)
               + lc_encb[l].permute(1, 0, 2)[:, :, None, :]).reshape(B, T, D2)
        f, g = _gate(pre, D, cd, gate_order)
        act[l] = _zero_head(torch.cat([f, g], dim=-1), start)
        gated = (act[l, ..., :D] * act[l, ..., D:]).float()
        out = gated @ torch.cat([skipw[l], resw[l]], dim=1).float()
        skip = out[..., :S] if skip is None else skip + out[..., :S]
        if l < L - 1 or with_xout:
            nxt = _zero_head(((x + out[..., S:]) + res_b[l].float()).to(cd),
                             start)
            if l < L - 1:
                xs[l + 1] = nxt
            else:
                xout = nxt
    res = (skip.to(cd), act, xs)
    return res + (xout,) if with_xout else res


def _dk_layer(x, dpre, d: int, K: int):
    """[K, R, 2D] f32: sum over t of x[t - o_j]^T dpre[t], o_j = (K-1-j) d,
    rows t - o_j < 0 of each batch row reading zero; x [B, T, R] and dpre
    [B, T, 2D] float32."""
    B, T, R = x.shape
    out = torch.zeros((K, R, dpre.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for j in range(K):
        o = (K - 1 - j) * d
        if o < T:
            out[j] = (x[:, :T - o].reshape(-1, R).T
                      @ dpre[:, o:].reshape(-1, dpre.shape[-1]))
    return out


def _backward_plain(dskip, act, xs, kernel, skipw, resw, dils, frames,
                    gate_order, start, dxout, keep_dpre: bool):
    """The reverse layer walk of both backwards: with ``keep_dpre`` every
    layer's dpre is kept in dpre_all [L, B, T, 2D] (compute type) and no
    dk is computed (the chain); else dk is summed layer by layer (the
    sweep).  Returns (dk or dpre_all, dsk, drs, drb, dlc, dx0)."""
    L, K, R, D2 = kernel.shape
    D, S = D2 // 2, skipw.shape[2]
    _, B, T, _ = act.shape
    cd, f32, dev = act.dtype, torch.float32, act.device
    FR = T // frames
    dskip16 = dskip.to(cd)
    dX = (torch.zeros((B, T, R), dtype=f32, device=dev) if dxout is None
          else _zero_head(dxout.to(cd).float(), start))
    if keep_dpre:
        first = torch.empty((L, B, T, D2), dtype=cd, device=dev)
    else:
        first = torch.zeros((L, K, R, D2), dtype=f32, device=dev)
    dsk = torch.empty((L, D, S), dtype=f32, device=dev)
    drs = torch.empty((L, D, R), dtype=f32, device=dev)
    drb = torch.empty((L, R), dtype=f32, device=dev)
    dlc = torch.empty((L, frames, B, D2), dtype=f32, device=dev)
    for l in reversed(range(L)):
        d = dils[l]
        f, g = act[l, ..., :D], act[l, ..., D:]
        dX16 = dX.to(cd)
        cat = torch.cat([dX16, dskip16], dim=-1).float()
        dg = (cat @ torch.cat([resw[l], skipw[l]], dim=1).float().T).to(cd)
        if gate_order == "tanh_first":
            u = dg * g
            v = u * f
            da, db = u - v * f, v - v * g
        else:
            v = dg * g * f
            w = dg * f
            da, db = v - v * f, w - (w * g) * g
        dpre = _zero_head(torch.cat([da, db], dim=-1).float(), start)
        gated = (f * g).float().reshape(-1, D)
        dskrs = gated.T @ torch.cat([dskip16, dX16], dim=-1).reshape(
            -1, S + R).float()
        dsk[l], drs[l] = dskrs[:, :S], dskrs[:, S:]
        drb[l] = dX.sum(dim=(0, 1))
        dlc[l] = dpre.reshape(B, frames, FR, D2).sum(2).permute(1, 0, 2)
        if keep_dpre:
            first[l] = dpre          # exact: dpre holds compute-type values
        else:
            first[l] = _dk_layer(_zero_head(xs[l].float(), start), dpre, d,
                                 K)
        acc = torch.zeros_like(dX)
        for j in range(K):
            o = (K - 1 - j) * d
            if o < T:
                acc[:, :T - o] += dpre[:, o:] @ kernel[l, j].float().T
        dX = dX + _zero_head(acc, start)
    return first, dsk, drs, drb, dlc, dX.to(cd)


def stack_backward_plain(dskip, act, xs, kernel, skipw, resw,
                         dils: Sequence[int], frames: int,
                         gate_order: str = "tanh_first", *, start: int = 0,
                         dxout: Optional[torch.Tensor] = None):
    """Plain backward of ``stack_forward_plain`` for the cotangent dskip
    [B, T, S] of skip_sum (and dxout [B, T, R] of xout, which seeds dX),
    with ``frames`` = F condition frames.  Returns float32 (dk
    [L, K, R, 2D], dsk [L, D, S], drs [L, D, R], drb [L, R], dlc
    [L, F, B, 2D]) and dx0 [B, T, R] in the compute type."""
    return _backward_plain(dskip, act, xs, kernel, skipw, resw, dils,
                           frames, gate_order, start, dxout, keep_dpre=False)


def stack_bwd_chain_plain(dskip, act, xs, kernel, skipw, resw,
                          dils: Sequence[int], frames: int,
                          gate_order: str = "tanh_first"):
    """Plain chain of the two-kernel backward (JAX's ``bwd_call``,
    train_pallas.py:193-196, with dsk in the body): the walk of
    ``stack_backward_plain`` without dk.  Returns (dpre_all [L, B, T, 2D]
    in the compute type, float32 dsk [L, D, S], drs [L, D, R], drb [L, R],
    dlc [L, F, B, 2D], dx0 [B, T, R] in the compute type)."""
    return _backward_plain(dskip, act, xs, kernel, skipw, resw, dils,
                           frames, gate_order, 0, None, keep_dpre=True)


def stack_dk_plain(dpre_all, xs, dils: Sequence[int], K: int):
    """Plain dW pass of the two-kernel backward: dk [L, K, R, 2D] f32 with
    dk[l, j] = sum_t xs[l][t - o_j]^T dpre_all[l][t], o_j = (K-1-j) d_l,
    zero where t - o_j < 0 within a batch row (train_pallas.py:493-508)."""
    return torch.stack([_dk_layer(xs[l].float(), dpre_all[l].float(), d, K)
                        for l, d in enumerate(dils)])


# ----------------------------------------------------------------- kernels

def _check_widths(**widths):
    odd = {k: v for k, v in widths.items() if v % 8 or v < 8}
    if odd:
        raise ValueError(f"training kernels need widths that are multiples "
                         f"of 8, got {odd}")


def _check_cuda(cd, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError("the training kernels need CUDA tensors")
    if cd not in _DTYPES:
        raise TypeError(f"training kernels take float32 or bfloat16, not {cd}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("all tensors must be on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("tensors must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _fwd_lib():
    lib = _build.load("train_stack_fwd")
    lib.train_stack_fwd.restype = ctypes.c_int
    lib.train_stack_fwd.argtypes = (
        [ctypes.c_int] * 10 + [ctypes.c_void_p] * 11 + [ctypes.c_int,
                                                         ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load("train_stack_bwd")
    lib.train_stack_bwd.restype = ctypes.c_int
    lib.train_stack_bwd.argtypes = (
        [ctypes.c_int] * 10 + [ctypes.c_void_p] * 15 + [ctypes.c_int,
                                                         ctypes.c_void_p])
    # the scratch size, from the kernel's own row blocking
    lib.train_stack_bwd_part_floats.restype = ctypes.c_longlong
    lib.train_stack_bwd_part_floats.argtypes = [ctypes.c_int] * 6
    return lib


@functools.lru_cache(maxsize=None)
def _bwd2_lib():
    lib = _build.load("train_stack_bwd2")
    lib.train_stack_bwd_chain.restype = ctypes.c_int
    lib.train_stack_bwd_chain.argtypes = (
        [ctypes.c_int] * 9 + [ctypes.c_void_p] * 12 + [ctypes.c_int,
                                                        ctypes.c_void_p])
    lib.train_stack_bwd_dk.restype = ctypes.c_int
    lib.train_stack_bwd_dk.argtypes = ([ctypes.c_int] * 7
                                       + [ctypes.c_void_p] * 6)
    # the scratch sizes, from the kernels' own row blocking
    lib.train_stack_bwd_chain_part_floats.restype = ctypes.c_longlong
    lib.train_stack_bwd_chain_part_floats.argtypes = [ctypes.c_int] * 5
    lib.train_stack_bwd_dk_part_floats.restype = ctypes.c_longlong
    lib.train_stack_bwd_dk_part_floats.argtypes = [ctypes.c_int] * 6
    return lib


def _dims(kernel, skipw, x0, lc_encb):
    L, K, R, D2 = kernel.shape
    B, T, _ = x0.shape
    F = lc_encb.shape[1]
    if T % F or tuple(lc_encb.shape) != (L, F, B, D2):
        raise ValueError(f"lc_encb {tuple(lc_encb.shape)} does not fit "
                         f"L={L}, B={B}, T={T}, 2D={D2}")
    return L, K, R, D2 // 2, skipw.shape[2], B, T, F


def _check_start(start: int, T: int) -> int:
    if not 0 <= int(start) <= T:
        raise ValueError(f"start {start} outside [0, T={T}]")
    return int(start)


def stack_forward_cuda(kernel, skipw, resw, res_b, lc_encb, x0,
                       dils: Sequence[int], gate_order: str = "tanh_first",
                       *, start: int = 0, with_xout: bool = False):
    """Launch the forward kernel; same contract as ``stack_forward_plain``."""
    global fwd_launches, fwd_sp_launches
    cd = x0.dtype
    L, K, R, D, S, B, T, F = _dims(kernel, skipw, x0, lc_encb)
    if len(dils) != L or gate_order not in ("tanh_first", "sigmoid_first"):
        raise ValueError("dilations or gate order do not fit the stack")
    _check_widths(R=R, D=D, S=S)
    start = _check_start(start, T)
    dev = x0.device
    # conv columns interleaved (2c = tanh half, 2c+1 = sigmoid half of
    # channel c) and transposed to [L, 2D, K*R]; [skipw | resw]^T [L, S+R, D]
    wconv_t = (kernel.reshape(L, K * R, 2, D).transpose(2, 3)
               .reshape(L, K * R, 2 * D).transpose(1, 2).contiguous())
    srw_t = torch.cat([skipw, resw], dim=2).transpose(1, 2).contiguous()
    res_b32 = res_b.float().contiguous()
    x0 = x0.contiguous()
    for t in (wconv_t, srw_t):
        if t.dtype != cd:
            raise TypeError("stack weights and x0 must share one dtype")
    if lc_encb.dtype != torch.float32:
        raise TypeError("lc_encb must be float32")
    _check_cuda(cd, wconv_t, srw_t, res_b32, lc_encb, x0)
    xs = torch.empty((L, B, T, R), dtype=cd, device=dev)
    xs[0].copy_(x0)
    act = torch.empty((L, B, T, 2 * D), dtype=cd, device=dev)
    gated = torch.empty((B * T, D), dtype=cd, device=dev)
    skipacc = torch.empty((B * T, S), dtype=torch.float32, device=dev)
    skip_out = torch.empty((B, T, S), dtype=cd, device=dev)
    xout = (torch.empty((B, T, R), dtype=cd, device=dev) if with_xout
            else None)
    dil = (ctypes.c_int * L)(*[int(d) for d in dils])
    lib = _fwd_lib()
    name = "train_stack_fwd_sp" if start or with_xout else "train_stack_fwd"
    with torch.cuda.device(dev), record_function(name):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.train_stack_fwd(
            _DTYPES[cd], L, K, R, D, S, B, T, T // F, start,
            ctypes.cast(dil, ctypes.c_void_p), wconv_t.data_ptr(),
            srw_t.data_ptr(), res_b32.data_ptr(), lc_encb.data_ptr(),
            xs.data_ptr(), act.data_ptr(), gated.data_ptr(),
            skipacc.data_ptr(), skip_out.data_ptr(),
            None if xout is None else xout.data_ptr(),
            int(gate_order == "sigmoid_first"), stream)
    _build.check(lib, err, "train_stack_fwd")
    if start or with_xout:
        fwd_sp_launches += 1
    else:
        fwd_launches += 1
    return (skip_out, act, xs) + ((xout,) if with_xout else ())


def _bwd_operands(dskip, act, xs, kernel, skipw, resw, dils, frames,
                  gate_order, seed):
    """Check the operands of a backward kernel (the sweep or the chain;
    ``seed`` the sweep's dxout, if any, already in the compute type) and
    return them as the kernels read them, rsk = [resw | skipw]
    [L, D, R+S], kernel and dskip contiguous in the compute type, with the
    outputs and scratch both write: dskrs [L, D, S+R], drb [L, R], dlc
    [L, F, B, 2D] (f32), dx16 [B, T, R] (compute type), dx [B*T, R] f32."""
    cd = act.dtype
    L, K, R, D2 = kernel.shape
    D, S = D2 // 2, skipw.shape[2]
    _, B, T, _ = act.shape
    if len(dils) != L or T % frames \
            or gate_order not in ("tanh_first", "sigmoid_first"):
        raise ValueError("dilations, frames or gate order do not fit")
    _check_widths(R=R, D=D, S=S)
    rsk = torch.cat([resw, skipw], dim=2).contiguous()        # [L, D, R+S]
    kern = kernel.contiguous()
    dskip16 = dskip.to(cd).contiguous()
    for t in (rsk, kern, xs):
        if t.dtype != cd:
            raise TypeError("stack weights and saved tensors must share one "
                            "dtype")
    if tuple(dskip16.shape) != (B, T, S) or tuple(xs.shape) != (L, B, T, R) \
            or any(tuple(t.shape) != (B, T, R) for t in seed):
        raise ValueError("dskip, dxout or xs do not fit the stack")
    _check_cuda(cd, rsk, kern, dskip16, act, xs, *seed)
    f32, dev = torch.float32, act.device
    outs = (torch.empty((L, D, S + R), dtype=f32, device=dev),
            torch.empty((L, R), dtype=f32, device=dev),
            torch.empty((L, frames, B, D2), dtype=f32, device=dev),
            torch.empty((B, T, R), dtype=cd, device=dev),
            torch.empty((B * T, R), dtype=f32, device=dev))
    return rsk, kern, dskip16, outs


def stack_backward_cuda(dskip, act, xs, kernel, skipw, resw,
                        dils: Sequence[int], frames: int,
                        gate_order: str = "tanh_first", *, start: int = 0,
                        dxout: Optional[torch.Tensor] = None):
    """Launch the backward kernel; same contract as ``stack_backward_plain``."""
    global bwd_launches, bwd_sp_launches
    cd = act.dtype
    L, K, R, D2 = kernel.shape
    D, S = D2 // 2, skipw.shape[2]
    _, B, T, _ = act.shape
    start = _check_start(start, T)
    seed = [] if dxout is None else [dxout.to(cd).contiguous()]
    rsk, kern, dskip16, (dskrs, drb, dlc, dx16, dx) = _bwd_operands(
        dskip, act, xs, kernel, skipw, resw, dils, frames, gate_order, seed)
    dev = act.device
    dk = torch.empty((L, K, R, D2), dtype=torch.float32, device=dev)
    dpre = torch.empty((B * T, D2), dtype=cd, device=dev)
    lib = _bwd_lib()
    part = torch.empty((lib.train_stack_bwd_part_floats(K, R, D, S, B, T),),
                       dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*[int(d) for d in dils])
    name = "train_stack_bwd_sp" if start or seed else "train_stack_bwd"
    with torch.cuda.device(dev), record_function(name):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.train_stack_bwd(
            _DTYPES[cd], L, K, R, D, S, B, T, T // frames, start,
            ctypes.cast(dil, ctypes.c_void_p), rsk.data_ptr(),
            kern.data_ptr(), dskip16.data_ptr(), act.data_ptr(),
            xs.data_ptr(), seed[0].data_ptr() if seed else None,
            dk.data_ptr(), dskrs.data_ptr(), drb.data_ptr(), dlc.data_ptr(),
            dx16.data_ptr(), dx.data_ptr(), dpre.data_ptr(), part.data_ptr(),
            int(gate_order == "sigmoid_first"), stream)
    _build.check(lib, err, "train_stack_bwd")
    if start or seed:
        bwd_sp_launches += 1
    else:
        bwd_launches += 1
    return dk, dskrs[..., :S], dskrs[..., S:], drb, dlc, dx16


def stack_bwd_chain_cuda(dskip, act, xs, kernel, skipw, resw,
                         dils: Sequence[int], frames: int,
                         gate_order: str = "tanh_first"):
    """Launch the chain kernel of the two-kernel backward; same contract
    as ``stack_bwd_chain_plain``."""
    global chain_launches
    cd = act.dtype
    L, K, R, D2 = kernel.shape
    D, S = D2 // 2, skipw.shape[2]
    _, B, T, _ = act.shape
    rsk, kern, dskip16, (dskrs, drb, dlc, dx16, dx) = _bwd_operands(
        dskip, act, xs, kernel, skipw, resw, dils, frames, gate_order, [])
    dev = act.device
    dpre_all = torch.empty((L, B, T, D2), dtype=cd, device=dev)
    lib = _bwd2_lib()
    part = torch.empty(
        (lib.train_stack_bwd_chain_part_floats(R, D, S, B, T),),
        dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*[int(d) for d in dils])
    with torch.cuda.device(dev), record_function("train_stack_bwd_chain"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.train_stack_bwd_chain(
            _DTYPES[cd], L, K, R, D, S, B, T, T // frames,
            ctypes.cast(dil, ctypes.c_void_p), rsk.data_ptr(),
            kern.data_ptr(), dskip16.data_ptr(), act.data_ptr(),
            dskrs.data_ptr(), drb.data_ptr(), dlc.data_ptr(),
            dx16.data_ptr(), dx.data_ptr(), dpre_all.data_ptr(),
            part.data_ptr(), int(gate_order == "sigmoid_first"), stream)
    _build.check(lib, err, "train_stack_bwd_chain")
    chain_launches += 1
    return dpre_all, dskrs[..., :S], dskrs[..., S:], drb, dlc, dx16


def stack_dk_cuda(dpre_all, xs, dils: Sequence[int], K: int):
    """Launch the dW kernel of the two-kernel backward (one launch for
    every layer and tap); same contract as ``stack_dk_plain``."""
    global dk_launches
    cd = dpre_all.dtype
    L, B, T, D2 = dpre_all.shape
    R = xs.shape[-1]
    if len(dils) != L or tuple(xs.shape) != (L, B, T, R):
        raise ValueError("dilations or xs do not fit dpre_all")
    if xs.dtype != cd:
        raise TypeError("dpre_all and xs must share one dtype")
    _check_widths(R=R, D=D2 // 2)
    dev = dpre_all.device
    dil = torch.tensor([int(d) for d in dils], dtype=torch.int32,
                       device=dev)
    _check_cuda(cd, dpre_all, xs, dil)
    dk = torch.empty((L, K, R, D2), dtype=torch.float32, device=dev)
    lib = _bwd2_lib()
    part = torch.empty(
        (lib.train_stack_bwd_dk_part_floats(L, K, R, D2 // 2, B, T),),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), record_function("train_stack_bwd_dk"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.train_stack_bwd_dk(
            _DTYPES[cd], L, K, R, D2 // 2, B, T, dil.data_ptr(),
            dpre_all.data_ptr(), xs.data_ptr(), dk.data_ptr(),
            part.data_ptr(), stream)
    _build.check(lib, err, "train_stack_bwd_dk")
    dk_launches += 1
    return dk


def stack_forward(*args, **kw):
    """The forward kernel for CUDA tensors, the plain version for CPU."""
    x0 = args[5]
    return (stack_forward_cuda if x0.is_cuda else stack_forward_plain)(
        *args, **kw)


def stack_backward(*args, **kw):
    """The backward kernel for CUDA tensors, the plain version for CPU."""
    act = args[1]
    return (stack_backward_cuda if act.is_cuda else stack_backward_plain)(
        *args, **kw)


def stack_bwd_chain(*args, **kw):
    """The chain kernel for CUDA tensors, the plain version for CPU."""
    act = args[1]
    return (stack_bwd_chain_cuda if act.is_cuda else stack_bwd_chain_plain)(
        *args, **kw)


def stack_dk(*args, **kw):
    """The dW kernel for CUDA tensors, the plain version for CPU."""
    dpre_all = args[0]
    return (stack_dk_cuda if dpre_all.is_cuda else stack_dk_plain)(*args,
                                                                    **kw)


class _Stack(torch.autograd.Function):
    """skip_sum (, xout) = stack(kernel, skipw, resw, res_b, lc_encb, x0);
    the backward is the backward kernel (or its plain version on the CPU).
    Only the kernel's own saved tensors (act, xs) are kept.  ``tp`` (a
    tensor-parallel rank's Shards, or None) and ``whole``: the module
    docstring."""

    @staticmethod
    def forward(ctx, kernel, skipw, resw, res_b, lc_encb, x0, dils,
                gate_order, start, with_xout, tp=None, whole=False):
        out = stack_forward(kernel, skipw, resw, res_b, lc_encb, x0, dils,
                            gate_order, start=start, with_xout=with_xout)
        act, xs = out[1], out[2]
        ctx.save_for_backward(kernel, skipw, resw, act, xs)
        ctx.dils, ctx.gate_order = dils, gate_order
        ctx.start, ctx.with_xout = start, with_xout
        ctx.frames, ctx.res_b_dtype = lc_encb.shape[1], res_b.dtype
        ctx.tp, ctx.whole = tp, whole
        skip = out[0]
        if tp is not None and whole:
            skip = all_gather_(skip, tp, -1, tp.model_group)
        return (skip, out[3]) if with_xout else skip

    @staticmethod
    def backward(ctx, dskip, dxout=None):
        kernel, skipw, resw, act, xs = ctx.saved_tensors
        tp = ctx.tp
        if tp is not None:          # the whole dskip and skipw
            if not ctx.whole:
                dskip = all_gather_(dskip, tp, -1, tp.model_group)
            skipw = all_gather_(skipw, tp, -1, tp.model_group)
        if BWD_FUSED_DK not in ("auto", "off"):
            raise ValueError(f"BWD_FUSED_DK {BWD_FUSED_DK!r}: want 'auto' "
                             f"or 'off'")
        if BWD_FUSED_DK == "auto" or ctx.start or ctx.with_xout:
            # the layer sweep; the sequence-parallel variants always take
            # it, as in JAX (train_pallas.py:1561-1566)
            dk, dsk, drs, drb, dlc, dx0 = stack_backward(
                dskip, act, xs, kernel, skipw, resw, ctx.dils, ctx.frames,
                ctx.gate_order, start=ctx.start,
                dxout=dxout if ctx.with_xout else None)
        else:
            dpre_all, dsk, drs, drb, dlc, dx0 = stack_bwd_chain(
                dskip, act, xs, kernel, skipw, resw, ctx.dils, ctx.frames,
                ctx.gate_order)
            dk = stack_dk(dpre_all, xs, ctx.dils, kernel.shape[1])
            del dpre_all
        if tp is not None:          # this rank's columns
            dsk = own_slice(dsk, -1, tp).contiguous()
        return (dk.to(kernel.dtype), dsk.to(skipw.dtype), drs.to(resw.dtype),
                drb.to(ctx.res_b_dtype), dlc, dx0, None, None, None, None,
                None, None)


def fused_residual_stack(lp, cfg, x0: torch.Tensor,
                         local_condition: Optional[torch.Tensor],
                         global_condition: Optional[torch.Tensor] = None, *,
                         gate_order: str = "tanh_first",
                         start_rows: int = 0,
                         layer_range: Optional[Tuple[int, int]] = None,
                         with_xout: bool = False, sh=None,
                         whole: bool = False):
    """The residual stack over x0 [B, T, R] (the preprocess output, in the
    compute type) with the stacked layer parameters ``lp`` (JAX layouts:
    kernel [L, K, R, 2D], bias [L, 2D], lc_kernel [L, C, 2D], skip_kernel
    [L, D, S], skip_bias [L, S], res_kernel [L, D, R], res_bias [L, R],
    optional gc_kernel/gc_bias).  local_condition [B, F, C] or None;
    global_condition [B, 1 or F, C_gc] or None.  Returns the skip sum [B, T, S]
    float32 including the summed skip biases (train_pallas.py:1782-1850),
    or (skip sum, xout [B, T, R]) with ``with_xout``.  ``start_rows`` (a
    per-shard int) and ``layer_range`` (lo, hi) select the
    sequence-parallel variants of the module docstring.  ``sh``: a
    tensor-parallel rank's place, skip_kernel holding its S/n_model
    columns; the skip sum is then the rank's columns, or with ``whole``
    all S of them (module docstring)."""
    B, T, _ = x0.shape
    lo, hi = layer_range if layer_range is not None else (
        0, lp["bias"].shape[0])
    if layer_range is not None:
        lp = {k: v[lo:hi] for k, v in lp.items()}
    L, D2 = lp["bias"].shape
    if local_condition is not None and "lc_kernel" in lp:
        lc_encb = torch.einsum("bsc,lcf->lsbf", local_condition.float(),
                               lp["lc_kernel"].float())
    else:
        lc_encb = torch.zeros((L, 1, B, D2), dtype=torch.float32,
                              device=x0.device)
    lc_encb = lc_encb + lp["bias"].float()[:, None, None, :]
    if global_condition is not None and "gc_kernel" in lp:
        # [B, T_gc, C_gc]: T_gc = 1 adds to every frame; a condition that
        # varies in time adds per frame, on the local condition's frames
        # (or alone, T_gc frames), as JAX broadcasts it (wavenet.py:187-190)
        genc = torch.einsum("bsc,lcf->lsbf", global_condition.float(),
                            lp["gc_kernel"].float())
        if lc_encb.shape[1] not in (1, genc.shape[1]) \
                and genc.shape[1] != 1:
            raise ValueError(f"a global condition of {genc.shape[1]} frames "
                             f"does not fit {lc_encb.shape[1]} local frames")
        lc_encb = lc_encb + genc
        if "gc_bias" in lp:
            lc_encb = lc_encb + lp["gc_bias"].float()[:, None, None, :]
    out = _Stack.apply(
        lp["kernel"], lp["skip_kernel"], lp["res_kernel"], lp["res_bias"],
        lc_encb.contiguous(), x0,
        tuple(int(d) for d in cfg.dilation_rates[lo:hi]), gate_order,
        int(start_rows), with_xout, sh, whole)
    skip_sum, xout = out if with_xout else (out, None)
    skip_b = lp["skip_bias"]
    if sh is not None and not whole:
        skip_b = model_slice(skip_b, 1, sh)
    skip = skip_sum.float() + skip_b.float().sum(dim=0)
    return (skip, xout) if with_xout else skip
