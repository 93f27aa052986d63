"""Whole-clip WaveNet generation: packing, the plain PyTorch step, and the
wrapper of the CUDA kernel ``csrc/gen_wavenet.cu``.

The kernel replaces vqvae_wavenet_tpu/ops/gen_pallas.py::_make_kernel in
all its modes, launched at gen_pallas.py:950: resident and hybrid (float32
and bfloat16 weights), and streamed with int8 weights.  The TPU's streamed
float mode exists because weights outgrew VMEM; this kernel reads weights
from device memory at every size, so it computes that mode's function
too.  Its packing follows the math of gen_pallas.py:104-160, 760-777
without the TPU tile padding, stored transposed so each output column's
weights are contiguous:

  w_a   [L, 2D, K*R + C]  taps (oldest first) + current + lc -> gate input
  b_a   [L, 2D]
  w_sr  [L, S + R, D]     gated -> [skip | res]
  b_sr  [L, S + R]
  w_pre [R, PK], b_pre [R]            preprocess conv over the last PK inputs
  w_ss  [S, R],  b_ss  [S]            skip start
  w_h1  [S, S + C], b_h1 [S]          postprocess1 on [relu(skip) | lc]
  w_pp2 [Q, S],  b_pp2 [Q]            postprocess2 -> logits

all in the activation dtype (float32 or bfloat16).  PK is padded to a
multiple of 8 with zero columns for the oldest window slots (Magenta's
startconv has PK = 2), which leaves the function unchanged.  The global
condition is constant over a clip and is folded into per-layer terms gcon
[L, B, 2D] and g_pp1 [B, S] before the launch (gen_pallas.py:826-843).

int8 (gen_pallas.py:104-159, 584-588): per layer, each *input row* of the
JAX streamed block -- the K*R tap rows, the C lc rows, the D skip rows, the
bias row and the skip-bias row -- is quantized across its output columns
with one scale, absmax / 127 (1.0 for a zero row), q = clip(round-half-
even(w / scale), -127, 127).  The math uses bf16(q * bf16(scale)) with
bf16 activations.  In this layout a JAX row scale becomes a per-input-
index scale: ``s_a [L, K*R + C]`` for w_a and ``s_s [L, D]`` for the skip
half, which is int8 ``w_sr [L, S, D]``; the res half stays bfloat16 in
``w_r [L, R, D]``.  The two bias rows are quantized too and stored already
dequantized in bfloat16 (b_a, and the skip half of b_sr): the same values
the kernel would compute.  Everything else stays bfloat16, as in JAX.

Rounding points (the kernel's and ``gen_step``'s alike): every product
accumulates in float32; ``current`` is cast to the activation dtype after
each residual add, ``gated`` after the gate; the skip sum stays float32;
logits are float32.

Sampling happens inside the kernel: argmax with the lowest index on ties
(greedy), or Gumbel-max with Philox-4x32-10 bits keyed on
(seed, step, batch row, bin) -- ``gumbel_noise`` computes the same bits
here, so the plain version samples identically.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch.profiler import record_function
import torch.nn.functional as F

from vqvae_wavenet_torch.ops import _build
from vqvae_wavenet_torch.ops.mu_law import mu_law_decode, mu_law_encode


# kernel launches, one added where generate_clip_cuda launches and nowhere
# else: float32 / bfloat16 weights in ``launches``, int8 in ``int8_launches``
launches = 0
int8_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@dataclass
class GenWeights:
    """Packed decoder weights in the kernel's layout (see module doc)."""
    w_a: torch.Tensor
    b_a: torch.Tensor
    w_sr: torch.Tensor
    b_sr: torch.Tensor
    w_pre: torch.Tensor
    b_pre: torch.Tensor
    w_ss: torch.Tensor
    b_ss: torch.Tensor
    w_h1: torch.Tensor
    b_h1: torch.Tensor
    w_pp2: torch.Tensor
    b_pp2: torch.Tensor
    dilations: Tuple[int, ...]
    kernel_size: int
    # int8 only: per-input-index scales (bf16 values, float32) of w_a and of
    # the int8 skip half w_sr, and the bfloat16 res half
    s_a: Optional[torch.Tensor] = None
    s_s: Optional[torch.Tensor] = None
    w_r: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.w_a.dtype == torch.int8

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype (bfloat16 for int8 weights)."""
        return torch.bfloat16 if self.quantized else self.w_a.dtype

    @property
    def device(self) -> torch.device:
        return self.w_a.device

    @property
    def dims(self):
        """(L, K, R, D, S, Q, C, PK)."""
        L, two_d, krc = self.w_a.shape
        R, PK = self.w_pre.shape
        S = self.w_ss.shape[0]
        Q = self.w_pp2.shape[0]
        K = self.kernel_size
        return L, K, R, two_d // 2, S, Q, krc - K * R, PK

    def dequantized(self) -> "GenWeights":
        """The bfloat16 weights that int8 weights stand for (the plain
        twin runs these through the bf16 step)."""
        if not self.quantized:
            return self
        bf = torch.bfloat16
        w_a = dequantize(self.w_a, self.s_a[:, None, :])
        w_s = dequantize(self.w_sr, self.s_s[:, None, :])
        return dataclasses.replace(
            self, w_a=w_a, w_sr=torch.cat([w_s, self.w_r.to(bf)], dim=1),
            s_a=None, s_s=None, w_r=None)


def quantize_rows(rows: torch.Tensor):
    """Per-row int8 quantization of gen_pallas.py:139-143 over the last
    axis: returns (q int8 [..., n], scale float32 [...]) with scale =
    absmax / 127 (1.0 for a zero row), q = clip(round(w / scale), -127,
    127), rounding half to even, all in float32."""
    a = rows.float()
    absmax = a.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """bf16(float(q) * float(bf16(scale))) -- the weight the int8 math uses
    (gen_pallas.py:584-588; the product of two bf16 values is exact in
    float32, so this is bf16 x bf16 rounded once).  ``scale`` broadcasts
    against ``q``."""
    s = scale.to(torch.bfloat16).float()
    return (q.float() * s).to(torch.bfloat16)


def pack_gen_params(params, cfg, dtype: torch.dtype = torch.float32,
                    device=None) -> GenWeights:
    """Pack a decoder parameter dict (JAX layouts, torch tensors) for the
    kernel.  ``cfg`` is a WavenetConfig; the decoder must have lc kernels
    and preprocess_filters == residual_filters, as the TPU kernel required.
    ``dtype``: float32 | bfloat16 | int8 (see the module doc)."""
    lp = params["layers"]
    if "lc_kernel" not in lp:
        raise ValueError("generation kernel needs a local condition "
                         "(layers/lc_kernel)")
    if cfg.preprocess_filters != cfg.residual_filters:
        raise ValueError("generation needs preprocess_filters == "
                         "residual_filters (the preprocess output is the "
                         "residual stream)")
    L, K = cfg.num_layers, cfg.kernel_size
    R, D = cfg.residual_filters, cfg.dilation_filters

    int8 = dtype == torch.int8
    act = torch.bfloat16 if int8 else dtype

    def cv(x, dt=act):
        return x.to(device=device, dtype=dt).contiguous()

    # [K*R + C, 2D]: taps (oldest first) and lc, JAX's input rows
    w_a = torch.cat([lp["kernel"].reshape(L, K * R, 2 * D),
                     lp["lc_kernel"]], dim=1)
    b_a, skip, skip_b = lp["bias"], lp["skip_kernel"], lp["skip_bias"]
    pp1 = params["postprocess1"]
    w_h1 = torch.cat([pp1["kernel"][0], pp1["lc_kernel"]], dim=0)
    # zero columns for the oldest window slots, up to a multiple of 8
    w_pre = params["preprocess"]["kernel"][:, 0, :].T
    w_pre = F.pad(w_pre, (-w_pre.shape[1] % 8, 0))
    w = GenWeights(
        w_a=cv(w_a.transpose(1, 2)), b_a=cv(b_a),
        w_sr=cv(torch.cat([skip, lp["res_kernel"]], dim=2).transpose(1, 2)),
        b_sr=cv(torch.cat([skip_b, lp["res_bias"]], dim=1)),
        w_pre=cv(w_pre), b_pre=cv(params["preprocess"]["bias"]),
        w_ss=cv(params["skip_start"]["kernel"][0].T),
        b_ss=cv(params["skip_start"]["bias"]),
        w_h1=cv(w_h1.T), b_h1=cv(pp1["bias"]),
        w_pp2=cv(params["postprocess2"]["kernel"][0].T),
        b_pp2=cv(params["postprocess2"]["bias"]),
        dilations=tuple(int(d) for d in cfg.dilation_rates),
        kernel_size=K)
    if not int8:
        return w
    q_a, s_a = quantize_rows(w_a)                   # [L, KR+C, 2D], [L, KR+C]
    q_s, s_s = quantize_rows(skip)                  # [L, D, S], [L, D]
    q_b, s_b = quantize_rows(b_a)                   # one row per layer
    q_sb, s_sb = quantize_rows(skip_b)
    b_sr = torch.cat([dequantize(q_sb, s_sb[:, None]),
                      lp["res_bias"].to(torch.bfloat16)], dim=1)
    return dataclasses.replace(
        w, w_a=cv(q_a.transpose(1, 2), torch.int8),
        s_a=cv(s_a.to(torch.bfloat16), torch.float32),
        b_a=cv(dequantize(q_b, s_b[:, None])),
        w_sr=cv(q_s.transpose(1, 2), torch.int8),
        s_s=cv(s_s.to(torch.bfloat16), torch.float32),
        w_r=cv(lp["res_kernel"].transpose(1, 2)), b_sr=cv(b_sr))


def condition_terms(params, w: GenWeights, batch: int,
                    global_condition: Optional[torch.Tensor] = None):
    """Per-clip global-condition terms (gen_pallas.py:826-843):
    gcon [L, B, 2D] and g_pp1 [B, S] in the activation dtype (zeros when
    there is no global condition)."""
    L, _, _, D, S, _, _, _ = w.dims
    lp = params["layers"]
    pp1 = params["postprocess1"]
    if global_condition is None or "gc_kernel" not in lp:
        return (torch.zeros((L, batch, 2 * D), dtype=w.dtype, device=w.device),
                torch.zeros((batch, S), dtype=w.dtype, device=w.device))
    g = global_condition[:, 0, :].float().to(w.device)                # [B, Cg]
    gcon = torch.einsum("bc,lcd->lbd", g, lp["gc_kernel"].float().to(w.device))
    if "gc_bias" in lp:
        gcon = gcon + lp["gc_bias"].float().to(w.device)[:, None, :]
    g_pp1 = torch.zeros((batch, S), dtype=torch.float32, device=w.device)
    if "gc_kernel" in pp1:
        g_pp1 = g @ pp1["gc_kernel"].float().to(w.device)
        if "gc_bias" in pp1:
            g_pp1 = g_pp1 + pp1["gc_bias"].float().to(w.device)
    return gcon.to(w.dtype).contiguous(), g_pp1.to(w.dtype).contiguous()


# ------------------------------------------------------------------ Philox

_MASK = 0xFFFFFFFF


def _mulhilo(a: int, x: torch.Tensor):
    # exact 32x32 -> 64-bit product in int64 without overflow
    xl, xh = x & 0xFFFF, x >> 16
    lo_part, mid = a * xl, a * xh
    s = lo_part + ((mid & 0xFFFF) << 16)
    return (mid >> 16) + (s >> 32), s & _MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 on int64 tensors holding uint32 values."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK
        k1 = (k1 + 0xBB67AE85) & _MASK
    return c0, c1, c2, c3


def gumbel_noise(seed: int, step: int, batch: int, q: int,
                 device=None) -> torch.Tensor:
    """Gumbel(0, 1) noise [batch, q] from Philox word 0 of counter
    (step, row, bin, 0) under key (seed low, seed high) -- the kernel's
    bits; u = (bits >> 8 + 0.5) / 2^24 lies strictly inside (0, 1)."""
    b = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(q, dtype=torch.int64, device=device)[None, :]
    c0 = torch.full((batch, q), step & _MASK, dtype=torch.int64, device=device)
    bits = philox4x32(c0, b.expand(batch, q), j.expand(batch, q),
                      torch.zeros_like(c0), seed & _MASK,
                      (seed >> 32) & _MASK)[0]
    u = ((bits >> 8).float() + 0.5) * (1.0 / 16777216.0)
    return -torch.log(-torch.log(u))


def select_bins(logits: torch.Tensor, mode: str, seed: int,
                step: int) -> torch.Tensor:
    """Greedy argmax or Gumbel-max over float32 logits [B, Q] -> int64 [B]
    (torch.argmax returns the first maximal index, as the kernel does)."""
    if mode == "sample":
        logits = logits + gumbel_noise(seed, step, logits.shape[0],
                                       logits.shape[1], logits.device)
    elif mode != "greedy":
        raise NotImplementedError(f"decode mode {mode} not implemented")
    return torch.argmax(logits, dim=-1)


def frame_ratio(length: int, t_cond: int, ratio: Optional[int] = None) -> int:
    """Samples per condition frame: ``ratio`` when the caller gives it (from
    the real clip length, before any bucket padding), else the floor
    length // t_cond (the TF1 reference's ratio)."""
    r = length // t_cond if ratio is None else int(ratio)
    if r < 1:
        raise ValueError(f"{t_cond} condition frames cannot condition "
                         f"{length} samples (ratio {r})")
    return r


def condition_frames(lc: torch.Tensor, length: int, ratio: int) -> torch.Tensor:
    """The condition [B, T_cond, C] extended with copies of its last frame
    to the ceil(length / ratio) frames that samples 0..length-1 read
    (sample i reads frame i // ratio): where i // ratio passes the last
    frame, the last frame is read.  The kernel and the plain twin both take
    this route, so neither reads past the frames it is given."""
    need = -(-length // ratio)
    t_cond = lc.shape[1]
    if need <= t_cond:
        return lc
    return torch.cat([lc, lc[:, -1:].expand(-1, need - t_cond, -1)], dim=1)


# -------------------------------------------------------------- plain step

def init_gen_state(w: GenWeights, batch: int, act_dtype: torch.dtype):
    """Zeroed generation state: per-layer rings [(K-1)*d, B, R] in the
    activation dtype (the fast-WaveNet queues start zeroed,
    wavenet_ops.py:177-186), the preprocess window of mu-law inputs [B, PK]
    and the step counter."""
    _, K, R, _, _, _, _, PK = w.dims
    return {
        "t": 0,
        "window": torch.zeros((batch, PK), dtype=torch.float32,
                              device=w.device),
        "rings": [torch.zeros(((K - 1) * d, batch, R), dtype=act_dtype,
                              device=w.device) for d in w.dilations],
    }


def gen_step(w: GenWeights, state, x_in: torch.Tensor, lc_t: torch.Tensor,
             gcon: torch.Tensor, g_pp1: torch.Tensor, act_dtype: torch.dtype,
             gate_order: str = "tanh_first") -> torch.Tensor:
    """One autoregressive step with the kernel's rounding points (after
    vqvae_wavenet_tpu/generation/fast.py:63-153).  Updates ``state`` in
    place.  Activations round to ``act_dtype``; the weights may be float32
    copies of bfloat16 values (every product is float32 either way).

    x_in: [B] float32 input sample (the previous output; 0 at t=0).
    lc_t: [B, C] local condition frame.  Returns float32 logits [B, Q]."""
    _, K, R, D, S, Q, _, _ = w.dims
    dt = act_dtype
    t = state["t"]
    f = torch.float32
    window = torch.cat([state["window"][:, 1:],
                        mu_law_encode(x_in, Q)[:, None]], dim=1)
    state["window"] = window
    cur = (window.to(dt).to(f) @ w.w_pre.to(f).T + w.b_pre.to(f)).to(dt)
    skip = cur.to(f) @ w.w_ss.to(f).T + w.b_ss.to(f)
    lc_t = lc_t.to(dt)
    for l, d in enumerate(w.dilations):
        ring = state["rings"][l]
        size = ring.shape[0]
        # every tap is read before this layer's write: the tap exactly
        # `size` back is the slot about to be overwritten
        taps = [ring[(t - j * d) % size] for j in range(K - 1, 0, -1)]
        x = torch.cat(taps + [cur, lc_t], dim=1).to(f)
        pre = x @ w.w_a[l].to(f).T + w.b_a[l].to(f) + gcon[l].to(f)
        if gate_order == "tanh_first":
            gated = torch.tanh(pre[:, :D]) * torch.sigmoid(pre[:, D:])
        else:
            gated = torch.sigmoid(pre[:, :D]) * torch.tanh(pre[:, D:])
        gated = gated.to(dt)
        ring[t % size] = cur
        out = gated.to(f) @ w.w_sr[l].to(f).T + w.b_sr[l].to(f)
        skip = skip + out[:, :S]
        cur = (cur.to(f) + out[:, S:]).to(dt)
    h = torch.cat([torch.relu(skip).to(dt), lc_t], dim=1).to(f)
    h = torch.relu(h @ w.w_h1.to(f).T + w.b_h1.to(f) + g_pp1.to(f)).to(dt)
    state["t"] = t + 1
    return h.to(f) @ w.w_pp2.to(f).T + w.b_pp2.to(f)


def generate_clip_plain(w: GenWeights, lc: torch.Tensor, gcon, g_pp1, *,
                        length: int, mode: str = "greedy", seed: int = 0,
                        gate_order: str = "tanh_first",
                        forced: Optional[torch.Tensor] = None,
                        want_logits: bool = False,
                        ratio: Optional[int] = None):
    """The plain twin of the kernel: ``length`` steps of ``gen_step`` plus
    sampling.  lc: [B, T_cond, C]; sample i reads frame i // ratio
    (``frame_ratio``; past the last frame, the last: ``condition_frames``);
    forced: optional [B, length] float32 inputs (teacher forcing: input i
    is the ground-truth sample i-1).  Returns (bins int64 [B, length],
    logits float32 [B, length, Q] or None).  int8 weights are dequantized
    once and run through the bf16 step."""
    w = w.dequantized()
    dt = w.dtype
    # exact float32 copies: the step's products are float32 either way
    w = dataclasses.replace(w, **{f.name: getattr(w, f.name).float()
                                  for f in dataclasses.fields(w)
                                  if isinstance(getattr(w, f.name),
                                                torch.Tensor)})
    B, t_cond, _ = lc.shape
    ratio = frame_ratio(length, t_cond, ratio)
    lc = condition_frames(lc, length, ratio)
    state = init_gen_state(w, B, dt)
    x_in = torch.zeros((B,), dtype=torch.float32, device=w.device)
    bins_out: List[torch.Tensor] = []
    logits_out: List[torch.Tensor] = []
    for i in range(length):
        if forced is not None:
            x_in = forced[:, i].float()
        logits = gen_step(w, state, x_in, lc[:, i // ratio], gcon, g_pp1,
                          dt, gate_order)
        bins = select_bins(logits, mode, seed, i)
        bins_out.append(bins)
        if want_logits:
            logits_out.append(logits)
        x_in = mu_law_decode(bins, w.w_pp2.shape[0])
    return (torch.stack(bins_out, dim=1),
            torch.stack(logits_out, dim=1) if want_logits else None)


# ----------------------------------------------------------------- kernel

@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("gen_wavenet")
    lib.gen_wavenet.restype = ctypes.c_int
    lib.gen_wavenet.argtypes = (
        [ctypes.c_int] * 12            # dtype, L K R D S Q C PK, B length ratio
        + [ctypes.c_void_p] * 2        # dil, ring_off
        + [ctypes.c_void_p] * 15       # packed weights, int8 s_a s_s w_r
        + [ctypes.c_void_p] * 3        # lc, gcon, g_pp1
        + [ctypes.c_void_p, ctypes.c_int]   # inputs, forced
        + [ctypes.c_void_p] * 8        # ring cur gated skip h1 logits logits_out bins
        + [ctypes.c_void_p]            # barrier counter
        + [ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong]  # mode gate seed
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]    # stamps lo n
        + [ctypes.c_void_p])           # stream
    lib.gen_wavenet_grid.restype = ctypes.c_int
    lib.gen_wavenet_grid.argtypes = []
    return lib


# the stamped build's events per phase and block (csrc/gen_wavenet.cu, Ev)
STAMP_EVENTS = ("start", "staged", "weights", "done", "exit")


def generate_clip_cuda(w: GenWeights, lc: torch.Tensor, gcon, g_pp1, *,
                       length: int, mode: str = "greedy", seed: int = 0,
                       gate_order: str = "tanh_first",
                       forced: Optional[torch.Tensor] = None,
                       want_logits: bool = False,
                       ratio: Optional[int] = None):
    """Launch the persistent whole-clip kernel once (one block per SM):
    its float32, bfloat16 or int8-weight variant, by the weights' type.
    Same contract as ``generate_clip_plain``."""
    return _launch(w, lc, gcon, g_pp1, length=length, mode=mode, seed=seed,
                   gate_order=gate_order, forced=forced,
                   want_logits=want_logits, ratio=ratio)[:2]


def generate_clip_stamped(w: GenWeights, lc: torch.Tensor, gcon, g_pp1, *,
                          length: int, stamp_from: int, stamp_samples: int,
                          **kw):
    """The kernel's stamped build (a measurement, not a path of the port):
    as ``generate_clip_cuda``, and also the globaltimer stamps (ns) of
    samples stamp_from .. stamp_from + stamp_samples - 1 as int64
    [samples, 2L+3 phases, blocks, STAMP_EVENTS], 0 where an event did
    not happen (thread 0 idle in that phase).  Phases: 0 the sampling of
    the previous step and the preprocess conv, 1 + 2l / 2 + 2l layer l's
    gate and [skip | res] phases, 2L+1 and 2L+2 the two postprocess
    convs."""
    return _launch(w, lc, gcon, g_pp1, length=length,
                   stamp=(stamp_from, stamp_samples), **kw)


def _launch(w: GenWeights, lc: torch.Tensor, gcon, g_pp1, *, length: int,
            mode: str = "greedy", seed: int = 0,
            gate_order: str = "tanh_first",
            forced: Optional[torch.Tensor] = None, want_logits: bool = False,
            stamp: Optional[Tuple[int, int]] = None,
            ratio: Optional[int] = None):
    global launches, int8_launches
    L, K, R, D, S, Q, C, PK = w.dims
    dev = w.device
    q8 = w.quantized
    if dev.type != "cuda":
        raise ValueError("generate_clip_cuda needs CUDA weights")
    if w.w_a.dtype not in _DTYPES:
        raise TypeError(f"generation kernel takes float32, bfloat16 or int8 "
                        f"weights, not {w.w_a.dtype}")
    if mode not in ("greedy", "sample"):
        raise NotImplementedError(f"decode mode {mode} not implemented")
    if gate_order not in ("tanh_first", "sigmoid_first"):
        raise ValueError(f"gate_order {gate_order}")
    # the kernel reads every weight row as 16-byte vectors: 8 bf16 values,
    # 4 float32 or 16 int8 (w_a's rows of K*R+C and the skip rows of D)
    widths = {"K*R+C": K * R + C, "D": D, "R": R, "S": S, "S+C": S + C,
              "PK": PK}
    odd = {k: v for k, v in widths.items()
           if v % (16 if q8 and k in ("K*R+C", "D") else 8)}
    if odd:
        raise ValueError(f"generation kernel needs packed widths that are "
                         f"multiples of 8 (16 for int8 rows), got {odd}")
    B, t_cond, c_lc = lc.shape
    if c_lc != C or length < 1:
        raise ValueError(f"lc {tuple(lc.shape)} does not fit C={C} and "
                         f"length={length}")
    ratio = frame_ratio(length, t_cond, ratio)
    lc = condition_frames(lc, length, ratio)
    if lc.device != dev:
        raise ValueError("lc is not on the weights' device")
    tensors = [w.w_a, w.b_a, w.w_sr, w.b_sr, w.w_pre, w.b_pre, w.w_ss,
               w.b_ss, w.w_h1, w.b_h1, w.w_pp2, w.b_pp2]
    # w_a and w_sr (0, 2) hold the weights' type, the rest the activations'
    checks = [(x, w.w_a.dtype if i in (0, 2) else w.dtype)
              for i, x in enumerate(tensors)]
    if q8:
        tensors += [w.s_a, w.s_s, w.w_r]
        checks += [(w.s_a, torch.float32), (w.s_s, torch.float32),
                   (w.w_r, torch.bfloat16)]
        if (tuple(w.w_sr.shape) != (L, S, D) or tuple(w.s_a.shape)
                != (L, K * R + C) or tuple(w.s_s.shape) != (L, D)
                or tuple(w.w_r.shape) != (L, R, D)):
            raise ValueError("int8 weights do not have the packed shapes")
    elif tuple(w.w_sr.shape) != (L, S + R, D):
        raise ValueError("w_sr does not have the packed shape")
    lc_k = lc.to(w.dtype).transpose(0, 1).contiguous()         # [T_cond, B, C]
    for x, dt in checks + [(gcon, w.dtype), (g_pp1, w.dtype)]:
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError("packed weights and condition terms must share "
                             "the device, have the packed dtypes and be "
                             "contiguous")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("packed weights must start 16-byte aligned")
    if tuple(gcon.shape) != (L, B, 2 * D) or tuple(g_pp1.shape) != (B, S):
        raise ValueError("condition terms do not match the batch")

    sizes = [(K - 1) * d for d in w.dilations]
    offs = [sum(sizes[:l]) for l in range(L)]
    dil = torch.tensor(w.dilations, dtype=torch.int32, device=dev)
    ring_off = torch.tensor(offs, dtype=torch.int32, device=dev)
    inputs = torch.zeros((length + 1, B), dtype=torch.float32, device=dev)
    if forced is not None:
        if tuple(forced.shape) != (B, length):
            raise ValueError(f"forced inputs {tuple(forced.shape)} != "
                             f"{(B, length)}")
        inputs[:length] = forced.to(device=dev, dtype=torch.float32).T
    ring = torch.zeros((sum(sizes), B, R), dtype=w.dtype, device=dev)
    cur = torch.empty((2, B, R), dtype=w.dtype, device=dev)
    gated = torch.empty((B, D), dtype=w.dtype, device=dev)
    skip = torch.empty((B, S), dtype=torch.float32, device=dev)
    h1 = torch.empty((B, S), dtype=w.dtype, device=dev)
    logits = torch.empty((B, Q), dtype=torch.float32, device=dev)
    logits_out = (torch.empty((length, B, Q), dtype=torch.float32, device=dev)
                  if want_logits else None)
    bins = torch.empty((length, B), dtype=torch.int32, device=dev)
    barrier = torch.zeros((1,), dtype=torch.int64, device=dev)
    ptrs = [x.data_ptr() for x in tensors] + [None] * (15 - len(tensors))

    lib = _lib()
    stamps = None
    if stamp is not None:
        st_lo, st_n = stamp
        if not (0 <= st_lo and st_n >= 1 and st_lo + st_n <= length):
            raise ValueError(f"stamped samples {stamp} outside the clip")
        with torch.cuda.device(dev):
            grid = lib.gen_wavenet_grid()
        stamps = torch.zeros((st_n, 2 * L + 3, grid, len(STAMP_EVENTS)),
                             dtype=torch.int64, device=dev)
    else:
        st_lo, st_n = 0, 0
    with torch.cuda.device(dev), record_function(
            "gen_wavenet_int8" if q8 else "gen_wavenet"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gen_wavenet(
            _DTYPES[w.w_a.dtype], L, K, R, D, S, Q, C, PK, B, length, ratio,
            dil.data_ptr(), ring_off.data_ptr(), *ptrs,
            lc_k.data_ptr(), gcon.data_ptr(), g_pp1.data_ptr(),
            inputs.data_ptr(), int(forced is not None),
            ring.data_ptr(), cur.data_ptr(), gated.data_ptr(),
            skip.data_ptr(), h1.data_ptr(), logits.data_ptr(),
            logits_out.data_ptr() if want_logits else None,
            bins.data_ptr(), barrier.data_ptr(),
            int(mode == "sample"), int(gate_order == "sigmoid_first"),
            seed & 0xFFFFFFFFFFFFFFFF,
            None if stamps is None else stamps.data_ptr(), st_lo, st_n,
            stream)
    _build.check(lib, err, "gen_wavenet")
    if q8:
        int8_launches += 1
    else:
        launches += 1
    return (bins.T.long(),
            logits_out.transpose(0, 1) if want_logits else None, stamps)


def generate_clip(w: GenWeights, lc: torch.Tensor, gcon, g_pp1, **kw):
    """Whole-clip generation: the kernel for CUDA weights, the plain
    version for CPU weights."""
    if w.device.type == "cuda":
        return generate_clip_cuda(w, lc, gcon, g_pp1, **kw)
    return generate_clip_plain(w, lc, gcon, g_pp1, **kw)
