#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  torch/CUDA versions and the card's name and power limit;
  2. build   compile the six sources under vqvae_wavenet_torch/csrc with
             nvcc, one process each, all at once (ptxas registers/spills
             of the generation and training kernels are printed);
  3. vq      the VQ kernel against its plain twin at N = 384 (generation),
             832 (training: B=8 x 104 frames) and 65,536 (k = 512, d = 64);
  4. gen     the generation kernel against its plain twin at the shipped
             wavenet_parameters.json widths with C = 128: teacher-forced
             logits (f32 and bf16), a greedy f32 clip, and sample-mode
             statistics at t = 0; times per sample at B=1 and B=3, and the
             stamped build's per-phase breakdown at B=1 and B=3 (bf16);
  5. gen-int8  the generation kernel's int8-weight variant against its
             plain twin at the same widths: teacher-forced logits at B=3,
             sample-mode bins at t = 0 against the plain twin's Philox
             draws; times per sample at B=1 and B=3 beside the bf16
             kernel's;
  6. e2e     the voice-conversion entry point (vqvae_wavenet_torch.generate)
             on a random full-width model_parameters.json model and a
             synthetic 8,192-sample wav, speakers p225 p226 None, in bf16,
             int8 and f32, greedy and sample; the kernels' launch counters
             are reset before and read after;
  7. magenta the Magenta family's full 50-layer preset (random weights from
             a seed, the init's 1.0 biases, a random speaker table):
             generation kernel against plain teacher-forced in f32, bf16
             and int8, times per sample, then vqvae_wavenet_torch.generate
             -params magenta_parameters.json on the same wav in bf16 and
             int8, greedy and sample, counters reset before and read after;
  8. train-stack     the stack forward and backward kernels against their
             plain twins at the shipped widths and the full training
             shape (B=8, T=6656, 104 frames), f32 and bf16, tanh_first
             (two runs of each bitwise equal; the products alone timed as
             torch.matmul calls, products_matmul_ms), at B=2, T=1024 with
             sigmoid_first and a global condition, and at a ragged shape
             (R=D=136, S=200, B=3, T=5,000, a tap shifted past T) at start
             0 and, through the SP variants, start 1,000;
  9. train-epilogue  the loss-head kernel (both entries) against its
             plain twin at the same shape, f32 and bf16;
  10. train-e2e      the training entry point (vqvae_wavenet_torch.train)
             at -length 6656 -batch 8 on a synthetic VCTK-layout corpus
             with the shipped config in f32 and in bf16, six steps each,
             then vqvae_wavenet_torch.generate from the bf16 checkpoint;
             the launch counters are reset before each run and read after;
  11. sp-stack  the stack kernels' sequence-parallel variants (start
             offset, stream output, dX seed) against their plain twins on
             one dilation cycle of the 2-rank shape (B=8, T_ext=5,376 =
             3,328 + a 2,048-row halo, 84 frames), start 0 and 2,048, f32
             and bf16; times beside the plain kernels' on the same shape;
  12. sp-train  sequence-parallel training: the 2-rank SP loss and
             gradients (spawned ranks, run_ranks) against the single-device
             port's loss_and_grads on one fixed batch and weights at B=8 x
             6656, f32 and bf16; 4 ranks at B=2 (halos of two hops); then
             vqvae_wavenet_torch.train -time_shards 2 for six steps in f32
             and bf16 and generate from the bf16 checkpoint; the SP kernels'
             launches are read from the ranks of those runs.  Both ranks
             share the one GPU, so they talk over gloo through host memory.
  13. train-bwd2  the two-kernel stack backward (the chain kernel, then
             the one-launch dk kernel) against its plain twins and against
             the layer sweep on the same inputs, at B=8 x 6656, the
             shipped widths and the Magenta widths (50 layers, K=2), f32
             and bf16, dk twice on the same inputs bitwise equal, and dk
             at a small ragged shape with a tap offset >= T; times beside
             the sweep's, the bounds, and a torch.bmm yardstick for dk;
  14. magenta-train  vqvae_wavenet_torch.train -params
             magenta_parameters.json at -length 6656 -batch 8, six steps
             each in f32 and bf16 (the layer sweep) and in bf16 with
             train_kernels.BWD_FUSED_DK = "off" (the two-kernel backward),
             counters reset before each run and read after; generate from
             the bf16 checkpoint; the "off" step's loss and gradients
             against the default's on one fixed batch.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and
prints no result.  Outputs go under build/chip_smoke/ (gitignored).
``--only PHASE ...`` runs the device and build phases and the named ones
(for iterating on one part), and prints no kernels' record.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "chip_smoke")
VQ_SOURCE = "vqvae_wavenet_torch/csrc/vq_argmin.cu"
GEN_SOURCE = "vqvae_wavenet_torch/csrc/gen_wavenet.cu"
VQ_REPLACES = "vqvae_wavenet_tpu/ops/vq_pallas.py:32"
GEN_REPLACES = "vqvae_wavenet_tpu/ops/gen_pallas.py:346"
SOURCES = ("vq_argmin", "gen_wavenet", "train_stack_fwd", "train_stack_bwd",
           "train_stack_bwd2", "train_epilogue")
TRAIN = {   # name -> (source, the TPU kernel it replaces)
    "train_stack_fwd": ("vqvae_wavenet_torch/csrc/train_stack_fwd.cu",
                        "vqvae_wavenet_tpu/ops/train_pallas.py:1196"),
    "train_stack_bwd": ("vqvae_wavenet_torch/csrc/train_stack_bwd.cu",
                        "vqvae_wavenet_tpu/ops/train_pallas.py:735"),
    "train_epilogue_fwd": ("vqvae_wavenet_torch/csrc/train_epilogue.cu",
                           "vqvae_wavenet_tpu/ops/train_pallas.py:1981"),
    "train_epilogue_bwd": ("vqvae_wavenet_torch/csrc/train_epilogue.cu",
                           "vqvae_wavenet_tpu/ops/train_pallas.py:2008"),
    "train_stack_fwd_sp": ("vqvae_wavenet_torch/csrc/train_stack_fwd.cu",
                           "vqvae_wavenet_tpu/ops/train_pallas.py:1196"),
    "train_stack_bwd_sp": ("vqvae_wavenet_torch/csrc/train_stack_bwd.cu",
                           "vqvae_wavenet_tpu/ops/train_pallas.py:735"),
    "train_stack_bwd_chain": ("vqvae_wavenet_torch/csrc/train_stack_bwd2.cu",
                              "vqvae_wavenet_tpu/ops/train_pallas.py:180"),
    "train_stack_bwd_dk": ("vqvae_wavenet_torch/csrc/train_stack_bwd2.cu",
                           "vqvae_wavenet_tpu/ops/train_pallas.py:493"),
}

# the H100 SXM's published peaks: bf16 tensor cores, f32 outside the
# tensor cores, HBM3
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12

# tolerances (reasons in the phase docstrings)
F32_LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 5e-2
VQ_TIE_REL = 1e-5
GREEDY_TIE = 1e-4
TRAIN_TOL = {"f32": 1e-3, "bf16": 2e-2}
SP_SEED = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of fn over ``iters`` calls (after
    one warm-up call), by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)                       # name, power limit as nvidia-smi gives them
    return card


def bound(flops: float, nbytes: float, dtype: str):
    """(bound_ms, bound_by): the larger of the operations over the peak
    for their type and the bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_build():
    from vqvae_wavenet_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(SOURCES)
    for name in SOURCES:
        _build.load(name)
    log(f"[build] {time.perf_counter() - t0:.2f}s total; nvcc seconds per "
        f"source (in parallel): "
        f"{json.dumps({k: round(v, 2) for k, v in _build.build_seconds.items()})}")
    for name in SOURCES[1:]:
        info = _build.ptxas_info.get(name, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", info)]
        spills = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", info))
        if regs:
            log(f"[build] {name}: {len(regs)} kernels, {min(regs)}-"
                f"{max(regs)} registers per thread, {spills} bytes of "
                f"spill stores and loads (ptxas)")


def phase_vq():
    """Kernel vs plain on the card.  Indices must be equal wherever the
    plain version's best-to-second distance gap exceeds 1e-5 * ||e||^2
    (the two sum the 64-term dot in different orders, so closer ties may
    legitimately resolve either way)."""
    from vqvae_wavenet_torch.ops import vq_kernels as vk
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    k, d = 512, 64
    emb = ((torch.rand((k, d), generator=g) * 2 - 1)
           * 1.7 * (3.0 / k) ** 0.5).to(dev)
    result = {}
    for n in (384, 832, 65536):     # generation; training (B=8 x 104); large
        z = (torch.randn((n, d), generator=g) * 0.1).to(dev)
        got = vk.vq_nearest_cuda(z, emb)
        ref = vk.vq_nearest_plain(z, emb)
        dist = torch.sum(emb * emb, -1) - 2.0 * (z @ emb.T)
        top2 = torch.topk(dist, 2, dim=-1, largest=False).values
        gap = top2[:, 1] - top2[:, 0]
        tie_ok = gap <= VQ_TIE_REL * torch.sum(emb * emb, -1)[ref]
        bad = (got != ref) & ~tie_ok
        err = float((dist.gather(1, got[:, None])
                     - dist.gather(1, ref[:, None])).abs().max())
        ms = cuda_ms(lambda: vk.vq_nearest_cuda(z, emb), 50)
        plain_ms = cuda_ms(lambda: vk.vq_nearest_plain(z, emb), 50)
        b_ms, b_by = bound(2.0 * n * k * d, nbytes(z, emb) + 4 * n, "f32")
        log(f"[vq] N={n} k={k} d={d}: mismatches {int((got != ref).sum())} "
            f"(outside ties {int(bad.sum())}), max |dist(kernel) - "
            f"dist(plain)| {err:.3g}; kernel {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us")
        if bad.any():
            raise AssertionError(f"VQ kernel disagrees with plain at N={n}")
        result[n] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return result[384]


def _gen_model(seed: int = 0):
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    cfg = ModelConfig.from_json(os.path.join(REPO, "model_parameters.json"))
    params, _ = random_params_np(cfg, 109, seed)
    return cfg, to_torch(params["decoder"], "cuda")


def phase_gen(card: str):
    """Kernel vs plain at the shipped widths (R=256, 2D=512, S=512, Q=256,
    30 layers, C=128).

    (a) teacher-forced logits, 256 steps, at B=3 (tanh_first, no global
        condition: the main path) and at B=10 (sigmoid_first, a random
        global condition; two staging passes of 8 rows): f32 within 1e-3 *
        max(1, max|logit|) (dot products summed in another order);
        bf16 within 5e-2 * max(1, max|logit|) (the same rounding points,
        but an f32 difference of one ulp can round an activation to the
        neighbouring bf16 value, 0.4% apart, and that propagates).
    (b) greedy f32 clip of 2048 samples, B=1: identical bins, or the first
        divergence at a step where the plain version's top two logits lie
        within 1e-4.
    (c) sample mode at t=0 over 256 identical streams: chi-square of the
        kernel's bins against softmax(step-0 logits), p > 1e-3, and the
        same bins as the plain version, which draws the same Philox bits.
    Then times per sample at B=1 and B=3, bf16 and f32."""
    from scipy.stats import chi2 as chi2_dist
    from vqvae_wavenet_torch.ops import gen_kernels as gk
    cfg, dec = _gen_model()
    wcfg = cfg.wavenet
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    c_lc = dec["layers"]["lc_kernel"].shape[1]
    out = {}

    # (a) teacher forcing
    steps = 256
    t = torch.arange(steps, dtype=torch.float32)
    lc = (torch.randn((3, 4, c_lc), generator=g) * 0.5).to(dev)
    c_gc, b_gc = 16, 10
    dec_gc = {**dec,
              "layers": {**dec["layers"], "gc_kernel": (torch.randn(
                  (wcfg.num_layers, c_gc, 2 * wcfg.dilation_filters),
                  generator=g) * 0.05).to(dev)},
              "postprocess1": {**dec["postprocess1"], "gc_kernel": (
                  torch.randn((c_gc, wcfg.skip_filters), generator=g)
                  * 0.05).to(dev)}}
    cases = [(dec, lc, None, "tanh_first"),
             (dec_gc, (torch.randn((b_gc, 4, c_lc), generator=g) * 0.5
                       ).to(dev),
              torch.randn((b_gc, 1, c_gc), generator=g).to(dev),
              "sigmoid_first")]
    for params, lcb, gc, gate_order in cases:
        b = lcb.shape[0]
        x = (0.4 * torch.sin(2 * np.pi * 220.0 * t / 16000.0)[None]
             + 0.05 * torch.randn((b, steps), generator=g)).clamp(-1, 1)
        forced = torch.cat([torch.zeros((b, 1)), x[:, :-1]], dim=1).to(dev)
        for dtype, tol in ((torch.float32, F32_LOGIT_TOL),
                           (torch.bfloat16, BF16_LOGIT_TOL)):
            w = gk.pack_gen_params(params, wcfg, dtype, dev)
            gcon, g_pp1 = gk.condition_terms(params, w, b, gc)
            kw = dict(length=steps, gate_order=gate_order, forced=forced,
                      want_logits=True)
            _, lk = gk.generate_clip_cuda(w, lcb, gcon, g_pp1, **kw)
            _, lp = gk.generate_clip_plain(w, lcb, gcon, g_pp1, **kw)
            err = float((lk - lp).abs().max())
            scale = max(1.0, float(lp.abs().max()))
            log(f"[gen] teacher-forced {dtype} B={b} {gate_order} "
                f"gc={'yes' if gc is not None else 'no'} T={steps}: max "
                f"|logit err| {err:.3g} (mean "
                f"{float((lk - lp).abs().mean()):.3g}), max |logit| "
                f"{scale:.3g}, tolerance {tol * scale:.3g}")
            if not err <= tol * scale:
                raise AssertionError(f"teacher-forced logits disagree "
                                     f"({dtype}, B={b}, {gate_order})")
            if dtype == torch.float32 and b == 3:
                out["max_abs_err"] = err

    # (b) greedy f32 clip
    length = 2048
    w32 = gk.pack_gen_params(dec, wcfg, torch.float32, dev)
    lc1 = lc[:1, :, :].repeat_interleave(8, dim=1)        # 32 frames
    gcon, g_pp1 = gk.condition_terms(dec, w32, 1)
    bk, _ = gk.generate_clip_cuda(w32, lc1, gcon, g_pp1, length=length)
    bp, lp = gk.generate_clip_plain(w32, lc1, gcon, g_pp1, length=length,
                                    want_logits=True)
    diff = (bk != bp).nonzero()
    if len(diff):
        first = int(diff[0, 1])
        top2 = torch.topk(lp[0, first], 2).values
        margin = float(top2[0] - top2[1])
        log(f"[gen] greedy f32 {length}: first divergence at step {first}, "
            f"plain top-two margin {margin:.3g}")
        if margin > GREEDY_TIE:
            raise AssertionError("greedy bins diverge away from a near tie")
    else:
        log(f"[gen] greedy f32 {length}: bins identical "
            f"({int(torch.unique(bk).numel())} distinct bins)")

    # (c) sample mode at t=0 over 256 identical streams
    n = 256
    lcn = lc[:1, :1, :].expand(n, 1, c_lc).contiguous()
    gcon, g_pp1 = gk.condition_terms(dec, w32, n)
    bins, lk = gk.generate_clip_cuda(w32, lcn, gcon, g_pp1, length=1,
                                     mode="sample", seed=12345,
                                     want_logits=True)
    bins_plain, _ = gk.generate_clip_plain(w32, lcn, gcon, g_pp1, length=1,
                                           mode="sample", seed=12345)
    p = torch.softmax(lk[0, 0].double(), 0).cpu().numpy()
    counts = np.bincount(bins[:, 0].cpu().numpy(), minlength=p.size)
    exp = p * n
    small = exp < 5
    obs_g = np.append(counts[~small], counts[small].sum())
    exp_g = np.append(exp[~small], exp[small].sum())
    keep = exp_g > 0
    obs_g, exp_g = obs_g[keep], exp_g[keep]
    chi2 = float(((obs_g - exp_g) ** 2 / exp_g).sum())
    dof = max(len(obs_g) - 1, 1)
    pval = float(chi2_dist.sf(chi2, dof))
    same = int((bins == bins_plain).sum())
    log(f"[gen] sample t=0 x{n}: chi2 {chi2:.1f} dof {dof} p {pval:.3g}; "
        f"kernel == plain (same Philox bits) on {same}/{n} streams")
    if not pval > 1e-3:
        raise AssertionError("in-kernel sampling does not follow softmax")
    if same != n:
        raise AssertionError("in-kernel sampling differs from the plain "
                             "version's draws on the same Philox bits")

    # times per sample (device time, CUDA events), kernel vs plain
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        w = gk.pack_gen_params(dec, wcfg, dtype, dev)
        for b in (1, 3):
            lcb = lc[:1].expand(b, 4, c_lc).repeat_interleave(8, dim=1) \
                .contiguous()
            kern, plain = times[(str(dtype).split(".")[-1], b)] = \
                _gen_times(gk, dec, w, lcb, 2048, 3)
            log(f"[gen] {str(dtype).split('.')[-1]} B={b}: kernel "
                f"{kern * 1e3:.1f} us/sample, plain {plain * 1e3:.1f} "
                f"us/sample  ({card})")
    for b in (1, 3):
        lcb = lc[:1].expand(b, 4, c_lc).repeat_interleave(8, dim=1) \
            .contiguous()
        _gen_breakdown("gen", gk, dec,
                       gk.pack_gen_params(dec, wcfg, torch.bfloat16, dev), lcb,
                       card)
    out["ms"], out["plain_ms"] = times[("bfloat16", 3)]
    # per sample at B=3, bf16: the weights read once per clip (2,048
    # samples) and every layer's products for 3 rows
    wb = gk.pack_gen_params(dec, wcfg, torch.bfloat16, dev)
    out["bound_ms"], out["bound_by"] = bound(
        2.0 * 3 * _gen_macs(wb), _weight_bytes(wb) / 2048, "bf16")
    out["library_ms"] = None
    return out


def phase_gen_int8(card: str):
    """The int8-weight variant against its plain twin at the shipped widths
    (30 layers, R=256, 2D=512, S=512, C=128).  The plain twin runs the
    bf16 step on the weights dequantized as the kernel dequantizes them,
    so the two differ only in summation order, as bf16 does:
    (a) teacher-forced logits, 256 steps, B=3, within 5e-2 * max(1,
        max|logit|) (the bf16 tolerance of [gen]);
    (b) sample mode at t=0 over 256 identical streams: the same bins as
        the plain twin's draws on the same Philox bits.
    Then times per sample at B=1 and B=3, the bf16 kernel's beside them
    (one call, in turns).  The bound counts the int8 weights read once per
    2,048-sample clip, as [gen] does for bf16; the line also gives one
    pass over them at 3.35 TB/s, the per-sample weight stream."""
    from vqvae_wavenet_torch.ops import gen_kernels as gk
    cfg, dec = _gen_model()
    wcfg = cfg.wavenet
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2)
    c_lc = dec["layers"]["lc_kernel"].shape[1]
    w8 = gk.pack_gen_params(dec, wcfg, torch.int8, dev)
    wb = gk.pack_gen_params(dec, wcfg, torch.bfloat16, dev)
    lc = (torch.randn((3, 4, c_lc), generator=g) * 0.5).to(dev)
    err = _teacher_forced_check("gen-int8", dec, w8, lc, None, "tanh_first",
                                BF16_LOGIT_TOL, g)

    n = 256
    lcn = lc[:1, :1, :].expand(n, 1, c_lc).contiguous()
    gcon, g_pp1 = gk.condition_terms(dec, w8, n)
    kw = dict(length=1, mode="sample", seed=777)
    bins, _ = gk.generate_clip_cuda(w8, lcn, gcon, g_pp1, **kw)
    bins_plain, _ = gk.generate_clip_plain(w8, lcn, gcon, g_pp1, **kw)
    same = int((bins == bins_plain).sum())
    log(f"[gen-int8] sample t=0 x{n}: kernel == plain (same Philox bits) on "
        f"{same}/{n} streams ({int(torch.unique(bins).numel())} distinct "
        f"bins)")
    if same != n:
        raise AssertionError("int8 in-kernel sampling differs from the plain "
                             "twin's draws")

    times = {}
    for b in (1, 3):
        lcb = lc[:1].expand(b, 4, c_lc).repeat_interleave(8, dim=1) \
            .contiguous()
        for name, w in (("bf16", wb), ("int8", w8)):
            times[(name, b)] = _gen_times(gk, dec, w, lcb, 2048, 3)
        log(f"[gen-int8] B={b}: int8 kernel {times[('int8', b)][0] * 1e3:.1f}"
            f" us/sample (plain {times[('int8', b)][1] * 1e3:.1f}), bf16 "
            f"kernel {times[('bf16', b)][0] * 1e3:.1f} us/sample  ({card})")
    out = {"max_abs_err": err}
    out["ms"], out["plain_ms"] = times[("int8", 3)]
    weight_bytes = _weight_bytes(w8)
    out["bound_ms"], out["bound_by"] = bound(
        2.0 * 3 * _gen_macs(w8), weight_bytes / 2048, "bf16")
    out["library_ms"] = None
    log(f"[gen-int8] packed weights {weight_bytes / 1e6:.2f} MB int8 "
        f"(+ scales and bf16 parts) vs {_weight_bytes(wb) / 1e6:.2f} MB bf16; "
        f"one pass over them at 3.35 TB/s = "
        f"{weight_bytes / PEAK_BYTES * 1e6:.2f} us (int8), "
        f"{_weight_bytes(wb) / PEAK_BYTES * 1e6:.2f} us (bf16)")
    return out


def _gen_breakdown(tag, gk, params, w, lcb, card, length: int = 2048,
                   lo: int = 512, n: int = 256):
    """Per-phase breakdown of the generation kernel from its stamped build
    (globaltimer stamps of samples lo .. lo+n-1 of a ``length``-sample
    clip, means in us per phase): for block 0 and for the last block to
    reach the barrier, activation staging (phase start -> staged), weight
    load (staged -> first weight vector in registers; 0 where it landed
    before), arithmetic (-> every warp done, with later load rounds and
    the writes) and barrier wait (done -> exit); and the barrier's
    propagation, the last block's arrival to the first block's exit.
    Returns {phase group: {segment: us}} of block 0."""
    L = w.dims[0]
    gcon, g_pp1 = gk.condition_terms(params, w, lcb.shape[0])
    _, _, st = gk.generate_clip_stamped(w, lcb, gcon, g_pp1, length=length,
                                        stamp_from=lo, stamp_samples=n)
    st = st.double().cpu() / 1e3                       # us
    groups = {"SP": [0], "A": list(range(1, 2 * L + 1, 2)),
              "B": list(range(2, 2 * L + 2, 2)), "H1": [2 * L + 1],
              "H2": [2 * L + 2]}

    def segments(e):                                    # e [..., 5]
        start, staged, wts, done, ex = e.unbind(-1)
        stg = torch.where(staged > 0, staged - start, torch.zeros_like(start))
        after = torch.maximum(start, staged)
        wl = torch.where(wts > 0, wts - after, torch.zeros_like(start))
        ar = done - torch.maximum(after, wts)
        return {"staging": stg, "weights": wl, "arithmetic": ar,
                "barrier": ex - done, "phase": ex - start}

    wt = str(w.w_a.dtype).split(".")[-1]
    res = {}
    for name, phs in groups.items():
        sel = st[:, phs]                                # [n, p, G, 5]
        b0 = {k: float(v.mean()) for k, v in segments(sel[:, :, 0]).items()}
        last_i = sel[..., 3].argmax(-1)                 # [n, p]
        last = torch.gather(sel, 2, last_i[..., None, None].expand(
            -1, -1, 1, 5))[:, :, 0]
        lseg = {k: float(v.mean()) for k, v in segments(last).items()}
        ex = sel[..., 4]
        prop = float((torch.where(ex > 0, ex, torch.full_like(ex, 1e30))
                      .amin(-1) - sel[..., 3].amax(-1)).mean())
        late = float((last[..., 0] - sel[:, :, 0, 0]).mean())
        res[name] = b0
        log(f"[{tag}] stamps {wt} B={lcb.shape[0]} phase {name} (x{len(phs)} "
            f"per sample): block 0 staging {b0['staging']:.2f} us, weights "
            f"{b0['weights']:.2f}, arithmetic {b0['arithmetic']:.2f}, barrier "
            f"wait {b0['barrier']:.2f} (phase {b0['phase']:.2f}); last block "
            f"to arrive (block {int(last_i.mode().values.mode().values)} most "
            f"often; starts {late:.2f} us after block 0) staging "
            f"{lseg['staging']:.2f}, weights {lseg['weights']:.2f}, "
            f"arithmetic {lseg['arithmetic']:.2f}; barrier propagation "
            f"{prop:.2f} us  ({card})")
    per_sample = sum(res[k]["phase"] * len(v) for k, v in groups.items())
    log(f"[{tag}] stamps {wt} B={lcb.shape[0]}: {per_sample:.1f} us per "
        f"sample in the stamped build (phases of block 0 summed)")
    return res


def _gen_macs(w) -> int:
    """Multiply-adds of one generation step for one batch row."""
    L, K, R, D, S, Q, C, PK = w.dims
    return (L * (2 * D * (K * R + C) + (S + R) * D) + PK * R + S * R
            + S * (S + C) + Q * S)


def _weight_bytes(w) -> int:
    """Bytes of every packed weight tensor (int8: with scales and w_r)."""
    return nbytes(*[v for v in vars(w).values() if isinstance(v, torch.Tensor)])


def _gen_times(gk, params, w, lcb, length: int, iters: int):
    """(kernel, plain) ms per sample for a clip of ``length`` samples
    (plain: a 64-step clip)."""
    gcon, g_pp1 = gk.condition_terms(params, w, lcb.shape[0])
    kern = cuda_ms(lambda: gk.generate_clip_cuda(
        w, lcb, gcon, g_pp1, length=length), iters) / length
    plain = cuda_ms(lambda: gk.generate_clip_plain(
        w, lcb[:, :1], gcon, g_pp1, length=64), 1) / 64
    return kern, plain


def _teacher_forced_check(tag, params, w, lc, gc, gate_order, tol, g,
                          steps: int = 256) -> float:
    """Teacher-forced logits of the kernel against the plain twin over
    ``steps`` steps of a noisy sine; raises beyond tol * max(1, max|logit|).
    Returns max |kernel - plain|."""
    from vqvae_wavenet_torch.ops import gen_kernels as gk
    b = lc.shape[0]
    t = torch.arange(steps, dtype=torch.float32)
    x = (0.4 * torch.sin(2 * np.pi * 220.0 * t / 16000.0)[None]
         + 0.05 * torch.randn((b, steps), generator=g)).clamp(-1, 1)
    forced = torch.cat([torch.zeros((b, 1)), x[:, :-1]], dim=1).to(lc.device)
    gcon, g_pp1 = gk.condition_terms(params, w, b, gc)
    kw = dict(length=steps, gate_order=gate_order, forced=forced,
              want_logits=True)
    _, lk = gk.generate_clip_cuda(w, lc, gcon, g_pp1, **kw)
    _, lp = gk.generate_clip_plain(w, lc, gcon, g_pp1, **kw)
    err = float((lk - lp).abs().max())
    scale = max(1.0, float(lp.abs().max()))
    wt = str(w.w_a.dtype).split(".")[-1]
    log(f"[{tag}] teacher-forced {wt} weights B={b} {gate_order} "
        f"gc={'yes' if gc is not None else 'no'} T={steps}: max |logit err| "
        f"{err:.3g} (mean {float((lk - lp).abs().mean()):.3g}), max |logit| "
        f"{scale:.3g}, tolerance {tol * scale:.3g}")
    if not err <= tol * scale:
        raise AssertionError(f"{tag}: teacher-forced logits disagree ({wt})")
    return err


def _e2e_wav() -> str:
    """A synthetic 8,192-sample 16 kHz wav under build/chip_smoke."""
    from scipy.io import wavfile
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(0)
    t = np.arange(8192) / 16000.0
    wav = (0.4 * np.sin(2 * np.pi * 180.0 * t) * (1 + 0.3 * np.sin(
        2 * np.pi * 3.0 * t)) + 0.02 * rng.standard_normal(t.size))
    audio = os.path.join(OUT, "input.wav")
    wavfile.write(audio, 16000, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return audio


def _convert(card, tag, ckpt, params_json, audio, dtype, mode,
             distinct: bool):
    """One vqvae_wavenet_torch.generate run (speakers p225 p226 None) with
    the launch counters set to 0 just before and read just after; checks
    three finite 8,192-sample wavs.  Returns the counts."""
    from scipy.io import wavfile
    from vqvae_wavenet_torch import generate as gen_cli
    from vqvae_wavenet_torch.ops import gen_kernels, vq_kernels
    vq_kernels.launches = 0
    gen_kernels.launches = gen_kernels.int8_launches = 0
    res = gen_cli.main([
        "-restore", ckpt, "-audio", audio, "-speakers", "p225", "p226",
        "None", "-mode", mode, "-params", params_json,
        "-data", os.path.join(REPO, "data"), "-dtype", dtype,
        "-device", "cuda", "-seed", "3"])
    counts = {"vq_argmin": vq_kernels.launches,
              "gen_wavenet": gen_kernels.launches,
              "gen_wavenet_int8": gen_kernels.int8_launches}
    outs = [wavfile.read(p)[1] for p in res["paths"]]
    if len(outs) != 3 or any(o.shape != (8192,) for o in outs):
        raise AssertionError("expected three 8192-sample wavs")
    for o in outs:
        if not (np.isfinite(o).all() and np.abs(o).max() <= 1.0):
            raise AssertionError("non-finite or out-of-range audio")
    if distinct and np.array_equal(outs[0], outs[2]):
        raise AssertionError("'None' speaker output equals p225's")
    per_stream = res["samples"] / 3 / res["seconds"]
    log(f"[{tag}] {dtype} {mode}: {res['seconds']:.3f}s for 3x8192 "
        f"samples: {per_stream:,.0f} samples/s per stream, "
        f"{3 * per_stream:,.0f} aggregate (encode + generate, host "
        f"clock); launches {counts}  ({card})")
    gen = "gen_wavenet_int8" if dtype == "int8" else "gen_wavenet"
    if counts["vq_argmin"] < 1 or counts[gen] < 1:
        raise AssertionError(f"[{tag}] {dtype} {mode}: a kernel of the path "
                             f"was never launched: {counts}")
    return counts


def phase_e2e(card: str):
    """The voice-conversion entry point at full width, through the VQ and
    generation kernels (bf16, int8 and f32 weights); returns the launch
    counts of the main-path runs."""
    from vqvae_wavenet_torch.params import random_params_np, save_npz
    from vqvae_wavenet_torch.config import ModelConfig

    cfg = ModelConfig.from_json(os.path.join(REPO, "model_parameters.json"))
    params, state = random_params_np(cfg, 109, seed=0)
    audio = _e2e_wav()
    ckpt = os.path.join(OUT, "weights-0.npz")
    save_npz(ckpt, params, state)
    launches = {}
    for dtype in ("bf16", "int8", "f32"):
        for mode in ("greedy", "sample"):
            counts = _convert(card, "e2e", ckpt,
                              os.path.join(REPO, "model_parameters.json"),
                              audio, dtype, mode, distinct=True)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    log(f"[e2e] kernel launches in the main-path runs: {launches}")
    return launches


def phase_magenta(card: str):
    """The Magenta family's full preset (magenta_parameters.json: 50
    layers, K=2, R=D=256, S=512, C=64, PK=2 padded to 8, sigmoid_first, a
    per-layer biased global condition) with random weights from a seed and
    the init's 1.0 biases.  Kernel against plain, teacher-forced, 256
    steps, B=3, the local condition drawn from codebook rows and the
    global condition from the speaker table: f32 within 1e-3, bf16 and
    int8 within 5e-2 of max(1, max|logit|).  Times per sample at B=1 and
    B=3 (bf16, int8).  Then the entry point on the e2e wav in bf16 and
    int8, greedy and sample.  Returns the launch counts of those runs."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.ops import gen_kernels as gk
    from vqvae_wavenet_torch.params import random_params_np, save_npz, to_torch
    params_json = os.path.join(REPO, "magenta_parameters.json")
    cfg = ModelConfig.from_json(params_json)
    params, state = random_params_np(cfg, 109, seed=0)
    dec = to_torch(params["decoder"], "cuda")
    wcfg = cfg.wavenet
    g = torch.Generator(device="cpu").manual_seed(4)
    emb = torch.from_numpy(params["vq"]["embedding"])
    lc = emb[torch.randint(0, emb.shape[0], (3, 4), generator=g)].cuda()
    gc = torch.from_numpy(params["speaker_emb"])[[0, 5, 17]][:, None].cuda()
    ws = {}
    for dtype, tol in ((torch.float32, F32_LOGIT_TOL),
                       (torch.bfloat16, BF16_LOGIT_TOL),
                       (torch.int8, BF16_LOGIT_TOL)):
        ws[dtype] = gk.pack_gen_params(dec, wcfg, dtype, "cuda")
        _teacher_forced_check("magenta", dec, ws[dtype], lc, gc,
                              "sigmoid_first", tol, g)
    for b in (1, 3):
        lcb = lc[:b].repeat_interleave(8, dim=1).contiguous()
        row = []
        for dtype in (torch.bfloat16, torch.int8):
            w = ws[dtype]
            gcon, g_pp1 = gk.condition_terms(dec, w, b, gc[:b])
            kern = cuda_ms(lambda: gk.generate_clip_cuda(
                w, lcb, gcon, g_pp1, length=2048,
                gate_order="sigmoid_first"), 2) / 2048
            row.append(f"{str(w.w_a.dtype).split('.')[-1]} "
                       f"{kern * 1e3:.1f} us/sample")
        log(f"[magenta] kernel B={b}: " + ", ".join(row) + f"; packed "
            f"weights {_weight_bytes(ws[torch.bfloat16]) / 1e6:.2f} MB bf16, "
            f"{_weight_bytes(ws[torch.int8]) / 1e6:.2f} MB int8  ({card})")
    del ws, dec
    torch.cuda.empty_cache()

    ckpt = os.path.join(OUT, "magenta", "weights-0.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    save_npz(ckpt, params, state)
    audio = _e2e_wav()
    launches = {}
    for dtype in ("bf16", "int8"):
        for mode in ("greedy", "sample"):
            counts = _convert(card, "magenta", ckpt, params_json, audio,
                              dtype, mode, distinct=False)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    log(f"[magenta] kernel launches in the Magenta runs: {launches}")
    return launches


def _leaf_err(got, ref) -> float:
    """max |got - ref| / max |ref| (float64)."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _check_leaves(tag, dtype, pairs):
    tol = TRAIN_TOL[dtype]
    errs = {k: _leaf_err(a, b) for k, (a, b) in pairs.items()}
    log(f"[{tag}] {dtype}: max |kernel - plain| / max |plain| per leaf: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tolerance {tol})")
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{tag} {dtype}: kernel disagrees with plain: "
                             f"{bad}")
    return max(errs.values())


def _stack_inputs(B, T, F, dtype, gate_gc: bool, seed: int,
                  params_json: str = "model_parameters.json"):
    """Full-width stack operands of the config ``params_json`` (the shipped
    one by default): random decoder layers from a seed, x0 [B, T, R], the
    folded condition lc_encb [L, F, B, 2D] (with a random global
    condition folded in when gate_gc: through the layers' own gc_kernel
    and gc_bias where they have them, the Magenta family), dskip
    [B, T, S].  The conv and residual biases are drawn at random here, so
    that the kernel's per-layer bias reads are checked too."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    cfg = ModelConfig.from_json(os.path.join(REPO, params_json))
    params, _ = random_params_np(cfg, 109, seed)
    lp = to_torch(params["decoder"]["layers"], "cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    lp["bias"] = (torch.randn(lp["bias"].shape, generator=g) * 0.05).cuda()
    lp["res_bias"] = (torch.randn(lp["res_bias"].shape, generator=g)
                      * 0.05).cuda()
    L, _, R, D2 = lp["kernel"].shape
    S = lp["skip_kernel"].shape[2]
    c_lc = lp["lc_kernel"].shape[1]
    lc = (torch.randn((B, F, c_lc), generator=g) * 0.5).cuda()
    lc_encb = torch.einsum("bsc,lcf->lsbf", lc, lp["lc_kernel"]) \
        + lp["bias"][:, None, None, :]
    if gate_gc and "gc_kernel" in lp:
        gc = torch.randn((B, lp["gc_kernel"].shape[1]), generator=g).cuda()
        lc_encb = (lc_encb + torch.einsum("bc,lcf->lbf", gc,
                                          lp["gc_kernel"])[:, None]
                   + lp["gc_bias"][:, None, None, :])
    elif gate_gc:
        gc = torch.randn((B, 16), generator=g).cuda()
        gck = (torch.randn((L, 16, D2), generator=g) * 0.05).cuda()
        lc_encb = lc_encb + torch.einsum("bc,lcf->lbf", gc, gck)[:, None]
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    w = [lp["kernel"].to(dt), lp["skip_kernel"].to(dt),
         lp["res_kernel"].to(dt), lp["res_bias"].to(dt),
         lc_encb.float().contiguous()]
    x0 = (torch.randn((B, T, R), generator=g) * 0.5).to("cuda", dt)
    dskip = (torch.randn((B, T, S), generator=g) * 1e-3).to("cuda", dt)
    return cfg, w, x0, dskip


def _products_matmul_ms(w, x0, dskip, act, xs, dils) -> tuple:
    """The stack's products alone, each as one torch.matmul on operands
    gathered beforehand (the gathers and the epilogues not timed), summed
    over the L layers: the forward's conv [rows, K*R] . [K*R, 2D] and
    skip|res [rows, D] . [D, S+R]; the sweep's dgated [rows, R+S] .
    [R+S, D], dsk|drs [D, rows] . [rows, S+R], dk [K*R, rows] . [rows, 2D]
    and dX [rows, K*2D] . [K*2D, R].  Layer l's weights, and as the
    activation side layer 0's gathered operands for every layer (the same
    shapes).  A yardstick of the products' rate, not a library call for
    either kernel's function.  Returns (forward ms, sweep ms)."""
    kern, skipw, resw = w[0], w[1], w[2]
    L, K, R, D2 = kern.shape
    D, S = D2 // 2, skipw.shape[2]
    B, T = x0.shape[:2]
    N = B * T
    d = dils[0]
    xcol = torch.zeros((B, T, K, R), dtype=x0.dtype, device=x0.device)
    for j in range(K):
        o = (K - 1 - j) * d
        if o < T:
            xcol[:, o:, j] = x0[:, :T - o]
    xcol = xcol.reshape(N, K * R)
    wconv = kern.reshape(L, K * R, D2)
    gated = (act[0, ..., :D] * act[0, ..., D:]).reshape(N, D)
    srw = torch.cat([skipw, resw], dim=2)                     # [L, D, S+R]
    cat = torch.cat([xs[0].reshape(N, R), dskip.reshape(N, S)], dim=1)
    rsk_t = torch.cat([resw, skipw], dim=2).transpose(1, 2).contiguous()
    gated_t = gated.t().contiguous()
    xcol_t = xcol.t().contiguous()
    dpre = act[0].reshape(N, D2)
    dcol = torch.cat([dpre] * K, dim=1)                       # [rows, K*2D]
    kt = kern.permute(0, 1, 3, 2).reshape(L, K * D2, R).contiguous()
    fwd = cuda_ms(lambda: [(xcol @ wconv[l], gated @ srw[l])
                           for l in range(L)], 3)
    bwd = cuda_ms(lambda: [(cat @ rsk_t[l], gated_t @ cat, xcol_t @ dpre,
                            dcol @ kt[l]) for l in range(L)], 3)
    del xcol, gated, cat, gated_t, xcol_t, dcol
    torch.cuda.empty_cache()
    return fwd, bwd


def _stack_edge(card: str) -> None:
    """The forward and the layer sweep against their plain twins at a
    small ragged shape, f32 and bf16: L=3, K=3, R=D=136, S=200 (channel,
    output and k tiles cut by the widths), B=3, T=5,000 (row tiles cut at
    each batch row's end), 100 frames, dilations 1, 7 and 2,600 (layer 2's
    tap 0 shifts by 5,200 >= T and reads only zeros); at start 0
    (tanh_first) and through the sequence-parallel variants at start 1,000
    with the stream output and a dX seed (sigmoid_first).  Every output
    within TRAIN_TOL of its max; at start 0 the chain's outputs bitwise
    equal to the sweep's and its dk pass within TRAIN_TOL of the sweep's
    dk."""
    from vqvae_wavenet_torch.ops import train_kernels as tk
    L, K, R, D, S, B, T, F = 3, 3, 136, 136, 200, 3, 5000, 100
    dils = (1, 7, 2600)
    g = torch.Generator(device="cpu").manual_seed(31)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    for dtype, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        w = [rnd(L, K, R, 2 * D, scale=(K * R) ** -0.5).to("cuda", dt),
             rnd(L, D, S, scale=D ** -0.5).to("cuda", dt),
             rnd(L, D, R, scale=D ** -0.5).to("cuda", dt),
             rnd(L, R, scale=0.05).to("cuda", dt),
             rnd(L, F, B, 2 * D, scale=0.3).cuda()]
        x0 = rnd(B, T, R, scale=0.5).to("cuda", dt)
        dskip = rnd(B, T, S, scale=1e-3).to("cuda", dt)
        dxout = rnd(B, T, R, scale=1e-3).to("cuda", dt)
        for start, gate in ((0, "tanh_first"), (1000, "sigmoid_first")):
            sp = start > 0
            kw = dict(dils=dils, gate_order=gate, start=start, with_xout=sp)
            fk = tk.stack_forward_cuda(*w, x0, **kw)
            fp = tk.stack_forward_plain(*w, x0, **kw)
            names = ["skip_sum", "act[0]"] + (["xout"] if sp else [])
            pairs = [(fk[0], fp[0]), (fk[1][0], fp[1][0])] + (
                [(fk[3], fp[3])] if sp else [])
            tag = f"train-stack edge start={start}"
            _check_leaves(f"{tag} fwd", dtype, dict(zip(names, pairs)))
            bargs = (dskip, fk[1], fk[2], w[0], w[1], w[2], dils, F, gate)
            bkw = dict(start=start, dxout=dxout if sp else None)
            gk = tk.stack_backward_cuda(*bargs, **bkw)
            gp = tk.stack_backward_plain(*bargs, **bkw)
            leaves = ("dk", "dsk", "drs", "drb", "dlc", "dx0")
            _check_leaves(f"{tag} bwd", dtype, dict(zip(leaves, zip(gk, gp))))
            if not sp:
                ck = tk.stack_bwd_chain_cuda(*bargs)
                same = all(torch.equal(a, b) for a, b in zip(ck[1:], gk[1:]))
                dkk = tk.stack_dk_cuda(ck[0], fk[2], dils, K)
                _check_leaves(f"{tag} chain dk vs sweep dk", dtype,
                              {"dk": (dkk, gk[0])})
                log(f"[{tag}] {dtype}: the chain's dsk, drs, drb, dlc, dx0 "
                    f"bitwise equal to the sweep's: {same}")
                if not same:
                    raise AssertionError(f"{tag} {dtype}: chain and sweep "
                                         f"differ")
            del fk, fp, gk, gp
        log(f"[train-stack edge] {dtype} L={L} K={K} R=D={R} S={S} B={B} "
            f"T={T} dilations {dils}, start 0 and 1,000: passed  ({card})")
        del w, x0, dskip, dxout
        torch.cuda.empty_cache()


def _kernel_breakdown(fn) -> dict:
    """Device microseconds per kernel (total, calls) of one call of fn, by
    torch.profiler, kernels named by their problem (the stack's GEMM
    problems of csrc/hopper_gemm.cuh, the reductions)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"gemm<(?:\(anonymous namespace\)::|bwd::)?(\w+)<",
                      e.key) or re.search(r"(?:tg|bwd)::(\w+)", e.key)
        if m and e.device_time_total > 0:
            us, n = out.get(m.group(1), (0.0, 0))
            out[m.group(1)] = (us + e.device_time_total, n + e.count)
    return out


def _bitwise_repeat(tag, dtype, first, again) -> None:
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"[{tag}] {dtype}: two runs on the same inputs bitwise equal: {same}")
    if not same:
        raise AssertionError(f"{tag} {dtype}: does not repeat bit for bit")


def phase_train_stack(card: str):
    """The stack kernels against their plain twins at the shipped widths
    (L=30, K=3, R=D=256, S=512), the full training shape B=8, T=6656 with
    104 frames, f32 and bf16, tanh_first; then B=2, T=1024 with
    sigmoid_first and a folded global condition; then the ragged edge
    shapes of _stack_edge.  The backward twins get the kernel forward's
    saved tensors, so each comparison sees one kernel.  Tolerance per
    leaf, max |kernel - plain| / max |plain|: f32 1e-3 (products summed in
    another order over up to 53,248 rows), bf16 2e-2 (an f32 difference of
    one ulp can round a saved activation or dpre to the neighbouring bf16
    value, 0.4% apart, and that feeds the following layers).  At the full
    shape both kernels run twice on the same inputs and must repeat bit
    for bit, and the products alone are timed as torch.matmul calls
    (_products_matmul_ms).  Returns the JSON fields of both kernels (bf16
    at the full shape)."""
    from vqvae_wavenet_torch.ops import train_kernels as tk
    out = {}
    cases = [(2, 1024, 16, "sigmoid_first", True),
             (8, 6656, 104, "tanh_first", False)]
    for B, T, F, gate, gc in cases:
        for dtype in ("f32", "bf16"):
            cfg, w, x0, dskip = _stack_inputs(B, T, F, dtype, gc, seed=3)
            dils = tuple(cfg.wavenet.dilation_rates)
            kw = dict(dils=dils, gate_order=gate)
            sk, act, xs = tk.stack_forward_cuda(*w, x0, **kw)
            sp, act_p, _ = tk.stack_forward_plain(*w, x0, **kw)
            # act[0]: layer 0's gate outputs from the same x0 on both
            # sides (later layers' inputs differ by the rounding above)
            f_err = _check_leaves("train-stack fwd", dtype, {
                "skip_sum": (sk, sp), "act[0]": (act[0], act_p[0])})
            del act_p
            bargs = (dskip, act, xs, w[0], w[1], w[2])
            gk = tk.stack_backward_cuda(*bargs, dils, F, gate)
            gp = tk.stack_backward_plain(*bargs, dils, F, gate)
            b_err = _check_leaves("train-stack bwd", dtype, dict(zip(
                ("dk", "dsk", "drs", "drb", "dlc", "dx0"), zip(gk, gp))))
            del gp
            if (B, gate) != (8, "tanh_first"):
                del gk
                continue
            _bitwise_repeat("train-stack fwd", dtype, (sk, act, xs),
                            tk.stack_forward_cuda(*w, x0, **kw))
            _bitwise_repeat("train-stack bwd", dtype, gk,
                            tk.stack_backward_cuda(*bargs, dils, F, gate))
            del gk
            torch.cuda.empty_cache()
            L, K, R, D2 = w[0].shape
            D, S, N = D2 // 2, w[1].shape[2], B * T
            f_ms = cuda_ms(lambda: tk.stack_forward_cuda(*w, x0, **kw), 3)
            fp_ms = cuda_ms(lambda: tk.stack_forward_plain(*w, x0, **kw), 2)
            b_ms = cuda_ms(lambda: tk.stack_backward_cuda(
                *bargs, dils, F, gate), 3)
            bp_ms = cuda_ms(lambda: tk.stack_backward_plain(
                *bargs, dils, F, gate), 2)
            fm_ms, bm_ms = _products_matmul_ms(w, x0, dskip, act, xs, dils)
            for name, fn in (
                    ("fwd", lambda: tk.stack_forward_cuda(*w, x0, **kw)),
                    ("bwd", lambda: tk.stack_backward_cuda(*bargs, dils, F,
                                                           gate))):
                parts = _kernel_breakdown(fn)
                log(f"[train-stack] {dtype} {name} per kernel, device us "
                    f"per call (calls), torch.profiler: " + ", ".join(
                        f"{k} {us / n:.1f} ({n})" for k, (us, n) in sorted(
                            parts.items(), key=lambda kv: -kv[1][0])))
            f_flops = 2.0 * N * L * (K * R * D2 + D * (S + R))
            b_flops = 2.0 * N * L * (2 * (R + S) * D + 2 * K * R * D2)
            f_bound = bound(f_flops, nbytes(*w, x0, sk, act, xs), dtype)
            b_bound = bound(b_flops, nbytes(dskip, act, xs, *w[:3])
                            + 4 * (w[0].numel() + w[1].numel()
                                   + w[2].numel() + w[3].numel()
                                   + w[4].numel()) + nbytes(x0), dtype)
            log(f"[train-stack] {dtype} B={B} T={T}: fwd kernel {f_ms:.2f} "
                f"ms (plain {fp_ms:.2f}, bound {f_bound[0]:.2f} by "
                f"{f_bound[1]}, products_matmul_ms {fm_ms:.2f}), bwd kernel "
                f"{b_ms:.2f} ms (plain {bp_ms:.2f}, bound {b_bound[0]:.2f} by "
                f"{b_bound[1]}, products_matmul_ms {bm_ms:.2f}); "
                f"products_matmul_ms: the products alone as torch.matmul "
                f"calls on pre-gathered operands  ({card})")
            if dtype == "bf16":
                out["train_stack_fwd"] = {
                    "max_abs_err": f_err, "ms": f_ms, "plain_ms": fp_ms,
                    "bound_ms": f_bound[0], "bound_by": f_bound[1],
                    "library_ms": None, "products_matmul_ms": fm_ms}
                out["train_stack_bwd"] = {
                    "max_abs_err": b_err, "ms": b_ms, "plain_ms": bp_ms,
                    "bound_ms": b_bound[0], "bound_by": b_bound[1],
                    "library_ms": None, "products_matmul_ms": bm_ms}
            del sk, sp, act, xs
            torch.cuda.empty_cache()
    _stack_edge(card)
    return out


def _shifted_inputs(xs, dils, K: int):
    """[L, K*R, B*T]: for every layer and tap the layer input shifted down
    by o_j = (K-1-j) d_l rows within each batch row (zeros in front),
    transposed: the operand with which one torch.bmm against dpre_all
    [L, B*T, 2D] computes dk (the library yardstick of the dk kernel)."""
    L, B, T, R = xs.shape
    out = torch.zeros((L, K, R, B, T), dtype=xs.dtype, device=xs.device)
    for l, d in enumerate(dils):
        for j in range(K):
            o = (K - 1 - j) * d
            if o < T:
                out[l, j, :, :, o:] = xs[l, :, :T - o].permute(2, 0, 1)
    return out.reshape(L, K * R, B * T)


def _check_forward(tag, dtype, w, x0, dils, gate, sk, act, xs) -> float:
    """The forward kernel's outputs (skip_sum sk, act, xs) against its
    plain twin on the same inputs.  Layer by layer, teacher-forced: the
    twin runs layer l alone from the kernel's own input xs[l], and its act
    and its output (the next layer's input) must lie within TRAIN_TOL of
    the kernel's, so each comparison sees one kernel layer.  skip_sum over
    the whole stack: f32 within TRAIN_TOL of the twin's; bf16 no farther
    from the f32 twin on the same inputs than 1.1x the bf16 twin is (the
    distance-to-f32 rule of [sp-train]): in bf16 an f32 difference of one
    ulp rounds a layer's input to the neighbouring value and that spreads
    through the later layers, in the twin as in the kernel (over 50
    layers past 2e-2 of the max).  Returns the largest error held to
    TRAIN_TOL."""
    from vqvae_wavenet_torch.ops import train_kernels as tk
    tol, L = TRAIN_TOL[dtype], len(dils)
    per_layer = []
    for l in range(L):
        _, a, _, xo = tk.stack_forward_plain(
            *(t[l:l + 1] for t in w[:4]), w[4][l:l + 1].contiguous(), xs[l],
            dils[l:l + 1], gate, with_xout=True)
        per_layer.append((_leaf_err(act[l], a[0]),
                          _leaf_err(xs[l + 1], xo) if l < L - 1 else 0.0))
    e_act, e_x = (max(e[i] for e in per_layer) for i in (0, 1))
    worst = max(range(L), key=lambda l: max(per_layer[l]))
    sp = tk.stack_forward_plain(*w, x0, dils, gate)[0]
    e_skip = _leaf_err(sk, sp)
    msg = (f"[{tag} fwd] {dtype}: per layer from the kernel's own input, "
           f"max |kernel - plain| / max |plain|: act {e_act:.3g}, next "
           f"input {e_x:.3g} (worst layer {worst}, dilation "
           f"{dils[worst]}); skip_sum over {L} layers {e_skip:.3g}")
    bad = [k for k, v in (("act", e_act), ("next input", e_x))
           if not v <= tol]
    if dtype == "f32":
        log(msg + f" (tolerance {tol})")
        bad += ["skip_sum"] if not e_skip <= tol else []
    else:
        s32 = tk.stack_forward_plain(*(t.float() for t in w), x0.float(),
                                     dils, gate)[0]
        k32, p32 = _leaf_err(sk, s32), _leaf_err(sp, s32)
        log(msg + f"; to the f32 twin: kernel {k32:.3g}, bf16 twin "
            f"{p32:.3g} (tolerance {tol}; skip_sum <= 1.1x the twin's "
            f"distance to f32)")
        bad += ["skip_sum"] if not k32 <= 1.1 * p32 else []
        del s32
    del sp
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"{tag} fwd {dtype}: kernel disagrees with "
                             f"plain: {bad}")
    return max(e_act, e_x, e_skip if dtype == "f32" else 0.0)


def _check_dk_edge(card: str) -> None:
    """The dk kernel against its plain twin at a small ragged shape, f32
    and bf16: L=2, K=3, R=D=136 (channel and output tiles cut by the
    width), B=3, T=5000 (64-row tiles cut at each batch row's end; 15,000
    rows in two splits whose boundary falls inside a batch row),
    dilations 1 and 2,600 (tap 0 of layer 1 shifts by 5,200 >= T and
    reads only zeros).  Within TRAIN_TOL of each output's max, and two
    runs bitwise equal."""
    from vqvae_wavenet_torch.ops import train_kernels as tk
    g = torch.Generator(device="cpu").manual_seed(21)
    L, K, R, D, B, T = 2, 3, 136, 136, 3, 5000
    dils = (1, 2600)
    for dtype, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xs = torch.randn((L, B, T, R), generator=g).to("cuda", dt)
        dpre = (torch.randn((L, B, T, 2 * D), generator=g) * 0.1).to("cuda",
                                                                    dt)
        got = tk.stack_dk_cuda(dpre, xs, dils, K)
        again = tk.stack_dk_cuda(dpre, xs, dils, K)
        ref = tk.stack_dk_plain(dpre, xs, dils, K)
        err = _leaf_err(got, ref)
        dead = float(got[1, 0].abs().max())
        log(f"[train-bwd2] dk edge {dtype} L={L} K={K} R=D={R} B={B} "
            f"T={T} dilations {dils}: max |kernel - plain| / max |plain| "
            f"{err:.3g} (tolerance {TRAIN_TOL[dtype]}); the tap shifted by "
            f"{2 * dils[1]} >= T: max |dk| {dead:.3g}; two runs bitwise "
            f"equal: {torch.equal(got, again)}  ({card})")
        if not (err <= TRAIN_TOL[dtype] and dead == 0.0
                and torch.equal(got, again)):
            raise AssertionError(f"dk kernel disagrees at the edge shape "
                                 f"({dtype})")


def phase_train_bwd2(card: str):
    """The two-kernel stack backward (the chain kernel, then the one-launch
    dk kernel) against its plain twins and against the layer sweep
    (train_stack_bwd) on the same inputs, at B=8, T=6656, 104 frames:
    the shipped widths (L=30, K=3, R=D=256, S=512, tanh_first) and the
    Magenta widths (L=50, K=2, dilations 2^(i%10), the per-layer gc folded
    into the condition, sigmoid_first), f32 and bf16.  The forward kernel
    is first held against its plain twin on the same inputs
    (_check_forward); the saved tensors the backwards read come from the
    forward kernel; the dk kernel and its twin read the
    chain kernel's dpre_all, so each comparison sees one kernel.
    Tolerance per output as in [train-stack] (TRAIN_TOL).  Times (CUDA
    events) of the chain, of dk and of the sweep on the same shape, the
    plain twins', the bounds, and as dk's library yardstick one torch.bmm
    of the pre-gathered shifted inputs [L, K*R, B*T] with dpre_all
    [L, B*T, 2D] (the gather not timed); the forward kernel's time on the
    same shape beside them.  Returns the JSON fields of both kernels
    (Magenta, bf16: the shape of the magenta-train path)."""
    from vqvae_wavenet_torch.ops import train_kernels as tk
    _check_dk_edge(card)
    B, T, F = 8, 6656, 104
    out = {}
    for name, params_json, gate in (
            ("shipped", "model_parameters.json", "tanh_first"),
            ("magenta", "magenta_parameters.json", "sigmoid_first")):
        for dtype in ("f32", "bf16"):
            cfg, w, x0, dskip = _stack_inputs(B, T, F, dtype,
                                              name == "magenta", seed=13,
                                              params_json=params_json)
            dils = tuple(cfg.wavenet.dilation_rates)
            L, K, R, D2 = w[0].shape
            D, S, N = D2 // 2, w[1].shape[2], B * T
            sk, act, xs = tk.stack_forward_cuda(*w, x0, dils, gate)
            f_err = _check_forward(f"train-bwd2 {name}", dtype, w, x0,
                                   dils, gate, sk, act, xs)
            del sk
            bargs = (dskip, act, xs, w[0], w[1], w[2], dils, F, gate)
            ck = tk.stack_bwd_chain_cuda(*bargs)
            cp = tk.stack_bwd_chain_plain(*bargs)
            names = ("dpre_all", "dsk", "drs", "drb", "dlc", "dx0")
            c_err = _check_leaves(f"train-bwd2 {name} chain", dtype,
                                  dict(zip(names, zip(ck, cp))))
            del cp
            dkk = tk.stack_dk_cuda(ck[0], xs, dils, K)
            dkp = tk.stack_dk_plain(ck[0], xs, dils, K)
            d_err = _check_leaves(f"train-bwd2 {name} dk", dtype,
                                  {"dk": (dkk, dkp)})
            del dkp
            same = torch.equal(dkk, tk.stack_dk_cuda(ck[0], xs, dils, K))
            log(f"[train-bwd2] {name} {dtype}: dk twice on the same inputs "
                f"bitwise equal: {same}")
            if not same:
                raise AssertionError(f"train-bwd2 {name} {dtype}: dk does "
                                     f"not repeat bit for bit")
            sw = tk.stack_backward_cuda(*bargs)
            _check_leaves(f"train-bwd2 {name} two-kernel vs sweep", dtype,
                          dict(zip(("dk", "dsk", "drs", "drb", "dlc",
                                    "dx0"),
                                   zip((dkk,) + tuple(ck[1:]), sw))))
            del sw
            torch.cuda.empty_cache()
            c_ms = cuda_ms(lambda: tk.stack_bwd_chain_cuda(*bargs), 3)
            cp_ms = cuda_ms(lambda: tk.stack_bwd_chain_plain(*bargs), 2)
            d_ms = cuda_ms(lambda: tk.stack_dk_cuda(ck[0], xs, dils, K), 3)
            dp_ms = cuda_ms(lambda: tk.stack_dk_plain(ck[0], xs, dils, K), 2)
            sw_ms = cuda_ms(lambda: tk.stack_backward_cuda(*bargs), 3)
            f_ms = cuda_ms(lambda: tk.stack_forward_cuda(*w, x0, dils, gate),
                           3)
            gathered = _shifted_inputs(xs, dils, K)
            dpre2 = ck[0].reshape(L, N, D2)
            lib_ms = cuda_ms(lambda: torch.bmm(gathered, dpre2), 3)
            lib_err = _leaf_err(torch.bmm(gathered, dpre2).float(),
                                dkk.reshape(L, K * R, D2))
            del gathered, dpre2
            c_bound = bound(2.0 * N * L * (2 * (R + S) * D + K * D2 * R),
                            nbytes(dskip, act, w[0], w[1], w[2]) + nbytes(
                                *ck), dtype)
            d_bound = bound(2.0 * N * L * K * R * D2,
                            nbytes(ck[0], xs, dkk), dtype)
            log(f"[train-bwd2] {name} {dtype} B={B} T={T} L={L} K={K}: "
                f"forward kernel vs plain {f_err:.3g} of its max; chain "
                f"kernel {c_ms:.2f} ms (plain {cp_ms:.2f}, bound "
                f"{c_bound[0]:.2f} by {c_bound[1]}), dk kernel {d_ms:.2f} "
                f"ms (plain {dp_ms:.2f}, bound {d_bound[0]:.2f} by "
                f"{d_bound[1]}, one torch.bmm of the pre-gathered shifted "
                f"inputs {lib_ms:.2f}, its gather not timed, "
                f"max |bmm - kernel| / max |kernel| {lib_err:.3g}); "
                f"two-kernel total {c_ms + d_ms:.2f} ms against the layer "
                f"sweep {sw_ms:.2f} ms on the same inputs (the forward "
                f"kernel {f_ms:.2f} ms)  ({card})")
            if name == "magenta" and dtype == "bf16":
                out["train_stack_bwd_chain"] = {
                    "max_abs_err": c_err, "ms": c_ms, "plain_ms": cp_ms,
                    "bound_ms": c_bound[0], "bound_by": c_bound[1],
                    "library_ms": None}
                out["train_stack_bwd_dk"] = {
                    "max_abs_err": d_err, "ms": d_ms, "plain_ms": dp_ms,
                    "bound_ms": d_bound[0], "bound_by": d_bound[1],
                    "library_ms": lib_ms}
            del ck, dkk, act, xs, bargs, w, x0, dskip
            torch.cuda.empty_cache()
    return out


def phase_train_epilogue(card: str):
    """The loss-head kernel (forward and backward entries) against its
    plain twin at B=8, T=6656, S=512, Q=256, 104 frames, f32 and bf16; the
    backward twin gets the kernel forward's saved a1 and probs.  The loss
    within 1e-5 (f32) / 1e-3 (bf16) relative, every other leaf as in
    train-stack.  Returns the JSON fields of both entries (bf16)."""
    from vqvae_wavenet_torch.ops import epilogue_kernels as ek
    B, T, F, S, Q = 8, 6656, 104, 512, 256
    N = B * T
    g = torch.Generator(device="cpu").manual_seed(5)
    out = {}
    for dtype in ("f32", "bf16"):
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
        skip = (torch.randn((B, T, S), generator=g) * 0.5).cuda()
        w1 = ((torch.rand((S, S), generator=g) * 2 - 1)
              * (3.0 / S) ** 0.5).to("cuda", dt)
        w2 = ((torch.rand((S, Q), generator=g) * 2 - 1)
              * (3.0 / S) ** 0.5).to("cuda", dt)
        b2 = (torch.randn((Q,), generator=g) * 0.05).cuda()
        enc2 = (torch.randn((F, B, S), generator=g) * 0.1).cuda()
        labels = torch.randint(0, Q, (B, T), generator=g).cuda()
        fwd = (skip, w1, w2, b2, enc2, labels)
        lk, a1, probs = ek.epilogue_forward_cuda(*fwd)
        lp, a1_p, probs_p = ek.epilogue_forward_plain(*fwd)
        l_err = abs(float(lk) - float(lp)) / abs(float(lp))
        log(f"[train-epilogue] {dtype}: loss kernel {float(lk) / N:.6f} "
            f"plain {float(lp) / N:.6f} (relative {l_err:.3g})")
        if not l_err <= (1e-5 if dtype == "f32" else 1e-3):
            raise AssertionError(f"epilogue loss disagrees ({dtype})")
        f_err = max(l_err, _check_leaves("train-epilogue fwd", dtype, {
            "a1": (a1, a1_p), "probs": (probs, probs_p)}))
        gvec = torch.ones((), device="cuda")
        bargs = (gvec, skip, a1, probs, labels, w1, w2, F)
        gk = ek.epilogue_backward_cuda(*bargs)
        gp = ek.epilogue_backward_plain(*bargs)
        b_err = _check_leaves("train-epilogue bwd", dtype, dict(zip(
            ("dskip", "dlc2", "dw1", "dw2", "db2"), zip(gk, gp))))
        f_ms = cuda_ms(lambda: ek.epilogue_forward_cuda(*fwd), 10)
        fp_ms = cuda_ms(lambda: ek.epilogue_forward_plain(*fwd), 5)
        b_ms = cuda_ms(lambda: ek.epilogue_backward_cuda(*bargs), 10)
        bp_ms = cuda_ms(lambda: ek.epilogue_backward_plain(*bargs), 5)
        f_bound = bound(2.0 * N * (S * S + S * Q),
                        nbytes(skip, w1, w2, b2, enc2) + 4 * N
                        + nbytes(a1, probs) + 4, dtype)
        b_bound = bound(2.0 * N * (2 * S * Q + 2 * S * S),
                        nbytes(skip, a1, probs, w1, w2) + 4 * N
                        + nbytes(*gk), dtype)
        log(f"[train-epilogue] {dtype}: fwd kernel {f_ms:.3f} ms (plain "
            f"{fp_ms:.3f}, bound {f_bound[0]:.3f} by {f_bound[1]}), bwd "
            f"kernel {b_ms:.3f} ms (plain {bp_ms:.3f}, bound "
            f"{b_bound[0]:.3f} by {b_bound[1]})  ({card})")
        if dtype == "bf16":
            out["train_epilogue_fwd"] = {
                "max_abs_err": f_err, "ms": f_ms, "plain_ms": fp_ms,
                "bound_ms": f_bound[0], "bound_by": f_bound[1],
                "library_ms": None}
            out["train_epilogue_bwd"] = {
                "max_abs_err": b_err, "ms": b_ms, "plain_ms": bp_ms,
                "bound_ms": b_bound[0], "bound_by": b_bound[1],
                "library_ms": None}
    return out


def _train_corpus() -> str:
    """A synthetic VCTK-layout corpus under build/chip_smoke/train_data:
    the repo's 109-speaker table, three 1 s utterances each for p225 and
    p226 (a sawtooth-rich tone per speaker plus noise)."""
    import shutil
    from scipy.io import wavfile
    root = os.path.join(OUT, "train_data")
    info = os.path.join(root, "vctk_info")
    os.makedirs(info, exist_ok=True)
    shutil.copy(os.path.join(REPO, "data", "vctk_info", "vctk_speakers.txt"),
                info)
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    files = []
    for spk, f0 in (("p225", 180.0), ("p226", 310.0)):
        os.makedirs(os.path.join(root, "VCTK-Corpus", "wav48", spk),
                    exist_ok=True)
        for u in range(3):
            phase = (f0 * (1 + 0.02 * u) * t) % 1.0
            wav = 0.3 * (2 * phase - 1) * (0.6 + 0.4 * np.sin(
                2 * np.pi * 3.0 * t)) + 0.01 * rng.standard_normal(t.size)
            name = f"{spk}/{spk}_{u:03d}.wav"
            wavfile.write(os.path.join(root, "VCTK-Corpus", "wav48", name),
                          16000, (np.clip(wav, -1, 1) * 32767).astype(
                              np.int16))
            files.append(name)
    with open(os.path.join(info, "vctk_train.txt"), "w") as f:
        f.write("\n".join(files) + "\n")
    return root


def phase_train_e2e(card: str):
    """The training entry point at full width and the full training shape
    (model_parameters.json; -length 6656 -batch 8), six steps in f32 and
    six in bf16 (a copy of the config with "train_dtype": "bf16"): finite
    losses, a checkpoint written, the path's kernels launched; steps/s
    from the steps after the first two.  Then the port's generate.py
    converts 2,048 samples for one speaker from the bf16 checkpoint.
    Returns the training kernels' launch counts."""
    from scipy.io import wavfile
    from vqvae_wavenet_torch import generate as gen_cli
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.ops import (epilogue_kernels, train_kernels,
                                         vq_kernels)
    data = _train_corpus()
    configs = {dtype: _train_config(dtype) for dtype in ("f32", "bf16")}
    launches = {}
    ckpt = None
    for dtype in ("f32", "bf16"):
        save = os.path.join(OUT, f"train_{dtype}")
        vq_kernels.launches = 0
        train_kernels.fwd_launches = train_kernels.bwd_launches = 0
        epilogue_kernels.fwd_launches = epilogue_kernels.bwd_launches = 0
        res = train_cli.main([
            "-dataset", "VCTK", "-length", "6656", "-batch", "8", "-step",
            "6", "-save", os.path.join(save, "weights"), "-params",
            configs[dtype], "-data", data, "-device", "cuda", "-log_every",
            "1", "-interval", "1000", "-ckpt_interval", "1000"])
        counts = {"vq_argmin": vq_kernels.launches,
                  "train_stack_fwd": train_kernels.fwd_launches,
                  "train_stack_bwd": train_kernels.bwd_launches,
                  "train_epilogue_fwd": epilogue_kernels.fwd_launches,
                  "train_epilogue_bwd": epilogue_kernels.bwd_launches}
        print()
        steady = res["step_seconds"][2:]
        log(f"[train-e2e] {dtype}: losses "
            + " ".join(f"{v:.4f}" for v in res["losses"])
            + f"; {len(steady) / sum(steady):.3f} steps/s over steps 3-6 "
            f"(host clock, synchronised; first step "
            f"{res['step_seconds'][0]:.2f} s)  ({card})")
        log(f"[train-e2e] {dtype}: kernel launches {counts}")
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"non-finite training loss ({dtype})")
        ckpt = res["path"] + ".npz"
        if not os.path.exists(ckpt):
            raise AssertionError(f"no checkpoint written ({dtype})")
        need = ["vq_argmin", "train_stack_fwd", "train_stack_bwd"]
        if dtype == "bf16":
            need += ["train_epilogue_fwd", "train_epilogue_bwd"]
            launches.update(counts)
        else:
            launches.update({k: counts[k] for k in need})
        if min(counts[k] for k in need) < 1:
            raise AssertionError(f"a kernel of the {dtype} training path "
                                 f"was never launched: {counts}")
    audio = os.path.join(OUT, "train_input.wav")
    t = np.arange(2048) / 16000.0
    wavfile.write(audio, 16000, (0.3 * np.sin(2 * np.pi * 200.0 * t)
                                 * 32767).astype(np.int16))
    res = gen_cli.main(["-restore", ckpt, "-audio", audio, "-speakers",
                        "p226", "-mode", "greedy", "-params",
                        configs["bf16"], "-data", data, "-device", "cuda"])
    if res["audio"].shape != (1, 2048) or not np.isfinite(
            res["audio"]).all():
        raise AssertionError("generation from the trained checkpoint failed")
    log(f"[train-e2e] generated {res['audio'].shape[1]} samples from "
        f"{os.path.basename(ckpt)} in {res['seconds']:.2f} s")
    return launches


def _magenta_config(dtype: str) -> str:
    """build/chip_smoke/magenta_<dtype>.json: magenta_parameters.json with
    "train_dtype": dtype."""
    path = os.path.join(OUT, f"magenta_{dtype}.json")
    with open(os.path.join(REPO, "magenta_parameters.json")) as f:
        mp = json.load(f)
    os.makedirs(OUT, exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(mp, train_dtype=dtype), f)
    return path


def _magenta_fixed_batch_check(card: str):
    """One fixed batch (B=8 x 6656, random weights from a seed, bf16):
    loss and gradients of the Magenta step with BWD_FUSED_DK "off" (the
    two-kernel backward) against "auto" (the layer sweep).  Both compute
    one function with the same rounding points, and only dk sums its rows
    in another blocking, so: loss within rtol 1e-5, every gradient leaf
    within 2e-2 of its largest |value|."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.ops import train_kernels as tk
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    from vqvae_wavenet_torch.training.train_loop import loss_and_grads
    cfg = ModelConfig.from_json(_magenta_config("bf16"))
    params, _ = random_params_np(cfg, 109, seed=SP_SEED)
    p = to_torch(params, "cuda")
    x, y = _fixed_batch(8, "cuda")
    batch = {"x": x, "y": y}
    res = {}
    try:
        for mode in ("auto", "off"):
            tk.BWD_FUSED_DK = mode
            loss, _, grads = loss_and_grads(p, {}, cfg, batch)
            res[mode] = (float(loss), grads)
    finally:
        tk.BWD_FUSED_DK = "auto"
    rel = abs(res["off"][0] - res["auto"][0]) / abs(res["auto"][0])
    errs = [_leaf_err(a, b) for a, b in zip(res["off"][1], res["auto"][1])
            if b is not None]
    worst = int(np.argmax(errs))
    log(f"[magenta-train] fixed batch bf16: loss off {res['off'][0]:.6f} "
        f"auto {res['auto'][0]:.6f} (relative {rel:.3g}); {len(errs)} "
        f"gradient leaves, max |off - auto| / max |auto| {errs[worst]:.3g} "
        f"(leaf {worst})  ({card})")
    if not (rel <= 1e-5 and errs[worst] <= 2e-2):
        raise AssertionError("magenta-train: the two-kernel backward's "
                             "step disagrees with the layer sweep's")


def phase_magenta_train(card: str):
    """The Magenta family's training entry point at its full preset
    (magenta_parameters.json: 50 layers, K=2, R=D=256, S=512) and the full
    training shape (-length 6656 -batch 8), six steps each on the
    synthetic corpus of [train-e2e]: f32 and bf16 with the default
    backward (the layer sweep), and bf16 with
    train_kernels.BWD_FUSED_DK = "off" (the two-kernel backward), reset
    to "auto" after.  The counters are set to 0 before each run and read
    after: every run launches the VQ and stack forward kernels, the
    default runs the sweep, the "off" run the chain and dk kernels and
    not the sweep.  Finite losses, the loss at step 6 below the loss at
    step 1, a checkpoint; steps/s over steps 3-6.  Then generate -params
    magenta_parameters.json converts 2,048 samples from the bf16
    checkpoint, and the fixed-batch check above.  Returns the chain and
    dk kernels' launches in the "off" run."""
    from scipy.io import wavfile
    from vqvae_wavenet_torch import generate as gen_cli
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.ops import train_kernels as tk
    from vqvae_wavenet_torch.ops import vq_kernels
    data = _train_corpus()
    launches = {}
    ckpt = None
    for dtype, mode in (("f32", "auto"), ("bf16", "auto"), ("bf16", "off")):
        save = os.path.join(OUT, f"magenta_train_{dtype}_{mode}")
        vq_kernels.launches = 0
        tk.fwd_launches = tk.bwd_launches = 0
        tk.chain_launches = tk.dk_launches = 0
        tk.BWD_FUSED_DK = mode
        try:
            res = train_cli.main([
                "-dataset", "VCTK", "-length", "6656", "-batch", "8",
                "-step", "6", "-save", os.path.join(save, "weights"),
                "-params", _magenta_config(dtype), "-data", data,
                "-device", "cuda", "-log_every", "1", "-interval", "1000",
                "-ckpt_interval", "1000"])
        finally:
            tk.BWD_FUSED_DK = "auto"
        counts = {"vq_argmin": vq_kernels.launches,
                  "train_stack_fwd": tk.fwd_launches,
                  "train_stack_bwd": tk.bwd_launches,
                  "train_stack_bwd_chain": tk.chain_launches,
                  "train_stack_bwd_dk": tk.dk_launches}
        print()
        steady = res["step_seconds"][2:]
        log(f"[magenta-train] {dtype} BWD_FUSED_DK={mode}: losses "
            + " ".join(f"{v:.4f}" for v in res["losses"])
            + f"; {len(steady) / sum(steady):.3f} steps/s over steps 3-6 "
            f"(host clock, synchronised; first step "
            f"{res['step_seconds'][0]:.2f} s)  ({card})")
        log(f"[magenta-train] {dtype} {mode}: kernel launches {counts}")
        losses = res["losses"]
        if len(losses) != 6 or not np.isfinite(losses).all() \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"magenta-train {dtype} {mode}: losses "
                                 f"not finite or not falling: {losses}")
        if not os.path.exists(res["path"] + ".npz"):
            raise AssertionError(f"no checkpoint written ({dtype} {mode})")
        need = ["vq_argmin", "train_stack_fwd"]
        if mode == "auto":
            need.append("train_stack_bwd")
            idle = ["train_stack_bwd_chain", "train_stack_bwd_dk"]
            if dtype == "bf16":
                ckpt = res["path"] + ".npz"
        else:
            need += ["train_stack_bwd_chain", "train_stack_bwd_dk"]
            idle = ["train_stack_bwd"]
            launches = {k: counts[k] for k in
                        ("train_stack_bwd_chain", "train_stack_bwd_dk")}
        if min(counts[k] for k in need) < 1 or max(counts[k]
                                                   for k in idle) > 0:
            raise AssertionError(f"magenta-train {dtype} {mode}: the "
                                 f"launches do not fit the path: {counts}")
    audio = os.path.join(OUT, "magenta_train_input.wav")
    t = np.arange(2048) / 16000.0
    wavfile.write(audio, 16000, (0.3 * np.sin(2 * np.pi * 200.0 * t)
                                 * 32767).astype(np.int16))
    res = gen_cli.main(["-restore", ckpt, "-audio", audio, "-speakers",
                        "p226", "-mode", "greedy", "-params",
                        os.path.join(REPO, "magenta_parameters.json"),
                        "-data", data, "-device", "cuda"])
    if res["audio"].shape != (1, 2048) or not np.isfinite(
            res["audio"]).all():
        raise AssertionError("generation from the Magenta checkpoint failed")
    log(f"[magenta-train] generated {res['audio'].shape[1]} samples from "
        f"{os.path.basename(ckpt)} in {res['seconds']:.2f} s")
    _magenta_fixed_batch_check(card)
    return launches


def phase_sp_stack(card: str):
    """The stack kernels' SP variants against their plain twins on one
    dilation cycle (layers 0-9, dilations 1-512) of the 2-rank shape:
    B=8, T_ext = 3,328 + 2,048 = 5,376 rows, 84 frames; start 0 (rank 1)
    and 2,048 (rank 0), the stream output and a random dxout; f32 and bf16,
    tanh_first.  Tolerances as in [train-stack].  Rows before the start
    must be exactly zero in skip, act, xout and dx0.  Times (bf16 and f32,
    start 0: every row is needed) beside the plain kernels' on the same
    shape.  Returns the JSON fields of both (bf16)."""
    from vqvae_wavenet_torch.ops import train_kernels as tk
    B, T, F, lg = 8, 5376, 84, 10
    out = {}
    for dtype in ("f32", "bf16"):
        cfg, w, x0, dskip = _stack_inputs(B, T, F, dtype, False, seed=11)
        w = [t[:lg].contiguous() for t in w]
        dils = tuple(cfg.wavenet.dilation_rates[:lg])
        g = torch.Generator(device="cpu").manual_seed(12)
        dxout = (torch.randn(x0.shape, generator=g) * 1e-3).to("cuda",
                                                                x0.dtype)
        errs = {}
        for start in (0, 2048):
            kw = dict(dils=dils, start=start, with_xout=True)
            fk = tk.stack_forward_cuda(*w, x0, **kw)
            fp = tk.stack_forward_plain(*w, x0, **kw)
            names = ("skip_sum", "act", "xs", "xout")
            for name, a in zip(names, fk):
                head = a[:, :, :start] if a.dim() == 4 else a[:, :start]
                if name == "xs":
                    head = head[1:]               # xs[0] = x0 as given
                if head.numel() and not bool((head == 0).all()):
                    raise AssertionError(f"sp-stack {dtype}: {name} rows "
                                         f"before start {start} not zero")
            f_err = _check_leaves(f"sp-stack fwd start={start}", dtype, {
                "skip_sum": (fk[0][:, start:], fp[0][:, start:]),
                "xout": (fk[3][:, start:], fp[3][:, start:]),
                "act[0]": (fk[1][0], fp[1][0])})
            del fp
            bargs = (dskip, fk[1], fk[2], w[0], w[1], w[2])
            bkw = dict(start=start, dxout=dxout)
            gk = tk.stack_backward_cuda(*bargs, dils, F, **bkw)
            gp = tk.stack_backward_plain(*bargs, dils, F, **bkw)
            if start and not bool((gk[5][:, :start] == 0).all()):
                raise AssertionError(f"sp-stack {dtype}: dx0 rows before "
                                     f"start {start} not zero")
            b_err = _check_leaves(f"sp-stack bwd start={start}", dtype, dict(
                zip(("dk", "dsk", "drs", "drb", "dlc", "dx0"), zip(gk, gp))))
            errs[start] = (f_err, b_err)
            del fk, gk, gp
        # times at start 0 (rank 1's group: every row is needed), the SP
        # variant and the plain kernel on the same shape, in turns
        kw = dict(dils=dils, start=0, with_xout=True)
        sk, act, xs, _ = tk.stack_forward_cuda(*w, x0, **kw)
        bargs = (dskip, act, xs, w[0], w[1], w[2])
        f_ms = cuda_ms(lambda: tk.stack_forward_cuda(*w, x0, **kw), 3)
        f0_ms = cuda_ms(lambda: tk.stack_forward_cuda(*w, x0, dils), 3)
        fp_ms = cuda_ms(lambda: tk.stack_forward_plain(*w, x0, **kw), 2)
        b_ms = cuda_ms(lambda: tk.stack_backward_cuda(
            *bargs, dils, F, dxout=dxout), 3)
        b0_ms = cuda_ms(lambda: tk.stack_backward_cuda(*bargs, dils, F), 3)
        bp_ms = cuda_ms(lambda: tk.stack_backward_plain(
            *bargs, dils, F, dxout=dxout), 2)
        L, K, R, D2 = w[0].shape
        D, S, N = D2 // 2, w[1].shape[2], B * T
        f_bound = bound(2.0 * N * L * (K * R * D2 + D * (S + R)),
                        nbytes(*w, x0, sk, act, xs) + nbytes(x0), dtype)
        b_bound = bound(2.0 * N * L * (2 * (R + S) * D + 2 * K * R * D2),
                        nbytes(dskip, dxout, act, xs, *w[:3])
                        + 4 * sum(t.numel() for t in w) + nbytes(x0), dtype)
        log(f"[sp-stack] {dtype} B={B} T_ext={T} {lg} layers, start 0 + "
            f"xout: fwd kernel {f_ms:.2f} ms (plain kernel without the "
            f"variants {f0_ms:.2f}, plain twin {fp_ms:.2f}, bound "
            f"{f_bound[0]:.2f} by {f_bound[1]}), bwd kernel {b_ms:.2f} ms "
            f"(without the variants {b0_ms:.2f}, plain twin {bp_ms:.2f}, "
            f"bound {b_bound[0]:.2f} by {b_bound[1]})  ({card})")
        if dtype == "bf16":
            out["train_stack_fwd_sp"] = {
                "max_abs_err": max(e[0] for e in errs.values()), "ms": f_ms,
                "plain_ms": fp_ms, "bound_ms": f_bound[0],
                "bound_by": f_bound[1], "library_ms": None}
            out["train_stack_bwd_sp"] = {
                "max_abs_err": max(e[1] for e in errs.values()), "ms": b_ms,
                "plain_ms": bp_ms, "bound_ms": b_bound[0],
                "bound_by": b_bound[1], "library_ms": None}
        del sk, act, xs, bargs, w, x0, dskip, dxout
        torch.cuda.empty_cache()
    return out


def _train_config(dtype: str) -> str:
    """build/chip_smoke/model_<dtype>.json: model_parameters.json with
    "train_dtype": dtype and an absolute wavenet_parameters path (written
    once; the ranks read the file the parent wrote)."""
    path = os.path.join(OUT, f"model_{dtype}.json")
    if not os.path.exists(path):
        with open(os.path.join(REPO, "model_parameters.json")) as f:
            mp = json.load(f)
        mp["wavenet_parameters"] = os.path.join(REPO,
                                                "wavenet_parameters.json")
        os.makedirs(OUT, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(dict(mp, train_dtype=dtype), f)
        os.replace(tmp, path)
    return path


def _fixed_batch(B: int, device):
    """B random 6,656-sample clips (x [B, 6656, 1]) and speaker one-hots
    (y [B, 1, 109]) from SP_SEED, the same in every process."""
    rng = np.random.default_rng(SP_SEED)
    x = (0.5 * np.sin(np.cumsum(rng.uniform(0.01, 0.2, (B, 6656)), axis=1))
         + 0.05 * rng.standard_normal((B, 6656))).astype(np.float32)
    y = np.zeros((B, 1, 109), np.float32)
    y[np.arange(B), 0, rng.integers(0, 109, B)] = 1.0
    return (torch.from_numpy(x[..., None]).to(device),
            torch.from_numpy(y).to(device))


def _sp_case(B: int, dtype: str, device):
    """The [sp-train] inputs, the same in every process: the shipped config
    (train_dtype ``dtype``) with random weights from SP_SEED and every bias
    raised by 0.05 (so that a wrong causal pad at a shard boundary shows),
    a batch of B random 6,656-sample clips and speakers."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    cfg = ModelConfig.from_json(_train_config(dtype))
    params, state = random_params_np(cfg, 109, seed=SP_SEED)

    def bump(tree, name=""):
        if isinstance(tree, dict):
            return {k: bump(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [bump(v) for v in tree]
        return tree + np.float32(0.05) if "bias" in name else tree
    return (cfg, to_torch(bump(params), device), to_torch(state, device),
            *_fixed_batch(B, device))


def _host_ms(fn, device) -> float:
    """Host milliseconds of one call of fn, synchronised on both sides."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def _sp_grads_rank(sh, B: int, dtypes):
    """One rank of [sp-train]'s comparison: per train_dtype the SP loss
    and, on rank 0, the gradients (numpy) of the fixed batch; then, warm,
    the host ms of one more loss-and-gradients call and of the gradient
    sum over the ranks alone (one all_reduce of as many floats)."""
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.parallel.comm import all_reduce_
    from vqvae_wavenet_torch.parallel.timeshard import sp_loss_and_grads
    set_full_f32()
    out = {}
    for dtype in dtypes:
        cfg, p, s, x, y = _sp_case(B, dtype, sh.device)
        t_l = x.shape[1] // sh.world
        batch = {"x": x[:, sh.rank * t_l:(sh.rank + 1) * t_l].contiguous(),
                 "y": y}
        loss, _, grads = sp_loss_and_grads(p, s, cfg, batch, sh)
        flat = torch.zeros((sum(g.numel() for g in grads),),
                           device=sh.device)
        out[dtype] = (float(loss), [g.float().cpu().numpy() for g in grads]
                      if sh.rank == 0 else None,
                      _host_ms(lambda: sp_loss_and_grads(p, s, cfg, batch,
                                                         sh), sh.device),
                      _host_ms(lambda: all_reduce_(flat, sh), sh.device),
                      flat.numel())
        del grads, flat
    out["backend"] = sh.backend
    return out


def _check_sp_grads(tag, dtype, got, ref, ref32=None) -> float:
    """f32: every leaf within 5e-3 of the largest |gradient| of any leaf.
    (JAX's own rule, 5e-3 of each leaf's largest, misses on the encoder's
    conv leaves at this batch: their gradients jump when a rounding-level
    change flips a relu; on the CPU, scaling the input by 1 + 1e-6 moves
    them by 0.67 of that rule at B=2.  The share of it is printed.)
    bf16: rel L2 < 5e-2 or abs L2 < 1e-2 of the global norm (JAX,
    tests/test_timeshard.py:380-392) against the single-device bf16
    gradient ``ref``, or else no further from the f32 gradient ``ref32``
    than ``ref`` is, within 10% (tests/test_torch_sp_train.py).  Prints the
    five leaves nearest the bound; returns the largest share of it."""
    ref = [r.double().numpy() for r in ref]
    gmax = max(np.abs(r).max() for r in ref)
    gn = np.sqrt(sum(float(np.sum(r * r)) for r in ref))
    rows, second = [], []
    for i, (g, r) in enumerate(zip(got, ref)):
        g = np.asarray(g, np.float64)
        if dtype == "f32":
            err = np.abs(g - r).max()
            ratio = err / (5e-3 * gmax)
            note = err / max(np.abs(r).max(), 1e-4 * gmax) / 5e-3
        else:
            nd = np.linalg.norm(g - r)
            ratio = min(nd / (np.linalg.norm(r) + 1e-12) / 5e-2,
                        nd / (1e-2 * gn))
            note = ratio
            if ratio >= 1:
                r32 = ref32[i].double().numpy()
                q = np.linalg.norm(g - r32) / np.linalg.norm(r - r32)
                second.append((i, r.shape, q))
                if q <= 1.1:
                    ratio = 0.0
        rows.append((ratio, note, i, r.shape))
    rows.sort(key=lambda t: -t[0])
    log(f"[{tag}] {dtype}: {len(rows)} gradient leaves, largest share of "
        f"the bound (of JAX's per-leaf rule): "
        + ", ".join(f"leaf {i} {tuple(sh)} {q:.3g} ({n:.3g})"
                    for q, n, i, sh in rows[:5])
        + (f"; held by their distance to f32 (SP / single device): "
           + ", ".join(f"leaf {i} {tuple(sh)} {q:.3f}"
                       for i, sh, q in second) if second else ""))
    if rows[0][0] >= 1:
        raise AssertionError(f"{tag} {dtype}: SP gradients disagree with "
                             f"the single device: {rows[:5]}")
    return rows[0][0]


def phase_sp_train(card: str):
    """Sequence-parallel training of the shipped config.
    (a) The 2-rank SP loss and gradients (two ranks on this one GPU, gloo)
        against the single-device port's loss_and_grads on one fixed
        batch and weights (_sp_case, B=8 x 6656): f32 loss within rtol
        2e-4, bf16 within 2e-2, gradients by _check_sp_grads.  The CPU
        tests hold the same functions to JAX's per-leaf rules at small
        shapes.
    (b) 4 ranks at B=2 (T_l = 1,664 < the 2,048-row group halo: two hops,
        starts 2,048 / 384 / 0 / 0), f32, the same checks.
    (c) vqvae_wavenet_torch.train -time_shards 2 for six steps in f32 and
        in bf16 at B=8 x 6656 on the synthetic corpus: finite losses, rank
        0's checkpoint, and every rank launched both SP kernels and the VQ
        kernel; then generate from the bf16 checkpoint.
    Returns the SP kernels' launches in (c), summed over ranks and runs."""
    from scipy.io import wavfile
    from vqvae_wavenet_torch import generate as gen_cli
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.parallel import pick_backend, run_ranks
    from vqvae_wavenet_torch.training.train_loop import loss_and_grads

    for world, B, dtypes in ((2, 8, ("f32", "bf16")), (4, 2, ("f32",))):
        ref = {}
        for dtype in dtypes:
            cfg, p, s, x, y = _sp_case(B, dtype, "cuda")
            loss, _, grads = loss_and_grads(p, s, cfg, {"x": x, "y": y})
            ref[dtype] = (float(loss), [g.float().cpu() for g in grads])
            del p, s, grads
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = run_ranks(_sp_grads_rank, world, "cuda", B, dtypes,
                        timeout=600)
        secs = time.perf_counter() - t0
        for dtype in dtypes:
            losses = [r[dtype][0] for r in res]
            rel = abs(losses[0] - ref[dtype][0]) / abs(ref[dtype][0])
            _, _, ms, sum_ms, n = res[0][dtype]
            log(f"[sp-train] {world} ranks B={B} {dtype}: loss "
                f"{losses[0]:.6f} on every rank {len(set(losses)) == 1}, "
                f"single device {ref[dtype][0]:.6f} (relative {rel:.3g}); "
                f"{secs:.1f} s for the spawned run; warm, rank 0: loss and "
                f"gradients {ms:.1f} ms, of it the gradient sum "
                f"({n:,} floats, {res[0]['backend']}) alone {sum_ms:.1f} ms "
                f"(host clock)  ({card})")
            if len(set(losses)) != 1 or not rel <= (2e-4 if dtype == "f32"
                                                     else 2e-2):
                raise AssertionError(f"sp-train {world} ranks {dtype}: loss "
                                     f"disagrees")
            _check_sp_grads(f"sp-train {world} ranks", dtype,
                            res[0][dtype][1], ref[dtype][1], ref["f32"][1])
        del res, ref

    data = _train_corpus()
    layout = ("a GPU per rank, NCCL" if pick_backend(2, "cuda") == "nccl"
              else "both ranks on one GPU, gloo")
    launches = {"train_stack_fwd_sp": 0, "train_stack_bwd_sp": 0}
    ckpt = None
    for dtype in ("f32", "bf16"):
        save = os.path.join(OUT, f"sp_train_{dtype}")
        res = train_cli.main([
            "-dataset", "VCTK", "-length", "6656", "-batch", "8", "-step",
            "6", "-save", os.path.join(save, "weights"), "-params",
            _train_config(dtype), "-data", data,
            "-device", "cuda", "-log_every", "1", "-interval", "1000",
            "-ckpt_interval", "1000", "-time_shards", "2"])
        print()
        steady = res["step_seconds"][2:]
        log(f"[sp-train] CLI -time_shards 2 {dtype}: losses "
            + " ".join(f"{v:.4f}" for v in res["losses"])
            + f"; {len(steady) / sum(steady):.3f} steps/s over steps 3-6 "
            f"(host clock, synchronised; first step "
            f"{res['step_seconds'][0]:.2f} s; {layout})  ({card})")
        log(f"[sp-train] {dtype}: kernel launches per rank {res['launches']}")
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"non-finite SP training loss ({dtype})")
        for r in res["launches"]:
            if min(r["train_stack_fwd_sp"], r["train_stack_bwd_sp"],
                   r["vq_argmin"]) < 1:
                raise AssertionError(f"a kernel of the SP path was never "
                                     f"launched in a rank: {r}")
            for k in launches:
                launches[k] += r[k]
        ckpt = res["path"] + ".npz"
        if not os.path.exists(ckpt):
            raise AssertionError(f"no SP checkpoint written ({dtype})")
    audio = os.path.join(OUT, "sp_input.wav")
    t = np.arange(2048) / 16000.0
    wavfile.write(audio, 16000, (0.3 * np.sin(2 * np.pi * 200.0 * t)
                                 * 32767).astype(np.int16))
    res = gen_cli.main(["-restore", ckpt, "-audio", audio, "-speakers",
                        "p226", "-mode", "greedy", "-params",
                        _train_config("bf16"), "-data", data,
                        "-device", "cuda"])
    if res["audio"].shape != (1, 2048) or not np.isfinite(
            res["audio"]).all():
        raise AssertionError("generation from the SP checkpoint failed")
    log(f"[sp-train] generated {res['audio'].shape[1]} samples from "
        f"{os.path.basename(ckpt)} in {res['seconds']:.2f} s")
    return launches


PHASES = ("vq", "gen", "gen-int8", "e2e", "magenta", "train-stack",
          "train-epilogue", "train-e2e", "sp-stack", "sp-train",
          "train-bwd2", "magenta-train")


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", nargs="+", choices=PHASES, default=None,
                        help="run only these phases (after device and "
                             "build) and print no kernels' record")
    only = parser.parse_args(argv).only
    card = phase_device()
    sys.path.insert(0, REPO)
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    set_full_f32()
    phase_build()
    if only is not None:
        runs = {"vq": phase_vq, "gen": lambda: phase_gen(card),
                "gen-int8": lambda: phase_gen_int8(card),
                "e2e": lambda: phase_e2e(card),
                "magenta": lambda: phase_magenta(card),
                "train-stack": lambda: phase_train_stack(card),
                "train-epilogue": lambda: phase_train_epilogue(card),
                "train-e2e": lambda: phase_train_e2e(card),
                "sp-stack": lambda: phase_sp_stack(card),
                "sp-train": lambda: phase_sp_train(card),
                "train-bwd2": lambda: phase_train_bwd2(card),
                "magenta-train": lambda: phase_magenta_train(card)}
        for name in only:
            runs[name]()
        log(f"[only] {' '.join(only)}: passed")
        return 0
    vq = phase_vq()
    gen = phase_gen(card)
    gen8 = phase_gen_int8(card)
    launches = phase_e2e(card)
    magenta = phase_magenta(card)
    train = {**phase_train_stack(card), **phase_train_epilogue(card),
             **phase_sp_stack(card), **phase_train_bwd2(card)}
    train_launches = {**phase_train_e2e(card), **phase_sp_train(card),
                      **phase_magenta_train(card)}
    kernels = [
        {"name": "vq_argmin", "route": "cuda", "source": VQ_SOURCE,
         "replaces": VQ_REPLACES, "launches": launches["vq_argmin"], **vq},
        {"name": "gen_wavenet", "route": "cuda", "source": GEN_SOURCE,
         "replaces": GEN_REPLACES, "launches": launches["gen_wavenet"],
         **gen},
        {"name": "gen_wavenet_int8", "route": "cuda", "source": GEN_SOURCE,
         "replaces": GEN_REPLACES,
         "launches": magenta["gen_wavenet_int8"], **gen8},
    ] + [{"name": name, "route": "cuda", "source": src, "replaces": rep,
          "launches": train_launches[name], **train[name]}
         for name, (src, rep) in TRAIN.items()]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
