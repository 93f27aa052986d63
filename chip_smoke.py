#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  torch/CUDA versions and the card's name and power limit;
  2. build   compile the six sources under vqvae_wavenet_torch/csrc with
             nvcc, one process each, all at once (ptxas registers/spills
             of the generation and training kernels are printed);
  3. vq      the VQ kernel against its plain twin at N = 384 (generation),
             832 (training: B=8 x 104 frames) and 65,536 (k = 512, d = 64),
             its device time (torch.profiler) beside the bound, and exact
             ties (equal codes: the lower index);
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
             plain twin at the same shape and at B=3, T=4416 (a half-empty
             last row tile), f32 and bf16; two runs bitwise equal, the
             device time per kernel (torch.profiler);
  10. train-e2e      the training entry point (vqvae_wavenet_torch.train)
             at -length 6656 -batch 8 on a synthetic VCTK-layout corpus
             with the shipped config in f32 and in bf16, six steps each,
             then vqvae_wavenet_torch.generate from the bf16 checkpoint;
             the launch counters are reset before each run and read after;
  11. sp-stack  the stack kernels' sequence-parallel variants (start
             offset, stream output, dX seed) against their plain twins on
             one dilation cycle of the 2-rank shape (B=8, T_ext=5,376 =
             3,328 + a 2,048-row halo, 84 frames), start 0 and 2,048, f32
             and bf16, and at the Magenta cycle with a global condition and
             sigmoid_first (T_ext 4,352) and Encoder_2019's shard (T_ext
             5,440, 64 mod 128, 320-row frames); times beside the plain
             kernels' on the first shape;
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
  15. encoders  Encoder_2019 and Encoder_Magenta: the loss head at the
             2019 encoder's 320-row frames (B=8, T=6,400, F=20) and at two
             ragged shapes (B=3, T=6,080, F=19; B=2, T=6,400, F=64: 100
             rows a frame) against its plain twin in f32 and bf16, bitwise
             repeats, device times beside FR=64 in one run;
             vqvae_wavenet_torch.train six steps each with the 2019
             encoder (-length 6400) in f32 and bf16 and the Magenta
             encoder (-length 6656) in bf16; generate from the
             2019 bf16 checkpoint on the 8,192-sample wav (ratio 315, the
             last 2 samples read the last frame) in bf16 and int8, greedy
             and sample; the generation kernel teacher-forced at ratio 315
             against its twin;
  16. prior  vqvae_wavenet_torch.prior over a random full-width VQ-VAE:
             20 training steps at -batch 8 -length 6656 in f32 and bf16
             (NLL, code perplexity, steps/s), then -sample 4 -seconds 1.0
             through the generation kernel (samples/s).
  17. dp     data parallelism: 2 ranks on this card (gloo, staged through
             host memory) at a global B=8 x 6656: the DP loss, summed
             gradients and new batch-norm statistics against the
             single-device step on the whole batch, f32 and bf16; the
             prior's 2-rank step against its single-device step; four bf16
             steps through the training CLI's own rank function; then
             generate_sharded over [cuda:0, cuda:0] at B=4 (bf16 and int8
             sample mode: each shard bit for bit its single-device call;
             f32 greedy against the full-batch call) and the generation
             CLI with -data_shards = the device count; with two or more
             cards, the sharded call over every card timed warm beside one
             card's, and DP training over NCCL at 2 ranks and at the card
             count (steps/s).
  18. sp-mesh  the rest of sequence parallelism against the single-device
             step at B=8: the data 2 x time 2 mesh (4 ranks), the 'layer'
             and 'recompute' decoder halos, the Magenta family's preset,
             Encoder_Magenta, Encoder_2019 (bf16, f32 encoder), group norm
             and the EMA codebook on 2 ranks, every rank's kernel launches;
             then the training CLI with -time_shards 2 on the Magenta preset
             (and generate from its checkpoint) and with -decoder_halo
             layer; with four cards the mesh runs over NCCL and the CLI
             on every card (steps/s).
  19. profile  the training CLI in bf16 at B=8 x 6656 for 16 steps with
             -profile: the trace of steps 10-14 read back into device ms a
             step by port kernel, cuBLAS/cuDNN, elementwise and other
             kernels, the optimizer's kernels and copies, the device's
             idle share of the step, and the largest kernels outside the
             port's.
  20. train-cond  the training CLI with "condition_upsample" and
             "time_jitter" (the condition at one frame a sample through
             the stack and loss-head kernels), six steps in f32 and bf16:
             the loss falls, lc_encb's bytes, the step's ms and peak
             memory; generate from the bf16 checkpoint;
  21. q512   quantization_channels 512: six bf16 training steps (the loss
             head over 256-column chunks), then the generation kernel at
             Q=512 against its twin (teacher-forced bf16, greedy f32) and
             generate from the checkpoint;
  22. standalone  the standalone WaveNet trainer at the shipped decoder
             widths, B=8 x 6656, f32, with lc [8, 104, 128] and without:
             a step, and its loss and gradients against the plain twin;
  23. summaries  one -interval write of the training CLI read back from
             its event file (tags; each histogram's count its array's
             size); [dp] reads rank 0's write of a 2-rank run;
  24. visualise  python -m vqvae_wavenet_torch.visualise on [e2e]'s .npy
             files;
  25. tp     tensor parallelism at B=8 x 6656: data 1 x model 2 in f32
             and bf16 and data 2 x model 2 in bf16 (ranks on this card
             over gloo) against the single-device step (loss, gradients,
             the update, batch-norm statistics), whole leaves bit for bit
             equal on every rank after three steps, the ranks' launches
             (the forward kernel at S = 256), the stack forward at S =
             256 against its twin and timed beside S = 512, the train
             state's bytes a rank; over NCCL with two or four cards;
  26. dryrun vqvae_wavenet_torch.dryrun.dryrun_multichip(8): the JAX
             dryrun's six rows on eight ranks.
The training CLI's default -loader auto reads the synthetic
16 kHz PCM16 corpus with the native C++ loader; [train-e2e] runs its bf16
steps with -loader native and again with -loader python (steps/s side by
side), and [train-epilogue] adds the loss head at F = T (one frame a
sample) and at Q = 512 and 1,024.
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
# the SP phases' cases: name -> (model_parameters.json overrides, or None
# for the Magenta family's magenta_parameters.json; samples a clip)
MESH_CASES = {"shipped": ({}, 6656),
              "magenta_enc": ({"encoder": "Magenta"}, 6656),
              "2019": ({"encoder": "2019"}, 6400),
              "group": ({"encoder_norm": "group"}, 6656),
              "ema": ({"vq_mode": "ema"}, 6656),
              "magenta": (None, 6656)}


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


def _vq_ties(vk, emb, g) -> None:
    """Exact ties: codes 300, 67 and 6 are copies of codes 100, 3 and 5 (in
    another warp, the same thread, a neighbouring lane of the kernel's
    code tile); rows near the lower code of each pair must get the lower
    index from the kernel and the plain twin alike, through both row
    groupings (8 rows at N = 384, 32 at N = 8,448)."""
    emb = emb.clone()
    pairs = ((100, 300), (3, 67), (5, 6))
    for lo, hi in pairs:
        emb[hi] = emb[lo]
    for n in (384, 8448):
        lows = torch.tensor([lo for lo, _ in pairs]).repeat(n // 3)
        z = (emb[lows.cuda()] + 1e-3 * torch.randn(
            (n, emb.shape[1]), generator=g).cuda())
        got = vk.vq_nearest_cuda(z, emb).cpu()
        ref = vk.vq_nearest_plain(z, emb).cpu()
        log(f"[vq] exact ties N={n} (codes {pairs} equal): kernel returns "
            f"the lower index on {int((got == lows).sum())} of {n} rows, "
            f"plain on {int((ref == lows).sum())}")
        if not (torch.equal(got, lows) and torch.equal(ref, lows)):
            raise AssertionError("VQ: an exact tie did not go to the lower "
                                 "index")


def phase_vq():
    """Kernel vs plain on the card.  Indices must be equal wherever the
    plain version's best-to-second distance gap exceeds 1e-5 * ||e||^2
    (the two sum the 64-term dot in different orders, so closer ties may
    legitimately resolve either way); exact ties (equal codes) must go to
    the lower index (_vq_ties).  Times: CUDA events around 50 calls (the
    Python call included) and the kernel's device time by torch.profiler,
    beside the bound."""
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
        seen = _kernel_breakdown(lambda: [
            vk.vq_nearest_cuda(z, emb) for _ in range(20)]).get(
                "vq_argmin_kernel")
        dev_us = seen[0] / seen[1] if seen else None
        b_ms, b_by = bound(2.0 * n * k * d, nbytes(z, emb) + 8 * n, "f32")
        log(f"[vq] N={n} k={k} d={d}: mismatches {int((got != ref).sum())} "
            f"(outside ties {int(bad.sum())}), max |dist(kernel) - "
            f"dist(plain)| {err:.3g}; kernel {ms * 1e3:.1f} us (CUDA "
            f"events, the call included), device "
            f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'} "
            f"(torch.profiler), bound {b_ms * 1e3:.2f} us by {b_by}; plain "
            f"{plain_ms * 1e3:.1f} us")
        if bad.any():
            raise AssertionError(f"VQ kernel disagrees with plain at N={n}")
        result[n] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "device_us": dev_us}
    _vq_ties(vk, emb, g)
    # off the shipped widths: few rows and codes with d padded to 12 (a
    # TMA box wider and longer than the tensor), and a codebook larger
    # than shared memory (chunks restaged for every row group)
    for n, kk, dd in ((5, 3, 10), (1000, 700, 256)):
        z = torch.randn((n, dd), generator=g).to(dev)
        e = torch.randn((kk, dd), generator=g).to(dev)
        got, ref = vk.vq_nearest_cuda(z, e), vk.vq_nearest_plain(z, e)
        log(f"[vq] N={n} k={kk} d={dd}: mismatches "
            f"{int((got != ref).sum())}")
        if not torch.equal(got, ref):
            raise AssertionError(f"VQ kernel disagrees with plain at N={n} "
                                 f"k={kk} d={dd}")
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
                          steps: int = 256, ratio=None) -> float:
    """Teacher-forced logits of the kernel against the plain twin over
    ``steps`` steps of a noisy sine (sample i reads frame i // ratio, the
    last frame past the last; ratio steps // frames unless given); raises
    beyond tol * max(1, max|logit|).  Returns max |kernel - plain|."""
    from vqvae_wavenet_torch.ops import gen_kernels as gk
    b = lc.shape[0]
    t = torch.arange(steps, dtype=torch.float32)
    x = (0.4 * torch.sin(2 * np.pi * 220.0 * t / 16000.0)[None]
         + 0.05 * torch.randn((b, steps), generator=g)).clamp(-1, 1)
    forced = torch.cat([torch.zeros((b, 1)), x[:, :-1]], dim=1).to(lc.device)
    gcon, g_pp1 = gk.condition_terms(params, w, b, gc)
    kw = dict(length=steps, gate_order=gate_order, forced=forced,
              want_logits=True, ratio=ratio)
    _, lk = gk.generate_clip_cuda(w, lc, gcon, g_pp1, **kw)
    _, lp = gk.generate_clip_plain(w, lc, gcon, g_pp1, **kw)
    err = float((lk - lp).abs().max())
    scale = max(1.0, float(lp.abs().max()))
    wt = str(w.w_a.dtype).split(".")[-1]
    log(f"[{tag}] teacher-forced {wt} weights B={b} {gate_order} "
        f"gc={'yes' if gc is not None else 'no'} T={steps} frames "
        f"{lc.shape[1]} ratio {ratio or steps // lc.shape[1]}: max |logit err| "
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


def _e2e_checkpoint() -> str:
    """build/chip_smoke/weights-0.npz: a random full-width
    model_parameters.json model (weights from seed 0)."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.params import random_params_np, save_npz
    cfg = ModelConfig.from_json(os.path.join(REPO, "model_parameters.json"))
    params, state = random_params_np(cfg, 109, seed=0)
    ckpt = os.path.join(OUT, "weights-0.npz")
    save_npz(ckpt, params, state)
    return ckpt


def phase_e2e(card: str):
    """The voice-conversion entry point at full width, through the VQ and
    generation kernels (bf16, int8 and f32 weights); returns the launch
    counts of the main-path runs."""

    audio = _e2e_wav()
    ckpt = _e2e_checkpoint()
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
    torch.profiler, kernels named by their problem (the GEMM problems of
    csrc/hopper_gemm.cuh) or their own name.  The profiler runs a warm-up
    cycle of fn before the one it keeps (a session can drop the first
    kernels it sees) and hands that cycle's events to on_trace_ready; a
    spin kernel of ~50 us leads each cycle (a cycle can drop its first
    kernel: fn's own first kernel went missing from both loss-head cycles
    of one run); a cycle that kept no device event is run again, up to
    three times; {} if none kept any."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        kept = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.extend(
                         p.key_averages())) as prof:
            for _ in range(2):
                torch.cuda._sleep(100_000)
                fn()
                torch.cuda.synchronize()
                prof.step()
        for e in kept:
            m = re.search(r"gemm<(?:\(anonymous namespace\)::|bwd::)?(\w+)<",
                          e.key) or re.search(
                r"(?:tg::|bwd::|\(anonymous namespace\)::)(\w+)", e.key)
            if m and e.device_time_total > 0 and "spin_kernel" not in e.key:
                us, n = out.get(m.group(1), (0.0, 0))
                out[m.group(1)] = (us + e.device_time_total, n + e.count)
        if out:
            break
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


def _epilogue_inputs(B, T, F, dtype, g, Q: int = 256):
    S = 512
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    skip = (torch.randn((B, T, S), generator=g) * 0.5).cuda()
    w1 = ((torch.rand((S, S), generator=g) * 2 - 1)
          * (3.0 / S) ** 0.5).to("cuda", dt)
    w2 = ((torch.rand((S, Q), generator=g) * 2 - 1)
          * (3.0 / S) ** 0.5).to("cuda", dt)
    b2 = (torch.randn((Q,), generator=g) * 0.05).cuda()
    enc2 = (torch.randn((F, B, S), generator=g) * 0.1).cuda()
    labels = torch.randint(0, Q, (B, T), generator=g).cuda()
    return skip, w1, w2, b2, enc2, labels


def _epilogue_check(tag, B, T, F, dtype, g, Q: int = 256) -> dict:
    """Both loss-head entries against their plain twins on one random case
    at S=512 and Q classes (frames of T / F rows): the loss within 1e-5 (f32) /
    1e-3 (bf16) relative, sk = T(relu(skip)) bit for bit, every other
    leaf as in train-stack; the backward twin gets the kernel forward's a1
    and probs and rounds relu(skip) itself.  Returns the case: its forward
    and backward arguments, the kernel's outputs and the errors."""
    from vqvae_wavenet_torch.ops import epilogue_kernels as ek
    N = B * T
    fwd = _epilogue_inputs(B, T, F, dtype, g, Q)
    skip, w1, w2, b2, enc2, labels = fwd
    lk, a1, probs, sk = ek.epilogue_forward_cuda(*fwd)
    lp, a1_p, probs_p = ek.epilogue_forward_plain(*fwd)
    l_err = abs(float(lk) - float(lp)) / abs(float(lp))
    log(f"[{tag}] {dtype} B={B} T={T} F={F} Q={Q}: loss kernel "
        f"{float(lk) / N:.6f} plain {float(lp) / N:.6f} (relative "
        f"{l_err:.3g})")
    if not l_err <= (1e-5 if dtype == "f32" else 1e-3):
        raise AssertionError(f"epilogue loss disagrees ({dtype})")
    if not torch.equal(sk, torch.relu(skip).to(w1.dtype)):
        raise AssertionError(f"epilogue sk is not T(relu(skip)) "
                             f"bit for bit ({dtype})")
    f_err = max(l_err, _check_leaves(f"{tag} fwd", dtype, {
        "a1": (a1, a1_p), "probs": (probs, probs_p)}))
    del a1_p, probs_p
    gvec = torch.ones((), device="cuda")
    bargs = (gvec, skip, a1, probs, labels, w1, w2, F)
    gk = ek.epilogue_backward_cuda(*bargs, sk)
    gp = ek.epilogue_backward_plain(*bargs)
    b_err = _check_leaves(f"{tag} bwd", dtype, dict(zip(
        ("dskip", "dlc2", "dw1", "dw2", "db2"), zip(gk, gp))))
    return {"fwd": fwd, "bargs": bargs, "sk": sk, "out": (lk, a1, probs, sk),
            "grads": gk, "f_err": f_err, "b_err": b_err}


def _epilogue_bounds(case, dtype):
    """The loss head's bounds from the function's own traffic: skip, the
    weights, enc2 and the labels (int32) in; a1, probs and the loss
    (backward: the gradients) out.  sk is the design's operand for TMA, not
    the function's."""
    skip, w1, w2, b2, enc2, _ = case["fwd"]
    _, a1, probs, _ = case["out"]
    B, T, S = skip.shape
    N, Q = B * T, w2.shape[1]
    f_bound = bound(2.0 * N * (S * S + S * Q),
                    nbytes(skip, w1, w2, b2, enc2) + 4 * N
                    + nbytes(a1, probs) + 4, dtype)
    b_bound = bound(2.0 * N * (2 * S * Q + 2 * S * S),
                    nbytes(skip, a1, probs, w1, w2) + 4 * N
                    + nbytes(*case["grads"]), dtype)
    return f_bound, b_bound


def _epilogue_repeat(tag, dtype, case) -> None:
    """Both entries again on the same inputs: bit for bit."""
    from vqvae_wavenet_torch.ops import epilogue_kernels as ek
    _bitwise_repeat(f"{tag} fwd", dtype, case["out"],
                    ek.epilogue_forward_cuda(*case["fwd"]))
    _bitwise_repeat(f"{tag} bwd", dtype, case["grads"],
                    ek.epilogue_backward_cuda(*case["bargs"], case["sk"]))


def _epilogue_times(case):
    """(fwd kernel, fwd plain, bwd kernel, bwd plain) ms of one case."""
    from vqvae_wavenet_torch.ops import epilogue_kernels as ek
    fwd, bargs, sk = case["fwd"], case["bargs"], case["sk"]
    return (cuda_ms(lambda: ek.epilogue_forward_cuda(*fwd), 10),
            cuda_ms(lambda: ek.epilogue_forward_plain(*fwd), 5),
            cuda_ms(lambda: ek.epilogue_backward_cuda(*bargs, sk), 10),
            cuda_ms(lambda: ek.epilogue_backward_plain(*bargs), 5))


def phase_train_epilogue(card: str):
    """The loss-head kernel (forward and backward entries) against its
    plain twin at the shipped widths S=512, Q=256, f32 and bf16, at B=8,
    T=6656 (104 frames of 64 rows) and at B=3, T=4416 (69 frames: T % 128
    = 64, so the last row tile of each batch row is half empty), by
    ``_epilogue_check``; then at one row a frame (F = T = 6,656: the
    upsampled condition) and at Q=512 and Q=1,024 (104 frames: the
    classes walked in 256-column chunks).  At B=8 both entries run twice
    on the same inputs and must repeat bit for bit, and each case's times
    stand beside its bound; at the full shape torch.profiler splits their
    device time by kernel, and Q=256 is timed again after the other cases
    (its run-to-run range).  Returns the JSON fields of both entries
    (bf16, full shape, Q=256)."""
    from vqvae_wavenet_torch.ops import epilogue_kernels as ek
    g = torch.Generator(device="cpu").manual_seed(5)
    out = {}
    for B, T, F, Q in ((8, 6656, 104, 256), (3, 4416, 69, 256),
                       (8, 6656, 6656, 256), (8, 6656, 104, 512),
                       (8, 6656, 104, 1024)):
        for dtype in ("f32", "bf16"):
            case = _epilogue_check("train-epilogue", B, T, F, dtype, g, Q)
            if B != 8:
                del case
                continue
            _epilogue_repeat("train-epilogue", dtype, case)
            f_ms, fp_ms, b_ms, bp_ms = _epilogue_times(case)
            f_bound, b_bound = _epilogue_bounds(case, dtype)
            rr_txt = "not split"
            if (F, Q) == (104, 256):
                fwd, bargs, sk = case["fwd"], case["bargs"], case["sk"]
                for name, fn in (
                        ("fwd", lambda: ek.epilogue_forward_cuda(*fwd)),
                        ("bwd", lambda: ek.epilogue_backward_cuda(*bargs,
                                                                  sk))):
                    parts = _kernel_breakdown(fn)
                    log(f"[train-epilogue] {dtype} {name} per kernel, device "
                        f"us per call (calls), torch.profiler: " + ", ".join(
                            f"{k} {us / n:.1f} ({n})" for k, (us, n) in
                            sorted(parts.items(), key=lambda kv: -kv[1][0]))
                        + f"; sum {sum(us for us, _ in parts.values()):.1f}")
                    if name == "fwd":
                        rr = parts.get("relu_round")
                        rr_txt = ("not measured" if rr is None
                                  else f"{rr[0] / rr[1] / 1e3:.3f} ms")
            log(f"[train-epilogue] {dtype} B={B} T={T} F={F} Q={Q}: fwd "
                f"kernel {f_ms:.3f} ms (plain {fp_ms:.3f}, bound "
                f"{f_bound[0]:.3f} by {f_bound[1]}; its relu_round pass, "
                f"which writes sk for TMA, {rr_txt} of device time), bwd "
                f"kernel {b_ms:.3f} ms (plain {bp_ms:.3f}, bound "
                f"{b_bound[0]:.3f} by {b_bound[1]})  ({card})")
            if dtype == "bf16" and (F, Q) == (104, 256):
                out["train_epilogue_fwd"] = {
                    "max_abs_err": case["f_err"], "ms": f_ms,
                    "plain_ms": fp_ms, "bound_ms": f_bound[0],
                    "bound_by": f_bound[1], "library_ms": None}
                out["train_epilogue_bwd"] = {
                    "max_abs_err": case["b_err"], "ms": b_ms,
                    "plain_ms": bp_ms, "bound_ms": b_bound[0],
                    "bound_by": b_bound[1], "library_ms": None}
            del case
            torch.cuda.empty_cache()
    case = _epilogue_check("train-epilogue", 8, 6656, 104, "bf16", g)
    f_ms, _, b_ms, _ = _epilogue_times(case)
    log(f"[train-epilogue] bf16 B=8 T=6656 F=104 Q=256 again, after the "
        f"other cases: fwd kernel {f_ms:.3f} ms, bwd kernel {b_ms:.3f} ms "
        f"(first: {out['train_epilogue_fwd']['ms']:.3f}, "
        f"{out['train_epilogue_bwd']['ms']:.3f})  ({card})")
    del case
    torch.cuda.empty_cache()
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
    rates = {}
    ckpt = None
    for dtype in ("f32", "bf16"):
        save = os.path.join(OUT, f"train_{dtype}")
        vq_kernels.launches = 0
        train_kernels.fwd_launches = train_kernels.bwd_launches = 0
        epilogue_kernels.fwd_launches = epilogue_kernels.bwd_launches = 0
        with _Tee() as tee:
            res = train_cli.main([
                "-dataset", "VCTK", "-length", "6656", "-batch", "8",
                "-step", "6", "-save", os.path.join(save, "weights"),
                "-params", configs[dtype], "-data", data, "-device", "cuda",
                "-log_every", "1", "-interval", "1000", "-ckpt_interval",
                "1000", "-loader", "native"])
        if "[data] native C++ loader" not in tee.text:
            raise AssertionError("[train-e2e] -loader native printed no "
                                 "loader line")
        counts = {"vq_argmin": vq_kernels.launches,
                  "train_stack_fwd": train_kernels.fwd_launches,
                  "train_stack_bwd": train_kernels.bwd_launches,
                  "train_epilogue_fwd": epilogue_kernels.fwd_launches,
                  "train_epilogue_bwd": epilogue_kernels.bwd_launches}
        print()
        steady = res["step_seconds"][2:]
        rates[dtype] = len(steady) / sum(steady)
        log(f"[train-e2e] {dtype}: losses "
            + " ".join(f"{v:.4f}" for v in res["losses"])
            + f"; {rates[dtype]:.3f} steps/s over steps 3-6 "
            f"(host clock, synchronised; first step "
            f"{res['step_seconds'][0]:.2f} s; -loader native)  ({card})")
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
    res, counts = _cli_train("train-e2e python loader", card,
                             configs["bf16"], 6656, data,
                             os.path.join(OUT, "train_bf16_python"),
                             "-loader", "python")
    _need("train-e2e python loader", counts)
    _add(launches, counts)
    log(f"[train-e2e] bf16 steps/s over steps 3-6: -loader native "
        f"{rates['bf16']:.3f}, -loader python {res['steps_per_s']:.3f} "
        f"(same corpus, host clock)  ({card})")
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
    "train_dtype": dtype (written once; ranks read the parent's file)."""
    path = os.path.join(OUT, f"magenta_{dtype}.json")
    if not os.path.exists(path):
        with open(os.path.join(REPO, "magenta_parameters.json")) as f:
            mp = json.load(f)
        _write_json(path, dict(mp, train_dtype=dtype))
    return path


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


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


def _sp_variant_check(tag, dtype, w, x0, dskip, dxout, dils, F, start,
                      gate="tanh_first"):
    """The SP variants at ``start`` with the stream output and the dX
    seed against their plain twins (tolerances as in [train-stack]); rows
    before the start must be exactly zero in skip, act, xout and dx0.
    Returns (forward error, backward error)."""
    from vqvae_wavenet_torch.ops import train_kernels as tk
    kw = dict(dils=dils, gate_order=gate, start=start, with_xout=True)
    fk = tk.stack_forward_cuda(*w, x0, **kw)
    fp = tk.stack_forward_plain(*w, x0, **kw)
    for name, a in zip(("skip_sum", "act", "xs", "xout"), fk):
        head = a[:, :, :start] if a.dim() == 4 else a[:, :start]
        if name == "xs":
            head = head[1:]               # xs[0] = x0 as given
        if head.numel() and not bool((head == 0).all()):
            raise AssertionError(f"{tag} {dtype}: {name} rows before start "
                                 f"{start} not zero")
    f_err = _check_leaves(f"{tag} fwd start={start}", dtype, {
        "skip_sum": (fk[0][:, start:], fp[0][:, start:]),
        "xout": (fk[3][:, start:], fp[3][:, start:]),
        "act[0]": (fk[1][0], fp[1][0])})
    del fp
    bargs = (dskip, fk[1], fk[2], w[0], w[1], w[2])
    bkw = dict(gate_order=gate, start=start, dxout=dxout)
    gk = tk.stack_backward_cuda(*bargs, dils, F, **bkw)
    gp = tk.stack_backward_plain(*bargs, dils, F, **bkw)
    if start and not bool((gk[5][:, :start] == 0).all()):
        raise AssertionError(f"{tag} {dtype}: dx0 rows before start {start} "
                             f"not zero")
    b_err = _check_leaves(f"{tag} bwd start={start}", dtype, dict(
        zip(("dk", "dsk", "drs", "drb", "dlc", "dx0"), zip(gk, gp))))
    return f_err, b_err


def _dxout(x0, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(x0.shape, generator=g) * 1e-3).to("cuda", x0.dtype)


def phase_sp_stack(card: str):
    """The stack kernels' SP variants against their plain twins
    (_sp_variant_check) on one dilation cycle (layers 0-9, dilations
    1-512) of the 2-rank shape: B=8, T_ext = 3,328 + 2,048 = 5,376 rows,
    84 frames; start 0 (rank 1) and 2,048 (rank 0), the stream output and
    a random dxout; f32 and bf16, tanh_first.  Then the shapes of the
    other SP paths, f32 and bf16: one cycle of the Magenta preset (K=2,
    R=D=256, S=512, a global condition folded into every layer,
    sigmoid_first) on its 2-rank shard, T_ext = 3,328 + 1,024 = 4,352, 68
    frames, start 0 and 1,024; and the shipped cycle on Encoder_2019's
    2-rank shard, T_ext = 3,200 + 2,240 = 5,440 rows (T_ext % 128 = 64),
    17 frames of 320 rows, start 0 and 2,240.  Times (bf16 and f32, start
    0: every row is needed) beside the plain kernels' on the first shape.
    Returns the JSON fields of both (bf16)."""
    from vqvae_wavenet_torch.ops import train_kernels as tk
    B, T, F, lg = 8, 5376, 84, 10
    out = {}
    for dtype in ("f32", "bf16"):
        for tag, (T2, F2, start2, gate, params_json) in (
                ("sp-stack magenta", (4352, 68, 1024, "sigmoid_first",
                                      "magenta_parameters.json")),
                ("sp-stack 2019", (5440, 17, 2240, "tanh_first",
                                   "model_parameters.json"))):
            cfg, w, x0, dskip = _stack_inputs(
                B, T2, F2, dtype, gate == "sigmoid_first", seed=13,
                params_json=params_json)
            w = [t[:lg].contiguous() for t in w]
            dils = tuple(cfg.wavenet.dilation_rates[:lg])
            for start in (0, start2):
                _sp_variant_check(tag, dtype, w, x0, dskip, _dxout(x0, 14),
                                  dils, F2, start, gate)
            del w, x0, dskip
        cfg, w, x0, dskip = _stack_inputs(B, T, F, dtype, False, seed=11)
        w = [t[:lg].contiguous() for t in w]
        dils = tuple(cfg.wavenet.dilation_rates[:lg])
        dxout = _dxout(x0, 12)
        errs = {start: _sp_variant_check("sp-stack", dtype, w, x0, dskip,
                                         dxout, dils, F, start)
                for start in (0, 2048)}
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


def _train_config(dtype: str, encoder: str = "64", **extra) -> str:
    """build/chip_smoke/model_<dtype>.json (model_<encoder>_<dtype>.json
    for another encoder, with _<key>-<value> for each ``extra`` key):
    model_parameters.json with "train_dtype": dtype, "encoder": encoder,
    ``extra`` and an absolute wavenet_parameters path (written once; the
    ranks read the file the parent wrote)."""
    name = f"model_{dtype}" if encoder == "64" else f"model_{encoder}_{dtype}"
    name += "".join(f"_{k}-{v}" for k, v in sorted(extra.items()))
    path = os.path.join(OUT, f"{name}.json")
    if not os.path.exists(path):
        with open(os.path.join(REPO, "model_parameters.json")) as f:
            mp = json.load(f)
        mp["wavenet_parameters"] = os.path.join(REPO,
                                                "wavenet_parameters.json")
        _write_json(path, dict(mp, train_dtype=dtype, encoder=encoder,
                               **extra))
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


def _sp_case(B: int, dtype: str, device, name: str = "shipped"):
    """The SP phases' inputs, the same in every process: the config of
    MESH_CASES[name] (the shipped one by default; train_dtype ``dtype``)
    with random weights from SP_SEED and every bias raised by 0.05 (so
    that a wrong causal pad at a shard boundary shows), a batch of B random
    clips of the case's length and speakers."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    extra, T = MESH_CASES[name]
    cfg = ModelConfig.from_json(_magenta_config(dtype) if extra is None
                                else _train_config(dtype, **extra))
    params, state = random_params_np(cfg, 109, seed=SP_SEED)

    def bump(tree, name=""):
        if isinstance(tree, dict):
            return {k: bump(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [bump(v) for v in tree]
        return tree + np.float32(0.05) if "bias" in name else tree
    x, y = _fixed_batch(B, device)
    return (cfg, to_torch(bump(params), device), to_torch(state, device),
            x[:, :T].contiguous(), y)


def _timed(fn, device):
    """(fn(), host milliseconds of the call, synchronised on both
    sides)."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def _host_ms(fn, device) -> float:
    """Host milliseconds of one call of fn, synchronised on both sides."""
    return _timed(fn, device)[1]


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
                        timeout=600, n_time=world)
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


class _Tee:
    """Standard output copied into ``text`` while it prints."""

    def __init__(self):
        self.text = ""

    def write(self, s):
        self.text += s
        return self._out.write(s)

    def flush(self):
        self._out.flush()

    def __enter__(self):
        self._out, sys.stdout = sys.stdout, self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._out


def _cli_train(tag, card, params_json, length: int, data: str, save: str,
               *extra, steps: int = 6):
    """vqvae_wavenet_torch.train for ``steps`` steps at -batch 8 (and the
    ``extra`` flags) with the VQ, stack and loss-head counters set to 0
    just before and read just after; finite losses and a checkpoint.
    Returns (result with its printed text under "stdout", counts)."""
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.ops import (epilogue_kernels, train_kernels,
                                         vq_kernels)
    vq_kernels.launches = 0
    train_kernels.fwd_launches = train_kernels.bwd_launches = 0
    epilogue_kernels.fwd_launches = epilogue_kernels.bwd_launches = 0
    with _Tee() as tee:
        res = train_cli.main([
            "-dataset", "VCTK", "-length", str(length), "-batch", "8",
            "-step", str(steps), "-save", os.path.join(save, "weights"),
            "-params", params_json, "-data", data, "-device", "cuda",
            "-log_every", "1", "-interval", "1000", "-ckpt_interval",
            "1000", *extra])
    res["stdout"] = tee.text
    counts = {"vq_argmin": vq_kernels.launches,
              "train_stack_fwd": train_kernels.fwd_launches,
              "train_stack_bwd": train_kernels.bwd_launches,
              "train_epilogue_fwd": epilogue_kernels.fwd_launches,
              "train_epilogue_bwd": epilogue_kernels.bwd_launches}
    print()
    steady = res["step_seconds"][2:]
    res["steps_per_s"] = len(steady) / sum(steady)
    log(f"[{tag}] losses " + " ".join(f"{v:.4f}" for v in res["losses"])
        + f"; {res['steps_per_s']:.3f} steps/s over steps 3-{steps} (host "
        f"clock, synchronised; first step {res['step_seconds'][0]:.2f} s); "
        f"kernel launches {counts}  ({card})")
    if not np.isfinite(res["losses"]).all():
        raise AssertionError(f"[{tag}] non-finite training loss")
    if not os.path.exists(res["path"] + ".npz"):
        raise AssertionError(f"[{tag}] no checkpoint written")
    return res, counts


TRAIN_NEED = ("vq_argmin", "train_stack_fwd", "train_stack_bwd",
              "train_epilogue_fwd", "train_epilogue_bwd")


def _need(tag, counts, need=TRAIN_NEED) -> None:
    if min(counts.get(k, 0) for k in need) < 1:
        raise AssertionError(f"[{tag}] a kernel of the path was never "
                             f"launched: {counts}")


def _gen_from(tag, card, ckpt, params_json, data) -> dict:
    """vqvae_wavenet_torch.generate from a training checkpoint: 2,048
    greedy samples for p226 in bf16, the VQ and generation counters set to
    0 just before and read just after."""
    from scipy.io import wavfile
    from vqvae_wavenet_torch import generate as gen_cli
    from vqvae_wavenet_torch.ops import gen_kernels, vq_kernels
    audio = os.path.join(OUT, "train_input.wav")
    t = np.arange(2048) / 16000.0
    wavfile.write(audio, 16000, (0.3 * np.sin(2 * np.pi * 200.0 * t)
                                 * 32767).astype(np.int16))
    vq_kernels.launches = gen_kernels.launches = 0
    res = gen_cli.main(["-restore", ckpt, "-audio", audio, "-speakers",
                        "p226", "-mode", "greedy", "-params", params_json,
                        "-data", data, "-device", "cuda"])
    counts = {"vq_argmin": vq_kernels.launches,
              "gen_wavenet": gen_kernels.launches}
    if res["audio"].shape != (1, 2048) or not np.isfinite(
            res["audio"]).all():
        raise AssertionError(f"[{tag}] generation from the checkpoint failed")
    _need(tag, counts, ("vq_argmin", "gen_wavenet"))
    log(f"[{tag}] generated 2048 samples from {os.path.basename(ckpt)} in "
        f"{res['seconds']:.2f} s; launches {counts}  ({card})")
    return counts


def phase_train_cond(card: str):
    """The upsampled condition and the time jitter through the training
    CLI: the shipped config with "condition_upsample": true and
    "time_jitter": true at -batch 8 -length 6656, six steps in f32 and in
    bf16 (the condition reaches the stack and loss-head kernels at one
    frame a sample: F = T = 6,656, C = 128): finite losses that fall (the
    mean of the last two below the first), the
    path's kernels launched, lc_encb's bytes and the step's ms and peak
    memory; then vqvae_wavenet_torch.generate converts from the bf16
    checkpoint.  Returns the runs' launch counts."""
    from vqvae_wavenet_torch.config import ModelConfig
    data = _train_corpus()
    total: dict = {}
    for dtype in ("f32", "bf16"):
        cfgp = _train_config(dtype, condition_upsample=True,
                             time_jitter=True)
        torch.cuda.reset_peak_memory_stats()
        res, counts = _cli_train("train-cond", card, cfgp, 6656, data,
                                 os.path.join(OUT, f"cond_{dtype}"))
        peak = torch.cuda.max_memory_allocated() / 1e9
        w = ModelConfig.from_json(cfgp).wavenet
        lc_bytes = 4 * w.num_layers * 6656 * 8 * 2 * w.dilation_filters
        log(f"[train-cond] {dtype}: lc_encb [L, F, B, 2D] f32 at F = T = "
            f"6656: {lc_bytes / 1e9:.3f} GB (its gradient as large); step "
            f"{1e3 / res['steps_per_s']:.1f} ms; peak device memory "
            f"{peak:.2f} GB  ({card})")
        losses = res["losses"]
        if not np.mean(losses[-2:]) < losses[0]:
            raise AssertionError(f"[train-cond] {dtype}: the loss does not "
                                 f"fall: {losses}")
        _need("train-cond", counts, TRAIN_NEED if dtype == "bf16"
              else TRAIN_NEED[:3])
        _add(total, counts)
    _add(total, _gen_from("train-cond", card, res["path"] + ".npz", cfgp,
                          data))
    return total


def _q512_config() -> str:
    """build/chip_smoke/model_q512_bf16.json: the shipped config in bf16
    with a copy of wavenet_parameters.json at quantization_channels 512."""
    path = os.path.join(OUT, "model_q512_bf16.json")
    wpath = os.path.join(OUT, "wavenet_q512.json")
    with open(os.path.join(REPO, "wavenet_parameters.json")) as f:
        _write_json(wpath, dict(json.load(f), quantization_channels=512))
    with open(os.path.join(REPO, "model_parameters.json")) as f:
        mp = json.load(f)
    _write_json(path, dict(mp, wavenet_parameters=wpath, train_dtype="bf16"))
    return path


def phase_q512(card: str):
    """quantization_channels 512 end to end: six bf16 steps through the
    training CLI at -batch 8 -length 6656 (the loss head over two
    256-column chunks), then the generation kernel on the trained
    decoder at Q=512 against its plain twin: teacher-forced bf16 logits
    within 5e-2 of max |logit|, a greedy f32 clip of 1,024 samples with
    identical bins (or a first divergence at a near tie), and
    vqvae_wavenet_torch.generate from the checkpoint.  Returns the
    launches."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.ops import gen_kernels as gk
    from vqvae_wavenet_torch.params import load_npz
    data = _train_corpus()
    cfgp = _q512_config()
    res, counts = _cli_train("q512", card, cfgp, 6656, data,
                             os.path.join(OUT, "q512"))
    _need("q512", counts)
    ckpt = res["path"] + ".npz"
    wcfg = ModelConfig.from_json(cfgp).wavenet
    params, _ = load_npz(ckpt, "cuda")
    dec = params["decoder"]
    if dec["postprocess2"]["kernel"].shape[-1] != 512:
        raise AssertionError("[q512] the checkpoint's head is not 512 wide")
    g = torch.Generator(device="cpu").manual_seed(9)
    lc = (torch.randn((3, 4, dec["layers"]["lc_kernel"].shape[1]),
                      generator=g) * 0.5).cuda()
    w16 = gk.pack_gen_params(dec, wcfg, torch.bfloat16, "cuda")
    _teacher_forced_check("q512", dec, w16, lc, None, "tanh_first",
                          BF16_LOGIT_TOL, g)
    w32 = gk.pack_gen_params(dec, wcfg, torch.float32, "cuda")
    gcon, g_pp1 = gk.condition_terms(dec, w32, 1)
    lc1 = lc[:1].repeat_interleave(4, dim=1)
    bk, _ = gk.generate_clip_cuda(w32, lc1, gcon, g_pp1, length=1024)
    bp, lp = gk.generate_clip_plain(w32, lc1, gcon, g_pp1, length=1024,
                                    want_logits=True)
    diff = (bk != bp).nonzero()
    if len(diff):
        first = int(diff[0, 1])
        top2 = torch.topk(lp[0, first], 2).values
        margin = float(top2[0] - top2[1])
        log(f"[q512] greedy f32 1024: first divergence at step {first}, "
            f"plain top-two margin {margin:.3g}")
        if margin > GREEDY_TIE:
            raise AssertionError("[q512] greedy bins diverge away from a "
                                 "near tie")
    else:
        log(f"[q512] greedy f32 1024: bins identical "
            f"({int(torch.unique(bk).numel())} distinct bins, max "
            f"{int(bk.max())})")
    _add(counts, _gen_from("q512", card, ckpt, cfgp, data))
    return counts


class _PlainStack:
    """Inside: the stack's CUDA entries ``names`` run their plain twins (on
    the same CUDA tensors), so a whole step can be held against its plain
    twin."""

    def __init__(self, names=("stack_forward", "stack_backward")):
        self.NAMES = names

    def __enter__(self):
        from vqvae_wavenet_torch.ops import train_kernels as tk
        self._saved = {n: getattr(tk, n + "_cuda") for n in self.NAMES}
        for n in self.NAMES:
            setattr(tk, n + "_cuda", getattr(tk, n + "_plain"))

    def __exit__(self, *exc):
        from vqvae_wavenet_torch.ops import train_kernels as tk
        for n, f in self._saved.items():
            setattr(tk, n + "_cuda", f)


def phase_standalone(card: str):
    """The standalone WaveNet trainer (models/wavenet.py::
    make_standalone_trainer) at the shipped decoder widths (30 layers,
    R=256, 2D=512, S=512, Q=256), B=8 x 6656, f32, with lc [B, 104, 128]
    and with no lc: one step_fn call (the stack kernels' counters set to 0
    just before and read just after), and the first step's loss against
    the plain twin's (forward and backward plain) and its gradients
    against the plain backward twin run on the kernel forward's saved
    activations (1e-3 of each leaf's max), as [train-epilogue] feeds its
    backward twin the kernel forward's outputs: from a plain forward, a
    head's relu gate that an f32 rounding difference flips moves a
    condition kernel's gradient by more than 1e-3 of its max.  Returns
    the launches."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.models.wavenet import (make_standalone_trainer,
                                                    wavenet_forward,
                                                    wavenet_loss)
    from vqvae_wavenet_torch.ops import train_kernels as tk
    from vqvae_wavenet_torch.training.optimizer import tree_leaves
    w = ModelConfig.from_json(os.path.join(REPO,
                                           "model_parameters.json")).wavenet
    x, _ = _fixed_batch(8, "cuda")
    g = torch.Generator(device="cpu").manual_seed(13)
    total = {"train_stack_fwd": 0, "train_stack_bwd": 0}
    for c_lc in (128, None):
        tag = f"standalone lc={'[8, 104, 128]' if c_lc else 'none'}"
        init_fn, step_fn = make_standalone_trainer(w, c_lc)
        state = init_fn(np.random.default_rng(0), "cuda")
        lc = (None if c_lc is None else
              (torch.randn((8, 104, c_lc), generator=g) * 0.5).cuda())

        def grads():
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(state["params"])]
            from vqvae_wavenet_torch.training.optimizer import tree_unflatten
            p = tree_unflatten(state["params"], leaves)
            loss = wavenet_loss(*wavenet_forward(p, w, x, lc))
            return loss.detach(), torch.autograd.grad(loss, leaves)
        tk.fwd_launches = tk.bwd_launches = 0
        t0 = time.perf_counter()
        new, m = step_fn(state, x, lc)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"train_stack_fwd": tk.fwd_launches,
                  "train_stack_bwd": tk.bwd_launches}
        _need(tag, counts, tuple(counts))
        _add(total, counts)
        lk, gk_ = grads()
        with _PlainStack():
            lp, _ = grads()
        with _PlainStack(("stack_backward",)):
            _, gp = grads()
        rel = abs(float(lk) - float(lp)) / abs(float(lp))
        log(f"[{tag}] f32 step {secs * 1e3:.1f} ms (first call, host "
            f"clock); loss {float(m['loss']):.6f}, kernel {float(lk):.6f} "
            f"plain {float(lp):.6f} (relative {rel:.3g}); launches "
            f"{counts}  ({card})")
        if not rel <= TRAIN_TOL["f32"] or abs(
                float(m["loss"]) - float(lk)) > 1e-6 * abs(float(lk)):
            raise AssertionError(f"[{tag}] loss disagrees")
        _check_leaves(tag, "f32", {f"leaf {i}": (a, b) for i, (a, b) in
                                   enumerate(zip(gk_, gp))})
        if not new["step"] == 1 or not all(
                torch.isfinite(t).all() for t in tree_leaves(new["params"])):
            raise AssertionError(f"[{tag}] the update failed")
        del state, new, gk_, gp
        torch.cuda.empty_cache()
    return total


def _pb_fields(buf: bytes) -> dict:
    """A protobuf message's fields: {number: [value, ...]}, varints as
    ints, fixed64 / fixed32 / length-delimited as bytes."""
    out, i = {}, 0
    while i < len(buf):
        key, i = _pb_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _pb_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _pb_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise AssertionError(f"unexpected protobuf wire type {wire}")
        out.setdefault(num, []).append(v)
    return out


def _pb_varint(buf: bytes, i: int):
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def read_events(path: str) -> list:
    """An event file's events as (step, {tag: simple_value or (num,
    bucket counts)}), each record's length and data checked against its
    masked CRC32C; the first event must carry the file version."""
    from vqvae_wavenet_torch.training.metrics import masked_crc32c
    import struct
    data = open(path, "rb").read()
    i, events = 0, []
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (c1,) = struct.unpack("<I", data[i + 8:i + 12])
        rec = data[i + 12:i + 12 + n]
        (c2,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if c1 != masked_crc32c(head) or c2 != masked_crc32c(rec):
            raise AssertionError(f"{path}: a record fails its CRC")
        i += 16 + n
        ev = _pb_fields(rec)
        if not events and ev.get(3) != [b"brain.Event:2"]:
            raise AssertionError(f"{path}: no file version first")
        vals = {}
        for summ in ev.get(5, []):
            for v in _pb_fields(summ).get(1, []):
                f = _pb_fields(v)
                tag = f[1][0].decode()
                if 5 in f:
                    h = _pb_fields(f[5][0])
                    (num,) = struct.unpack("<d", h[3][0])
                    counts = np.frombuffer(b"".join(h.get(7, [])), "<f8")
                    vals[tag] = (num, counts)
                else:
                    vals[tag] = struct.unpack("<f", f[2][0])[0]
        events.append((ev.get(2, [0])[0], vals))
    return events


def _check_event_file(tag, save_dir, step: int, cfg_json, card) -> None:
    """The event file in save_dir: the scalars and the histogram set of
    one -interval write at ``step``, each histogram's count equal to its
    array's size (the parameters' shapes, B=8 x 104 frames)."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.params import random_params_np
    from vqvae_wavenet_torch.training.metrics import clean_tag, tree_paths
    (name,) = [f for f in os.listdir(save_dir) if "tfevents" in f]
    events = read_events(os.path.join(save_dir, name))
    got = {}
    for s, vals in events:
        if s == step:
            got.update(vals)
    cfg = ModelConfig.from_json(cfg_json)
    params, _ = random_params_np(cfg, 109)
    w, n = cfg.wavenet, 8 * 104
    sizes = {"z_e": n * cfg.latent_dim, "e_k": n * cfg.latent_dim,
             "q_z_x_": n, "distances": n * cfg.k,
             "embedding": cfg.k * cfg.latent_dim,
             "speaker_embedding": 109 * cfg.speaker_embedding}
    sizes.update({f"wavenet/layer_{i}/kernel": w.kernel_size
                  * w.residual_filters * 2 * w.dilation_filters
                  for i in range(w.num_layers)})
    sizes.update({clean_tag(f"gradients/{p}"): v.size
                  for p, v in tree_paths(params)})
    scalars = ("loss", "reconstruction_loss", "lr", "vq_loss",
               "commitment_loss", "perplexity", "distances_mean",
               "global_norm/gradient_norm")
    missing = [k for k in list(sizes) + list(scalars) if k not in got]
    if missing:
        raise AssertionError(f"[{tag}] tags missing at step {step}: "
                             f"{missing[:8]}")
    bad = {k: (got[k][0], float(got[k][1].sum()), v)
           for k, v in sizes.items()
           if not got[k][0] == got[k][1].sum() == v}
    if bad:
        raise AssertionError(f"[{tag}] histogram counts differ from the "
                             f"array sizes: {list(bad.items())[:4]}")
    log(f"[{tag}] event file {name}: {len(events)} events; at step {step} "
        f"{len(got)} tags ({len(sizes)} histograms, each count its array's "
        f"size; gradient norm {got['global_norm/gradient_norm']:.4g}; loss "
        f"{got['loss']:.4f})  ({card})")


def phase_summaries(card: str):
    """One -interval write of the training CLI (the shipped config, bf16,
    -batch 8 -length 6656, three steps, -interval 3) read back by
    ``read_events``: the scalars and the reference's histogram set, each
    histogram's count equal to its array's size.  [dp] reads the same
    write from rank 0 of a 2-rank run.  Returns the launches."""
    data = _train_corpus()
    save = os.path.join(OUT, "summaries")
    if os.path.isdir(save):
        import shutil
        shutil.rmtree(save)
    cfgp = _train_config("bf16")
    res, counts = _cli_train("summaries", card, cfgp, 6656, data, save,
                             "-interval", "3", steps=3)
    _need("summaries", counts)
    _check_event_file("summaries", save, 3, cfgp, card)
    return counts


def phase_visualise(card: str):
    """python -m vqvae_wavenet_torch.visualise on the codebook and speaker
    table [e2e]'s conversions wrote (build/chip_smoke/embedding_0.npy,
    speaker_embedding_0.npy) with the repo's VCTK tables: four TSV files,
    one row a code or a speaker."""
    from vqvae_wavenet_torch import visualise
    emb = os.path.join(OUT, "embedding_0.npy")
    spk = os.path.join(OUT, "speaker_embedding_0.npy")
    if not (os.path.exists(emb) and os.path.exists(spk)):
        _convert(card, "visualise", _e2e_checkpoint(),
                 os.path.join(REPO, "model_parameters.json"), _e2e_wav(),
                 "bf16", "greedy", distinct=True)
    save = os.path.join(OUT, "visualise")
    visualise.main(["-embedding", emb, "-speaker", spk, "-dataset", "VCTK",
                    "-save", save, "-data", os.path.join(REPO, "data")])
    rows = {}
    for stem, n in (("embedding_0", 512), ("speaker_embedding_0", 109)):
        for kind in ("vecs", "meta"):
            with open(os.path.join(save, f"{stem}_{kind}.tsv")) as f:
                rows[f"{stem}_{kind}"] = f.read().count("\n")
            if rows[f"{stem}_{kind}"] != n:
                raise AssertionError(f"[visualise] {stem}_{kind}.tsv: "
                                     f"{rows[f'{stem}_{kind}']} rows, not {n}")
    log(f"[visualise] TSV rows {rows}")


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_encoders(card: str):
    """Encoder_2019 and Encoder_Magenta on the card.
    (1) The loss head at Encoder_2019's frames (B=8, T=6,400, F=20: 320
    rows a frame, which its 128-row tiles cut, so the dlc2 join runs)
    against its plain twin in f32 and bf16 (``_epilogue_check``), both
    entries bit for bit on a second run; the same at two ragged shapes:
    B=3, T=6,080, F=19 (320 rows a frame, T % 128 = 64: the last tile of
    a batch row is half empty and cuts a frame) and B=2, T=6,400, F=64
    (100 rows a frame: a tile holds a cut head, a whole frame and a cut
    tail); device times by CUDA events of both entries at FR=320 beside
    FR=64 (B=8, T=6,656, F=104, the shipped frames), bf16, in the order
    64, 320, 320, 64.
    (2) vqvae_wavenet_torch.train six steps each: the 2019 encoder at
    -length 6400 in f32 and bf16, the Magenta encoder at -length 6656 in
    bf16; the VQ and stack kernels launched in every run, the loss head in
    bf16.  (3) vqvae_wavenet_torch.generate from the 2019 bf16 checkpoint
    on the 8,192-sample wav (26 frames, ratio 315: the last 2 samples read
    the last frame) in bf16 and int8, greedy and sample; and the generation
    kernel against its plain twin teacher-forced at ratio 315 over the
    wav's last two frames (632 samples: the last 2 read the second frame
    again), f32 and bf16.  Returns the main-path runs' launches."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.models.vqvae import vqvae_encode
    from vqvae_wavenet_torch.ops import epilogue_kernels as ek
    from vqvae_wavenet_torch.ops import gen_kernels as gk
    from vqvae_wavenet_torch.params import load_npz
    g = torch.Generator(device="cpu").manual_seed(9)
    for B, T, F in ((8, 6400, 20), (3, 6080, 19), (2, 6400, 64)):
        tag = f"encoders epilogue FR={T // F}"
        for dtype in ("f32", "bf16"):
            case = _epilogue_check(tag, B, T, F, dtype, g)
            _epilogue_repeat(tag, dtype, case)
            del case
            torch.cuda.empty_cache()
    cases = {fr: _epilogue_check(f"encoders epilogue FR={fr}", 8, T, F,
                                 "bf16", g)
             for fr, T, F in ((64, 6656, 104), (320, 6400, 20))}
    times = {64: [], 320: []}
    for fr in (64, 320, 320, 64):
        c = cases[fr]
        times[fr].append((
            cuda_ms(lambda: ek.epilogue_forward_cuda(*c["fwd"]), 20),
            cuda_ms(lambda: ek.epilogue_backward_cuda(*c["bargs"], c["sk"]),
                    20)))
    for fr in (64, 320):
        f_bound, b_bound = _epilogue_bounds(cases[fr], "bf16")
        log(f"[encoders] loss head bf16 FR={fr}: fwd "
            + " / ".join(f"{f:.3f}" for f, _ in times[fr])
            + f" ms (bound {f_bound[0]:.3f} by {f_bound[1]}), bwd "
            + " / ".join(f"{b:.3f}" for _, b in times[fr])
            + f" ms (bound {b_bound[0]:.3f} by {b_bound[1]}); CUDA events, "
            f"mean of 20 calls, order 64 320 320 64  ({card})")
    del cases
    torch.cuda.empty_cache()

    data = _train_corpus()
    launches: dict = {}
    ckpt = None
    for encoder, dtype, length in (("2019", "f32", 6400),
                                   ("2019", "bf16", 6400),
                                   ("Magenta", "bf16", 6656)):
        res, counts = _cli_train(
            f"encoders train {encoder} {dtype} -length {length}", card,
            _train_config(dtype, encoder), length, data,
            os.path.join(OUT, f"train_{encoder}_{dtype}"))
        need = ["vq_argmin", "train_stack_fwd", "train_stack_bwd"]
        if dtype == "bf16":
            need += ["train_epilogue_fwd", "train_epilogue_bwd"]
        if min(counts[k] for k in need) < 1:
            raise AssertionError(f"[encoders] a kernel of the {encoder} "
                                 f"{dtype} training path was never "
                                 f"launched: {counts}")
        _add(launches, {k: counts[k] for k in need})
        if (encoder, dtype) == ("2019", "bf16"):
            ckpt = res["path"] + ".npz"

    params_json = _train_config("bf16", "2019")
    audio = _e2e_wav()
    for dtype in ("bf16", "int8"):
        for mode in ("greedy", "sample"):
            _add(launches, _convert(card, "encoders 2019", ckpt, params_json,
                                    audio, dtype, mode, distinct=True))
    cfg = ModelConfig.from_json(params_json)
    params, state = load_npz(ckpt, "cuda")
    from scipy.io import wavfile
    x = torch.from_numpy(wavfile.read(audio)[1].astype(np.float32)
                         / 32768.0).reshape(1, -1, 1).cuda()
    y = torch.zeros((1, 1, 109), device="cuda")
    y[0, 0, 1] = 1.0
    with torch.no_grad():
        lc, _ = vqvae_encode(params, state, cfg, x, y)
        if lc.shape[1] != 26 or 8192 // 26 != 315:
            raise AssertionError(f"2019 encode of 8,192 samples gave "
                                 f"{lc.shape[1]} frames, not 26")
        for dtype, tol in ((torch.float32, F32_LOGIT_TOL),
                           (torch.bfloat16, BF16_LOGIT_TOL)):
            w = gk.pack_gen_params(params["decoder"], cfg.wavenet, dtype,
                                   "cuda")
            _teacher_forced_check("encoders 2019", params["decoder"], w,
                                  lc[:, -2:].contiguous(), None,
                                  "tanh_first", tol, g, steps=632,
                                  ratio=315)
    log(f"[encoders] kernel launches in the main-path runs: {launches}")
    return launches


def _prior_vqvae(path: str, data: str) -> None:
    """A random full-width model_parameters.json VQ-VAE (weights from a
    seed) whose codebook is 512 of its own encoder's output frames on the
    corpus, plus noise: a random codebook sends every frame to one code,
    which leaves the prior nothing to learn."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.data import read_wav_16k
    from vqvae_wavenet_torch.models.encoders import encoder_forward
    from vqvae_wavenet_torch.params import random_params_np, save_npz, to_torch
    cfg = ModelConfig.from_json(os.path.join(REPO, "model_parameters.json"))
    params, state = random_params_np(cfg, 109, seed=0)
    root = os.path.join(data, "VCTK-Corpus", "wav48")
    with open(os.path.join(data, "vctk_info", "vctk_train.txt")) as f:
        wavs = [read_wav_16k(os.path.join(root, n.strip()))
                for n in f if n.strip()]
    x = torch.from_numpy(np.stack(wavs)[..., None]).cuda()
    with torch.no_grad():
        z, _ = encoder_forward("64", to_torch(params["encoder"], "cuda"),
                               to_torch(state["encoder"], "cuda"), x)
    z = z.reshape(-1, z.shape[-1]).cpu().numpy()
    rng = np.random.default_rng(0)
    pick = z[rng.choice(len(z), cfg.k, replace=len(z) < cfg.k)]
    params["vq"]["embedding"] = (pick + 0.01 * z.std() * rng.standard_normal(
        pick.shape)).astype(np.float32)
    save_npz(path, params, state)


def phase_prior(card: str):
    """The prior entry point (vqvae_wavenet_torch.prior) over a random
    full-width model_parameters.json VQ-VAE (``_prior_vqvae``) on the
    synthetic corpus: 20 training steps at -batch 8 -length 6656 in f32
    and in bf16 (finite NLL; the VQ kernel launched: it encodes the codes),
    NLL, code perplexity and steps/s over steps 3-20; then -sample 4
    -seconds 1.0 -speakers p225 p226 p225 None from the bf16 prior: four
    16,000-sample clips through the generation kernel, finite, in [-1, 1],
    samples/s.  Counters are set to 0 just before each run and read just
    after.  Returns the main-path runs' launches."""
    from scipy.io import wavfile
    from vqvae_wavenet_torch import prior as prior_cli
    from vqvae_wavenet_torch.ops import gen_kernels, vq_kernels
    params_json = os.path.join(REPO, "model_parameters.json")
    data = _train_corpus()
    ckpt = os.path.join(OUT, "prior_vqvae.npz")
    _prior_vqvae(ckpt, data)
    common = ["-restore", ckpt, "-params", params_json, "-data", data,
              "-device", "cuda"]
    launches: dict = {}
    for dtype in ("f32", "bf16"):
        vq_kernels.launches = 0
        res = prior_cli.main(common + [
            "-length", "6656", "-batch", "8", "-step", "20", "-save",
            os.path.join(OUT, f"prior_{dtype}"), "-train_dtype", dtype,
            "-interval", "1000", "-ckpt_interval", "1000", "-log_every",
            "1"])
        counts = {"vq_argmin": vq_kernels.launches}
        print()
        steady = res["step_seconds"][2:]
        log(f"[prior] train {dtype}: nll {res['nll'][0]:.4f} -> "
            f"{res['nll'][-1]:.4f}, code perplexity "
            f"{res['code_perplexity'][0]:.1f} -> "
            f"{res['code_perplexity'][-1]:.1f}; "
            f"{len(steady) / sum(steady):.3f} steps/s over steps 3-20 (host "
            f"clock, synchronised; first step {res['step_seconds'][0]:.2f} "
            f"s); launches {counts}  ({card})")
        if not np.isfinite(res["nll"]).all() or res["step"] != 20:
            raise AssertionError(f"[prior] {dtype} training failed")
        if counts["vq_argmin"] < 1:
            raise AssertionError("[prior] the VQ kernel was never launched")
        _add(launches, counts)
    vq_kernels.launches = 0
    gen_kernels.launches = gen_kernels.int8_launches = 0
    res = prior_cli.main(common + [
        "-prior", os.path.join(OUT, "prior_bf16"), "-sample", "4",
        "-seconds", "1.0", "-speakers", "p225", "p226", "p225", "None"])
    counts = {"gen_wavenet": gen_kernels.launches}
    outs = [wavfile.read(p)[1] for p in res["paths"]]
    if len(outs) != 4 or any(o.shape != (16000,) or not np.isfinite(o).all()
                             or np.abs(o).max() > 1.0 for o in outs):
        raise AssertionError("[prior] expected four finite 16,000-sample "
                             "wavs in [-1, 1]")
    if counts["gen_wavenet"] < 1:
        raise AssertionError("[prior] the generation kernel was never "
                             "launched")
    log(f"[prior] sample: 4x16000 samples in {res['gen_seconds']:.3f} s of "
        f"generation ({res['samples'] / res['gen_seconds']:,.0f} samples/s "
        f"aggregate, {res['gen_seconds'] / 16000 * 1e6:.1f} us a sample "
        f"step at B=4; codes and decode {res['seconds']:.3f} s, host clock); "
        f"launches {counts}  ({card})")
    _add(launches, counts)
    return launches



def _prior_case(device):
    """The prior of the shipped config (k=512, gc 64) with its init, and
    random codes [8, 104] and speaker vectors [8, 1, 64] from SP_SEED."""
    from vqvae_wavenet_torch.models.prior import init_prior_params_np
    from vqvae_wavenet_torch.params import to_torch
    rng = np.random.default_rng(SP_SEED)
    params = to_torch(init_prior_params_np(512, gc_channels=64), device)
    codes = torch.from_numpy(rng.integers(0, 512, (8, 104))).to(device)
    h = torch.from_numpy(rng.standard_normal((8, 1, 64)).astype(
        np.float32)).to(device)
    return params, codes, h


def _dp_rank(sh, B: int, dtypes, cli_args: dict):
    """One rank of [dp] (its contiguous B/N rows): per train_dtype the DP
    loss, the summed gradients (rank 0) and the new batch-norm running
    statistics of _sp_case's batch and weights, and the warm host ms of
    one more call; the prior's DP loss and gradients; then the training
    CLI's own rank function (train._rank) for a few steps, its kernels'
    counters set to 0 just before and read just after."""
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.ops import (epilogue_kernels, train_kernels,
                                         vq_kernels)
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.parallel.mesh import rank_rows
    from vqvae_wavenet_torch.prior import prior_loss_and_grads
    from vqvae_wavenet_torch.training.optimizer import tree_leaves
    from vqvae_wavenet_torch.training.train_loop import dp_loss_and_grads
    set_full_f32()
    out = {"backend": sh.backend}
    for dtype in dtypes:
        cfg, p, s, x, y = _sp_case(B, dtype, sh.device)
        batch = {"x": rank_rows(x, sh), "y": rank_rows(y, sh)}
        loss, aux, grads = dp_loss_and_grads(p, s, cfg, batch, sh)
        out[dtype] = {
            "loss": float(loss),
            "grads": ([g.float().cpu().numpy() for g in grads]
                      if sh.rank == 0 else None),
            "bn": [t.cpu().numpy()
                   for t in tree_leaves(aux["state"]["encoder"])],
            "ms": _host_ms(lambda: dp_loss_and_grads(p, s, cfg, batch, sh),
                           sh.device)}
        del grads, aux
    params, codes, h = _prior_case(sh.device)
    loss, grads = prior_loss_and_grads(params, rank_rows(codes, sh),
                                       rank_rows(h, sh), sh=sh)
    out["prior"] = {"loss": float(loss), "grads": (
        [g.cpu().numpy() for g in grads] if sh.rank == 0 else None)}
    vq_kernels.launches = 0
    train_kernels.fwd_launches = train_kernels.bwd_launches = 0
    epilogue_kernels.fwd_launches = epilogue_kernels.bwd_launches = 0
    res = train_cli._rank(sh, cli_args)
    out["train"] = {k: res[k] for k in ("losses", "step_seconds", "path",
                                        "launches")}
    return out


def _check_bn(tag, dtype, got, ref, old,
              what: str = "batch-norm running statistics") -> float:
    """The new batch-norm running statistics' (or another state's) change
    from ``old``: within TRAIN_TOL[dtype] of the leaf's largest change,
    plus 1e-6 of the largest change of any leaf.  Returns the largest
    share of the bound."""
    dref = [r.cpu().double().numpy() - o.cpu().double().numpy()
            for r, o in zip(ref, old)]
    dgot = [np.asarray(g, np.float64) - o.cpu().double().numpy()
            for g, o in zip(got, old)]
    top = max(np.abs(d).max() for d in dref)
    worst = max(np.abs(g - r).max() / (TRAIN_TOL[dtype] * np.abs(r).max()
                                       + 1e-6 * top)
                for g, r in zip(dgot, dref))
    log(f"[{tag}] {dtype}: {what} after one step, {len(dref)} leaves: "
        f"largest share of the bound {worst:.3g}")
    if worst >= 1:
        raise AssertionError(f"[{tag}] {dtype}: the {what} disagree with "
                             f"the single device")
    return worst


def _dp_generation(card: str) -> dict:
    """generate_sharded over [cuda:0, cuda:0] at B=4 x 2,048 samples of the
    shipped decoder (random weights, a random 128-channel condition of 32
    frames): bf16 and int8 in sample mode, each shard bit for bit the
    single-device call on its streams with its own generator; f32 greedy
    against the full-batch call by [gen]'s rule (identical bins, or a
    first divergence at a near tie).  Then vqvae_wavenet_torch.generate
    with -data_shards = the device count.  With two or more cards, the
    sharded call over every card (B = the card count) timed cold and warm
    beside one card's call at the same B.  Returns the launches of the
    sharded calls and the CLI run."""
    from vqvae_wavenet_torch import generate as gen_cli
    from vqvae_wavenet_torch.generation.fast import generate
    from vqvae_wavenet_torch.ops import gen_kernels, vq_kernels
    from vqvae_wavenet_torch.parallel.genshard import (generate_sharded,
                                                       shard_generators)
    cfg, dec = _gen_model(seed=3)
    g = torch.Generator(device="cpu").manual_seed(21)
    lc = torch.randn((4, 32, 128), generator=g).cuda()
    devices = [torch.device("cuda", 0)] * 2
    launches = {"gen_wavenet": 0, "gen_wavenet_int8": 0}
    length = 2048
    for dtype in (torch.bfloat16, torch.int8):
        gen_kernels.launches = gen_kernels.int8_launches = 0
        t0 = time.perf_counter()
        got = generate_sharded(dec, cfg.wavenet, lc, length=length,
                               devices=devices, mode="sample", dtype=dtype,
                               generator=torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _add(launches, {"gen_wavenet": gen_kernels.launches,
                        "gen_wavenet_int8": gen_kernels.int8_launches})
        gens = shard_generators(torch.Generator().manual_seed(5), 2)
        same = [torch.equal(got[2 * i:2 * i + 2], generate(
            dec, cfg.wavenet, lc[2 * i:2 * i + 2], length=length,
            mode="sample", dtype=dtype, generator=gens[i]))
            for i in range(2)]
        log(f"[dp] generate_sharded {dtype}, 2 shards on one card, B=4 x "
            f"{length}, sample: each shard bitwise its single-device call "
            f"{same}; {secs:.3f} s (host clock)  ({card})")
        if not all(same) or not torch.isfinite(got).all():
            raise AssertionError(f"[dp] sharded generation ({dtype}) differs "
                                 f"from its shards' single-device calls")
    got = generate_sharded(dec, cfg.wavenet, lc, length=length,
                           devices=devices, mode="greedy")
    ref = generate(dec, cfg.wavenet, lc, length=length, mode="greedy")
    diff = (got != ref).any(dim=0).nonzero()
    if len(diff):
        from vqvae_wavenet_torch.ops import gen_kernels as gk
        first = int(diff[0])
        row = int((got[:, first] != ref[:, first]).nonzero()[0])
        w32 = gk.pack_gen_params(dec, cfg.wavenet, torch.float32, "cuda")
        gcon, g_pp1 = gk.condition_terms(dec, w32, 1)
        _, lp = gk.generate_clip_plain(w32, lc[row:row + 1], gcon, g_pp1,
                                       length=first + 1, want_logits=True)
        top2 = torch.topk(lp[0, first], 2).values
        margin = float(top2[0] - top2[1])
        log(f"[dp] generate_sharded f32 greedy: first divergence from the "
            f"full batch at step {first} (stream {row}), top-two margin "
            f"{margin:.3g}")
        if margin > GREEDY_TIE:
            raise AssertionError("[dp] sharded greedy f32 diverges away from "
                                 "a near tie")
    else:
        log(f"[dp] generate_sharded f32 greedy, 2 shards: waveform "
            f"identical to the full-batch call")
    n = torch.cuda.device_count()
    if n >= 2:      # shards on different cards run at once
        every = [torch.device("cuda", i) for i in range(n)]
        lcn = torch.randn((n, 32, 128), generator=g).cuda()
        gen_kernels.launches = 0

        def sharded():
            generate_sharded(dec, cfg.wavenet, lcn, length=length,
                             devices=every, mode="sample",
                             dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(7))
        times = [_host_ms(sharded, "cuda") for _ in range(2)]
        _add(launches, {"gen_wavenet": gen_kernels.launches})
        one = _host_ms(lambda: generate(
            dec, cfg.wavenet, lcn, length=length, mode="sample",
            dtype=torch.bfloat16,
            generator=torch.Generator().manual_seed(7)), "cuda")
        log(f"[dp] generate_sharded over {n} cards, B={n} x {length} bf16 "
            f"sample: {times[0]:.1f} ms cold (each card's first launch), "
            f"{times[1]:.1f} ms warm, against {one:.1f} ms for B={n} on one "
            f"card (host clock)  ({card})")
    speakers = (["p225", "p226"] * n)[:max(2, n)]
    vq_kernels.launches = 0
    gen_kernels.launches = gen_kernels.int8_launches = 0
    res = gen_cli.main(["-restore", _e2e_checkpoint(), "-audio", _e2e_wav(),
                        "-speakers", *speakers, "-mode", "sample",
                        "-params", os.path.join(REPO, "model_parameters.json"),
                        "-data", os.path.join(REPO, "data"), "-device", "cuda",
                        "-data_shards", str(n)])
    counts = {"vq_argmin": vq_kernels.launches,
              "gen_wavenet": gen_kernels.launches}
    if res["audio"].shape != (len(speakers), 8192) or not np.isfinite(
            res["audio"]).all() or counts["gen_wavenet"] < n:
        raise AssertionError(f"[dp] generate -data_shards {n} failed: "
                             f"{res['audio'].shape}, {counts}")
    log(f"[dp] generate -data_shards {n}, {len(speakers)} speakers: "
        f"{res['seconds']:.3f} s for {len(speakers)}x8192 samples (host "
        f"clock); launches {counts}  ({card})")
    _add(launches, counts)
    return launches


def phase_dp(card: str):
    """Data parallelism on the card.
    (a) 2 ranks (on a one-card machine both on the card, over gloo, every
        exchange staged through host memory) at a global B=8 x 6656, _sp_case's weights and batch, f32
        and bf16: the loss (f32 rtol 2e-4, bf16 2e-2) and the summed
        gradients (_check_sp_grads) against the single-device
        loss_and_grads on the whole batch, and the new batch-norm running
        statistics (_check_bn); the prior's 2-rank loss (rtol 2e-4) and
        gradients (f32 rule) against its single-device step; then four
        bf16 steps through train._rank (the training CLI's rank function)
        on the synthetic corpus: finite losses, rank 0's checkpoint, every
        rank launched the VQ, stack and loss-head kernels.
    (b) Sharded generation (_dp_generation).
    (c) With two or more cards: vqvae_wavenet_torch.train -batch 8 (a rank
        a card, NCCL) six steps in bf16, steps/s.
    Returns the main-path launches of (a)-(c), summed over the ranks."""
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.parallel import run_ranks
    from vqvae_wavenet_torch.prior import prior_loss_and_grads
    from vqvae_wavenet_torch.training.optimizer import tree_leaves
    from vqvae_wavenet_torch.training.train_loop import loss_and_grads
    data = _train_corpus()
    dtypes = ("f32", "bf16")
    ref = {}
    for dtype in dtypes:
        cfg, p, s, x, y = _sp_case(8, dtype, "cuda")
        loss, aux, grads = loss_and_grads(p, s, cfg, {"x": x, "y": y})
        ref[dtype] = (float(loss), [g.float().cpu() for g in grads],
                      tree_leaves(aux["state"]["encoder"]),
                      tree_leaves(s["encoder"]))
        del p, grads, aux
    params, codes, h = _prior_case("cuda")
    p_loss, p_grads = prior_loss_and_grads(params, codes, h)
    p_grads = [g.cpu() for g in p_grads]
    torch.cuda.empty_cache()
    dp_save = os.path.join(OUT, "dp_train")
    if os.path.isdir(dp_save):
        import shutil
        shutil.rmtree(dp_save)
    cli = vars(train_cli.parse_args([
        "-dataset", "VCTK", "-length", "6656", "-batch", "8", "-step", "4",
        "-save", os.path.join(dp_save, "weights"), "-params",
        _train_config("bf16"), "-data", data, "-device", "cuda",
        "-log_every", "1", "-interval", "4", "-ckpt_interval", "1000"]))
    t0 = time.perf_counter()
    res = run_ranks(_dp_rank, 2, "cuda", 8, dtypes, cli, timeout=600)
    secs = time.perf_counter() - t0
    for dtype in dtypes:
        losses = [r[dtype]["loss"] for r in res]
        rel = abs(losses[0] - ref[dtype][0]) / abs(ref[dtype][0])
        log(f"[dp] 2 ranks B=8 {dtype}: loss {losses[0]:.6f} on every rank "
            f"{len(set(losses)) == 1}, single device {ref[dtype][0]:.6f} "
            f"(relative {rel:.3g}); warm, rank 0: loss and gradients "
            f"{res[0][dtype]['ms']:.1f} ms ({res[0]['backend']}, host "
            f"clock)  ({card})")
        if len(set(losses)) != 1 or not rel <= (2e-4 if dtype == "f32"
                                                 else 2e-2):
            raise AssertionError(f"[dp] {dtype}: loss disagrees")
        _check_sp_grads("dp 2 ranks", dtype, res[0][dtype]["grads"],
                        ref[dtype][1], ref["f32"][1])
        for r in res:
            _check_bn("dp 2 ranks", dtype, r[dtype]["bn"], ref[dtype][2],
                      ref[dtype][3])
    rel = abs(res[0]["prior"]["loss"] - float(p_loss)) / abs(float(p_loss))
    log(f"[dp] prior 2 ranks: nll {res[0]['prior']['loss']:.6f}, single "
        f"device {float(p_loss):.6f} (relative {rel:.3g})")
    if not rel <= 2e-4:
        raise AssertionError("[dp] the prior's DP loss disagrees")
    _check_sp_grads("dp prior 2 ranks", "f32", res[0]["prior"]["grads"],
                    p_grads)
    launches: dict = {}
    for r in res:
        t = r["train"]
        if not np.isfinite(t["losses"]).all() or min(
                t["launches"][k] for k in (
                    "vq_argmin", "train_stack_fwd", "train_stack_bwd",
                    "train_epilogue_fwd", "train_epilogue_bwd")) < 1:
            raise AssertionError(f"[dp] a rank's training run failed or "
                                 f"missed a kernel: {t}")
        _add(launches, {k: v for k, v in t["launches"].items() if v})
    steady = res[0]["train"]["step_seconds"][2:]
    layout = ("both ranks on one card, gloo staged through host memory"
              if res[0]["backend"] == "gloo" else "a card per rank, NCCL")
    log(f"[dp] train._rank, 2 ranks ({layout}) bf16: losses "
        + " ".join(f"{v:.4f}" for v in res[0]["train"]["losses"])
        + f"; {len(steady) / sum(steady):.3f} steps/s over steps 3-4 (host "
        f"clock); {secs:.1f} s for the spawned run; launches per rank "
        f"{[r['train']['launches'] for r in res]}  ({card})")
    if not os.path.exists(res[0]["train"]["path"] + ".npz"):
        raise AssertionError("[dp] rank 0 wrote no checkpoint")
    _check_event_file("dp summaries, rank 0 of 2", dp_save, 4,
                      _train_config("bf16"), card)
    del res, ref
    torch.cuda.empty_cache()

    _add(launches, _dp_generation(card))

    n = torch.cuda.device_count()
    if n < 2:
        log("[dp] NCCL (a card per rank): not run, this machine has one card")
        return launches
    cli = dict(cli, num_steps=6, interval=1000,
               save_path=os.path.join(OUT, "dp_nccl", "weights"))
    for world in sorted({2, n}):
        if world < n:      # fewer ranks than cards: the CLI's rank function
            runs = run_ranks(train_cli._rank, world, "cuda", cli,
                             timeout=600)
            res = dict(runs[0], launches=[r["launches"] for r in runs])
        else:              # the CLI itself: gcd(8, n) ranks, a card each
            res = train_cli.main([
                "-dataset", "VCTK", "-length", "6656", "-batch", "8",
                "-step", "6", "-save", cli["save_path"], "-params",
                cli["parameter_path"], "-data", data, "-device", "cuda",
                "-log_every", "1", "-interval", "1000", "-ckpt_interval",
                "1000"])
        print()
        steady = res["step_seconds"][2:]
        ranks = (len(res["launches"]) if isinstance(res["launches"], list)
                 else 1)
        log(f"[dp] NCCL, {ranks} ranks (a card each), global B=8 bf16: "
            f"losses " + " ".join(f"{v:.4f}" for v in res["losses"])
            + f"; {len(steady) / sum(steady):.3f} steps/s over steps 3-6 "
            f"(host clock, synchronised)  ({card})")
        if not np.isfinite(res["losses"]).all():
            raise AssertionError("[dp] non-finite NCCL training loss")
        for r in (res["launches"] if ranks > 1 else [res["launches"]]):
            _add(launches, {k: v for k, v in r.items() if v})
    return launches


def _zero_counts() -> None:
    from vqvae_wavenet_torch.ops import (epilogue_kernels, train_kernels,
                                         vq_kernels)
    vq_kernels.launches = 0
    for k in ("fwd", "bwd", "fwd_sp", "bwd_sp", "chain", "dk"):
        setattr(train_kernels, f"{k}_launches", 0)
    epilogue_kernels.fwd_launches = epilogue_kernels.bwd_launches = 0


def _mesh_rank(sh, B: int, runs):
    """One rank of [sp-mesh]: for each (case, dtype, decoder halo) of
    ``runs`` the SP loss and gradients of _sp_case's batch and weights on
    this rank's rows and time slice (rank 0 returns the gradients and the
    new model state), the kernels' launches of that call (counters set to
    0 just before, read just after), and the warm host ms of one more
    call; under vq_mode 'ema' also one train_step's new codebook and EMA
    state."""
    import functools
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.parallel.mesh import rank_rows
    from vqvae_wavenet_torch.parallel.timeshard import sp_loss_and_grads
    from vqvae_wavenet_torch.training.optimizer import tree_leaves
    from vqvae_wavenet_torch.training.train_loop import (init_train_state,
                                                         train_step)
    set_full_f32()
    out = {"backend": sh.backend}
    for name, dtype, halo in runs:
        cfg, p, s, x, y = _sp_case(B, dtype, sh.device, name)
        t_l = x.shape[1] // sh.n_time
        batch = {"x": rank_rows(x, sh)[:, sh.time_rank * t_l:
                                      (sh.time_rank + 1) * t_l].contiguous(),
                 "y": rank_rows(y, sh)}
        fn = functools.partial(sp_loss_and_grads, sh=sh, decoder_halo=halo)
        _zero_counts()
        loss, aux, grads = fn(p, s, cfg, batch)
        counts = train_cli._launch_counts()
        r = {"loss": float(loss), "launches": counts,
             "grads": ([g.float().cpu().numpy() for g in grads]
                       if sh.rank == 0 else None),
             "state": [t.cpu().numpy() for t in
                       tree_leaves(aux.get("state", {}).get("encoder", {}))],
             "ms": _host_ms(lambda: fn(p, s, cfg, batch), sh.device)}
        del grads, aux
        if cfg.use_vq and cfg.vq_mode == "ema":
            ts, _ = train_step(init_train_state(p, s), batch, cfg,
                               grads_fn=fn, sh=sh)
            r["ema"] = [t.cpu().numpy() for t in tree_leaves(
                [ts["params"]["vq"], ts["model_state"]["vq"]])]
        out[(name, dtype, halo)] = r
    return out


def _mesh_reference(name, dtype, B):
    """The single-device step of the case on the whole batch: (loss, grads
    on the CPU, the new encoder state and the old, and under 'ema' the new
    codebook and EMA state and the old)."""
    from vqvae_wavenet_torch.training.optimizer import tree_leaves
    from vqvae_wavenet_torch.training.train_loop import (
        init_train_state, loss_and_grads, train_step)
    cfg, p, s, x, y = _sp_case(B, dtype, "cuda", name)
    batch = {"x": x, "y": y}
    loss, aux, grads = loss_and_grads(p, s, cfg, batch)
    ref = {"loss": float(loss), "grads": [
        (torch.zeros_like(t) if g is None else g).float().cpu()
        for t, g in zip(tree_leaves(p), grads)],
        "state": [t.cpu() for t in tree_leaves(aux.get("state", {}).get(
            "encoder", {}))],
        "old": [t.cpu() for t in tree_leaves(s.get("encoder", {}))]}
    if cfg.use_vq and cfg.vq_mode == "ema":
        ts, _ = train_step(init_train_state(p, s), batch, cfg)
        ref["ema"] = [t.cpu() for t in tree_leaves(
            [ts["params"]["vq"], ts["model_state"]["vq"]])]
        ref["ema_old"] = [t.cpu() for t in tree_leaves([p["vq"], s["vq"]])]
    del p, s, grads, aux
    torch.cuda.empty_cache()
    return ref


def _mesh_check(tag, runs, res, refs, card) -> None:
    """Every run of every rank against the single device: the loss (f32
    rtol 2e-4, bf16 2e-2, equal on every rank), the gradients
    (_check_sp_grads; bf16 also against the f32 reference of the case),
    the new batch-norm statistics (_check_bn), the EMA codebook and state
    (_check_bn's rule); every rank launched the VQ and stack kernels, and
    the SP variants ran on some rank."""
    for run in runs:
        name, dtype, halo = run
        ref = refs[(name, dtype)]
        got = [r[run] for r in res]
        losses = [g["loss"] for g in got]
        rel = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
        log(f"[{tag}] {name} {dtype} halo {halo}: loss {losses[0]:.6f} on "
            f"every rank {len(set(losses)) == 1}, single device "
            f"{ref['loss']:.6f} (relative {rel:.3g}); warm loss and "
            f"gradients, rank 0: {got[0]['ms']:.1f} ms ({res[0]['backend']}"
            f", host clock); launches per rank "
            f"{[{k: v for k, v in g['launches'].items() if v} for g in got]}"
            f"  ({card})")
        if len(set(losses)) != 1 or not rel <= (2e-4 if dtype == "f32"
                                                 else 2e-2):
            raise AssertionError(f"[{tag}] {name} {dtype} {halo}: the loss "
                                 f"disagrees with the single device")
        _check_sp_grads(f"{tag} {name} {halo}", dtype, got[0]["grads"],
                        ref["grads"], refs[(name, "f32")]["grads"]
                        if (name, "f32") in refs else None)
        if any(bool((a != b).any()) for a, b in zip(ref["state"],
                                                    ref["old"])):
            for g in got:
                _check_bn(f"{tag} {name} {halo}", dtype, g["state"],
                          ref["state"], ref["old"])
        if "ema" in ref:
            for g in got:
                _check_bn(f"{tag} {name}", dtype, g["ema"], ref["ema"],
                          ref["ema_old"], "codebook and its EMA state")
        for g in got:
            c = g["launches"]
            if min(c["vq_argmin"], c["train_stack_fwd"]
                   + c["train_stack_fwd_sp"], c["train_stack_bwd"]
                   + c["train_stack_bwd_sp"]) < 1:
                raise AssertionError(f"[{tag}] {name} {halo}: a rank "
                                     f"launched no VQ or stack kernel: {c}")
        if min(sum(g["launches"][k] for g in got)
               for k in ("train_stack_fwd_sp", "train_stack_bwd_sp")) < 1:
            raise AssertionError(f"[{tag}] {name} {halo}: no SP variant "
                                 f"was launched")


def phase_sp_mesh(card: str):
    """The rest of sequence parallelism (SP) on the card: every rank's
    loss, summed gradients, new batch-norm statistics (and EMA codebook)
    against the single-device step on the whole batch (_mesh_check), with
    the kernels' launches of every rank.  On one card the ranks share it
    over gloo, every exchange staged through host memory; with as many
    cards as ranks they run over NCCL, a card each.
    (a) The data 2 x time 2 mesh: 4 ranks at a global B=8 x 6,656, the
        shipped config in f32 and bf16.
    (b) A time row of 2 ranks, B=8: the shipped config with the 'layer'
        and 'recompute' decoder halos (and 'fused' beside them, timed),
        f32 and bf16; the Magenta family's preset (50 layers, gc,
        sigmoid_first) in bf16 and f32; Encoder_Magenta (f32),
        Encoder_2019 at 6,400 samples in bf16 (its encoder f32),
        encoder_norm 'group' (f32) and vq_mode 'ema' (f32, one train_step:
        the codebook and its EMA state).
    (c) The CLI: -time_shards 2 -params magenta_parameters.json (bf16, six
        steps, B=8 x 6,656), then generate from rank 0's checkpoint;
        -time_shards 2 -decoder_halo layer (the shipped config, bf16, four
        steps); with four or more cards -time_shards 2 on every card: the
        data 2 x time 2 mesh over NCCL, steps/s.
    Returns the launches of (c)'s runs (every rank) and generation."""
    from scipy.io import wavfile
    from vqvae_wavenet_torch import generate as gen_cli
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.ops import gen_kernels
    from vqvae_wavenet_torch.parallel import run_ranks
    from vqvae_wavenet_torch.parallel.mesh import mesh_shape
    B = 8
    mesh_runs = [("shipped", d, "fused") for d in ("f32", "bf16")]
    row_runs = ([("shipped", d, h) for h in ("layer", "recompute", "fused")
                 for d in ("f32", "bf16")]
                + [("magenta", d, "fused") for d in ("bf16", "f32")]
                + [("magenta_enc", "f32", "fused"),
                   ("2019", "bf16", "fused"), ("2019", "f32", None),
                   ("group", "f32", "fused"), ("ema", "f32", "fused")])
    refs = {}
    for name, dtype, _ in mesh_runs + row_runs:
        if (name, dtype) not in refs:
            refs[(name, dtype)] = _mesh_reference(name, dtype, B)
    row_runs = [r for r in row_runs if r[2] is not None]  # f32 2019: ref only
    for tag, world, runs in (("sp-mesh data 2 x time 2", 4, mesh_runs),
                             ("sp-mesh time 2", 2, row_runs)):
        t0 = time.perf_counter()
        res = run_ranks(_mesh_rank, world, "cuda", B, runs, timeout=900,
                        n_time=2)
        log(f"[{tag}] {len(runs)} runs on {world} ranks "
            f"({res[0]['backend']}): {time.perf_counter() - t0:.1f} s for "
            f"the spawned run")
        _mesh_check(tag, runs, res, refs, card)
        del res
    del refs

    data = _train_corpus()
    launches: dict = {}
    cli = [("magenta bf16", _magenta_config("bf16"), 6, []),
           ("layer bf16", _train_config("bf16"), 4,
            ["-decoder_halo", "layer"])]
    n = torch.cuda.device_count()
    if n >= 4:
        cli.append((f"shipped bf16 on {n} cards", _train_config("bf16"), 6,
                    []))
    ckpt = None
    for tag, params_json, steps, flags in cli:
        save = os.path.join(OUT, "sp_mesh_" + tag.split()[0])
        res = train_cli.main([
            "-dataset", "VCTK", "-length", "6656", "-batch", "8", "-step",
            str(steps), "-save", os.path.join(save, "weights"), "-params",
            params_json, "-data", data, "-device", "cuda", "-log_every", "1",
            "-interval", "1000", "-ckpt_interval", "1000", "-time_shards",
            "2", *flags])
        print()
        steady = res["step_seconds"][2:]
        log(f"[sp-mesh] CLI -time_shards 2 {' '.join(flags)} {tag}: mesh "
            f"{mesh_shape(8, 2, 1, 'cuda')} (data, ranks), losses "
            + " ".join(f"{v:.4f}" for v in res["losses"])
            + f"; {len(steady) / sum(steady):.3f} steps/s over steps "
            f"3-{steps} (host clock, synchronised; first step "
            f"{res['step_seconds'][0]:.2f} s); launches per rank "
            f"{[{k: v for k, v in r.items() if v} for r in res['launches']]}"
            f"  ({card})")
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"[sp-mesh] {tag}: non-finite loss")
        if len(res["launches"]) != mesh_shape(8, 2, 1, "cuda")[1]:
            raise AssertionError(f"[sp-mesh] {tag}: {len(res['launches'])} "
                                 f"ranks")
        for r in res["launches"]:
            if min(r["vq_argmin"], r["train_stack_fwd_sp"]
                   + r["train_stack_fwd"]) < 1:
                raise AssertionError(f"[sp-mesh] {tag}: a rank missed a "
                                     f"kernel: {r}")
            _add(launches, {k: v for k, v in r.items() if v})
        if tag.startswith("magenta"):
            ckpt = res["path"] + ".npz"
    audio = os.path.join(OUT, "sp_input.wav")
    t = np.arange(2048) / 16000.0
    wavfile.write(audio, 16000, (0.3 * np.sin(2 * np.pi * 200.0 * t)
                                 * 32767).astype(np.int16))
    _zero_counts()
    g0 = gen_kernels.launches
    res = gen_cli.main(["-restore", ckpt, "-audio", audio, "-speakers",
                        "p226", "-mode", "greedy", "-params",
                        _magenta_config("bf16"), "-data", data, "-device",
                        "cuda"])
    if res["audio"].shape != (1, 2048) or not np.isfinite(
            res["audio"]).all():
        raise AssertionError("[sp-mesh] generation from the SP Magenta "
                             "checkpoint failed")
    launches["gen_wavenet"] = gen_kernels.launches - g0
    launches["vq_argmin"] = launches.get("vq_argmin", 0) + \
        train_cli._launch_counts()["vq_argmin"]
    log(f"[sp-mesh] generated {res['audio'].shape[1]} samples from the SP "
        f"Magenta checkpoint in {res['seconds']:.2f} s; main-path launches "
        f"{launches}")
    return launches


# the port's kernel wrappers: each launches in a profiler range of its name
TP_STEPS = 3


def _tp_bytes(specs, params, n_model: int) -> tuple:
    """(one device's, one model rank's) bytes of params + gradients + the
    two Adam moments + the EMA shadows: 5 float32 values a parameter, a
    split leaf's 1/n_model of them on a rank."""
    from vqvae_wavenet_torch.training.optimizer import tree_leaves
    whole = mine = 0
    for p, axis in zip(tree_leaves(params), tree_leaves(specs)):
        whole += p.numel()
        mine += p.numel() // (n_model if axis is not None else 1)
    return 20 * whole, 20 * mine


def _tp_rank(sh, B: int, dtypes, steps: int, want: bool):
    """One rank of [tp]: per train_dtype, _sp_case's weights and batch (B
    clips), the rank's shard_state of a fresh train state and its rows;
    ``steps`` TP steps (mesh_train_step), the training kernels' counters
    set to 0 just before and read just after; the first step's loss, and
    with ``want`` on rank 0 its gradients and new params joined into whole
    trees (numpy) and its new batch-norm statistics; after the steps the
    digests of every leaf the rules keep whole (params, EMA shadows, Adam
    moments, model state) and whether each split leaf is its slice of
    gather_state; the warm host ms of the last step and the peak device
    memory of the rank."""
    import hashlib
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.parallel.comm import own_slice
    from vqvae_wavenet_torch.parallel.mesh import (gather_state, gather_tree,
                                                   param_specs, rank_rows,
                                                   shard_state)
    from vqvae_wavenet_torch.training.optimizer import (tree_leaves,
                                                        tree_unflatten)
    from vqvae_wavenet_torch.training.train_loop import (
        dp_loss_and_grads, init_train_state, mesh_train_step)
    set_full_f32()
    out = {"backend": sh.backend}
    for dtype in dtypes:
        cfg, p, s, x, y = _sp_case(B, dtype, sh.device)
        ts = init_train_state(p, s)
        specs = param_specs(ts["params"], sh.n_model)
        mine = shard_state(ts, sh, specs)
        del ts, p
        skip_cols = mine["params"]["decoder"]["layers"]["skip_kernel"].shape[2]
        batch = {"x": rank_rows(x, sh), "y": rank_rows(y, sh)}
        seen = []

        def grads_fn(*args):
            seen.append(dp_loss_and_grads(*args, sh=sh, specs=specs))
            return seen[-1]
        step = mesh_train_step(cfg, sh, specs)
        _zero_counts()
        torch.cuda.reset_peak_memory_stats(sh.device)
        new, _ = step(mine, batch, grads_fn=grads_fn)
        loss, aux, grads = seen.pop()
        res = {"loss": float(loss), "skip_cols": skip_cols}
        grads = gather_tree(tree_unflatten(mine["params"], grads), sh, specs)
        whole = gather_state(new, sh, specs)
        if want and sh.rank == 0:
            res["grads"] = [g.float().cpu().numpy() for g in
                            tree_leaves(grads)]
            res["new"] = [t.cpu().numpy() for t in
                          tree_leaves(whole["params"])]
            res["bn"] = [t.cpu().numpy() for t in
                         tree_leaves(aux["state"]["encoder"])]
        del grads, aux, whole, seen
        ms = None
        for _ in range(steps - 1):
            (new, _), ms = _timed(lambda: step(new, batch), sh.device)
        res["launches"] = train_cli._launch_counts()
        res["peak_gb"] = torch.cuda.max_memory_allocated(sh.device) / 1e9
        res["step_ms"] = ms
        whole = gather_state(new, sh, specs)
        flat = tree_leaves(specs)
        kept, sliced = [], []
        for name in ("params", "ema_params", "mu", "nu", "model_state"):
            tree = new["opt_state"] if name in ("mu", "nu") else new
            ref = whole["opt_state"] if name in ("mu", "nu") else whole
            axes = flat if name != "model_state" else [None] * len(
                tree_leaves(tree[name]))
            for a, w, axis in zip(tree_leaves(tree[name]),
                                  tree_leaves(ref[name]), axes):
                if axis is None:
                    kept.append(hashlib.sha256(a.detach().contiguous().cpu()
                                               .numpy().tobytes()).hexdigest())
                else:
                    sliced.append(bool(torch.equal(a, own_slice(w, axis,
                                                                sh))))
        res.update(kept=kept, sliced=sliced)
        out[dtype] = res
        del new, mine, whole
        torch.cuda.empty_cache()
    return out


def _tp_reference(B: int, dtype: str):
    """The single-device step on _sp_case's whole batch: (loss, gradients
    on the CPU, new batch-norm statistics, old ones, new params and old
    ones on the CPU)."""
    from vqvae_wavenet_torch.training.optimizer import tree_leaves
    from vqvae_wavenet_torch.training.train_loop import (
        init_train_state, loss_and_grads, train_step)
    cfg, p, s, x, y = _sp_case(B, dtype, "cuda")
    ts = init_train_state(p, s)
    loss, aux, grads = loss_and_grads(p, s, cfg, {"x": x, "y": y})
    new, _ = train_step(ts, {"x": x, "y": y}, cfg)
    out = (float(loss), [g.float().cpu() for g in grads],
           [t.cpu() for t in tree_leaves(aux["state"]["encoder"])],
           [t.cpu() for t in tree_leaves(s["encoder"])],
           [t.cpu() for t in tree_leaves(new["params"])],
           [t.cpu() for t in tree_leaves(p)], cfg.learning_rate_schedule[0])
    del ts, new, aux, grads, p
    torch.cuda.empty_cache()
    return out


def _check_update(tag, got, ref, old, grads, lr: float) -> float:
    """The params after the TP step's first update, ``got``, from ``old``
    (f32 master weights): (a) equal, within 2 ulp of the value plus 1e-4
    lr, to Adam's first step (lr * g / (|g| + 1e-8)) worked out in float64
    from the TP step's own joined gradients ``grads`` (the sharded update
    is the whole one), and (b) within 2.5 lr of the single device's new
    params ``ref`` (its gradients differ by the order of sums, checked
    above; Adam's first step moves every element by about lr * sign(g), so
    a gradient within rounding of zero may take the other sign).  Returns
    the largest share of (a)'s bound and logs (b)'s."""
    eps32 = torch.finfo(torch.float32).eps
    worst = far = 0.0
    for a, r, o, g in zip(got, ref, old, grads):
        a = torch.from_numpy(np.asarray(a, np.float64))
        o, g = o.double(), torch.from_numpy(np.asarray(g, np.float64))
        ulp = 2 * eps32 * torch.maximum(a.abs(), o.abs())
        want = o - lr * g / (g.abs() + 1e-8)
        worst = max(worst, float(((a - want).abs()
                                  / (ulp + 1e-4 * lr)).max()))
        far = max(far, float(((a - o) - (r.double() - o)).abs().max()
                             / (2.5 * lr)))
    log(f"[{tag}] new params, {len(got)} leaves: against Adam's first step "
        f"on the TP gradients, largest share of the bound {worst:.3g}; "
        f"against the single-device step, largest share of 2.5 lr "
        f"{far:.3g}")
    if worst >= 1 or far >= 1:
        raise AssertionError(f"[{tag}] the updated params disagree")
    return worst


def _tp_stack_check(card: str) -> None:
    """The forward kernel (B4) at a model rank's S = 256 columns of the
    shipped skip_kernel against its plain twin, f32 and bf16 at B=8 x
    6656, and its time beside the S = 512 call's and the bound."""
    from vqvae_wavenet_torch.ops import train_kernels as tk
    for dtype in ("f32", "bf16"):
        cfg, w, x0, _ = _stack_inputs(8, 6656, 104, dtype, False, seed=3)
        kw = dict(dils=tuple(cfg.wavenet.dilation_rates),
                  gate_order="tanh_first")
        full = list(w)
        w[1] = w[1][:, :, :256].contiguous()
        sk, act, xs = tk.stack_forward_cuda(*w, x0, **kw)
        sp, act_p, _ = tk.stack_forward_plain(*w, x0, **kw)
        err = _check_leaves("tp stack S=256", dtype, {
            "skip_sum": (sk, sp), "act[0]": (act[0], act_p[0])})
        del sp, act_p
        ms = cuda_ms(lambda: tk.stack_forward_cuda(*w, x0, **kw), 3)
        ms512 = cuda_ms(lambda: tk.stack_forward_cuda(*full, x0, **kw), 3)
        L, K, R, D2 = w[0].shape
        D, S, N = D2 // 2, 256, 8 * 6656
        b = bound(2.0 * N * L * (K * R * D2 + D * (S + R)),
                  nbytes(*w, x0, sk, act, xs), dtype)
        log(f"[tp] stack forward kernel at S=256 (a model rank's columns), "
            f"{dtype} B=8 T=6656: {ms:.2f} ms against {ms512:.2f} ms at "
            f"S=512 in this run; bound {b[0]:.2f} ms by {b[1]}; largest "
            f"share of the tolerance {err / TRAIN_TOL[dtype]:.3g}  ({card})")
        del sk, act, xs, w, full
        torch.cuda.empty_cache()


def phase_tp(card: str):
    """Tensor parallelism on the card, the shipped config at B=8 x 6,656.
    (a) data 1 x model 2 (both ranks on this card over gloo, staged
        through host memory, when it is the only one), f32 and bf16: the
        first step's loss ([dp]'s rtol: f32 2e-4, bf16 2e-2), its gradients
        joined over the row (_check_sp_grads), the updated params
        (_check_update) and the new batch-norm statistics (_check_bn)
        against the single-device step on the same batch and weights;
    (b) data 2 x model 2 (4 ranks) in bf16: the loss and gradients alike;
    both: after three steps every leaf the rules keep whole is bit for bit
        equal on every rank and every split leaf is its slice of
        gather_state; every rank launched the forward kernel at S = 256
        (its skip_kernel columns), the sweep, the VQ kernel and in bf16
        the loss head; the warm host ms of a step and each rank's peak
        memory, and the bytes of params + gradients + Adam + EMA a rank
        holds against one device's;
    (c) the forward kernel at S = 256 against its twin (_tp_stack_check);
    (d) the single-device step's warm ms and peak memory, f32 and bf16;
        with two or more cards: data 1 x model 2 over NCCL (a card a
        rank), bf16 steps/s and peak memory beside it; with four or more:
        data 2 x model 2 beside DP at 4 ranks.
    Returns the main-path launches of (a), (b) and (d), summed over the
    ranks."""
    from vqvae_wavenet_torch.parallel import run_ranks
    from vqvae_wavenet_torch.parallel.mesh import param_specs
    from vqvae_wavenet_torch.training.optimizer import tree_leaves
    refs = {d: _tp_reference(8, d) for d in ("f32", "bf16")}
    launches: dict = {}

    def check(tag, res, dtype, compare_update):
        r0 = res[0][dtype]
        loss, grads, bn, bn_old, new, old, lr = refs[dtype]
        rel = abs(r0["loss"] - loss) / abs(loss)
        log(f"[tp] {tag} {dtype}: loss {r0['loss']:.6f}, single device "
            f"{loss:.6f} (relative {rel:.3g}); warm step {r0['step_ms']:.1f}"
            f" ms on rank 0 ({res[0]['backend']}, host clock); peak memory "
            f"per rank " + " ".join(f"{r[dtype]['peak_gb']:.2f}" for r in res)
            + f" GB  ({card})")
        if not rel <= (2e-4 if dtype == "f32" else 2e-2):
            raise AssertionError(f"[tp] {tag} {dtype}: loss disagrees")
        _check_sp_grads(f"tp {tag}", dtype, r0["grads"], grads,
                        refs["f32"][1])
        if compare_update:
            _check_update(f"tp {tag} {dtype}", r0["new"], new, old,
                          r0["grads"], lr)
            _check_bn(f"tp {tag}", dtype, r0["bn"], bn, bn_old)
        kept = {tuple(r[dtype]["kept"]) for r in res}
        sliced = [all(r[dtype]["sliced"]) for r in res]
        log(f"[tp] {tag} {dtype}: after {TP_STEPS} steps the {len(r0['kept'])}"
            f" whole leaves bit for bit equal on all {len(res)} ranks "
            f"{len(kept) == 1}, every rank's {len(r0['sliced'])} split "
            f"leaves their slice of gather_state {all(sliced)}; skip_kernel "
            f"columns a rank {r0['skip_cols']}; launches per rank "
            f"{[r[dtype]['launches'] for r in res]}")
        need = ["vq_argmin", "train_stack_fwd", "train_stack_bwd"] + (
            ["train_epilogue_fwd", "train_epilogue_bwd"]
            if dtype == "bf16" else [])
        if len(kept) != 1 or not all(sliced) or r0["skip_cols"] != 256:
            raise AssertionError(f"[tp] {tag} {dtype}: the ranks drifted")
        for r in res:
            if min(r[dtype]["launches"][k] for k in need) < 1:
                raise AssertionError(f"[tp] {tag} {dtype}: a rank missed a "
                                     f"kernel: {r[dtype]['launches']}")
            _add(launches, {k: v for k, v in r[dtype]["launches"].items()
                            if v})

    t0 = time.perf_counter()
    res = run_ranks(_tp_rank, 2, "cuda", 8, ("f32", "bf16"), TP_STEPS, True,
                    n_model=2, timeout=600)
    log(f"[tp] data 1 x model 2: {time.perf_counter() - t0:.1f} s for the "
        f"spawned run")
    for dtype in ("f32", "bf16"):
        check("data 1 x model 2", res, dtype, True)
    del res
    t0 = time.perf_counter()
    res = run_ranks(_tp_rank, 4, "cuda", 8, ("bf16",), TP_STEPS, True,
                    n_model=2, timeout=600)
    log(f"[tp] data 2 x model 2: {time.perf_counter() - t0:.1f} s for the "
        f"spawned run")
    check("data 2 x model 2", res, "bf16", False)
    del res
    cfg, p, _, _, _ = _sp_case(8, "f32", "cpu")
    specs = param_specs(p, 2)
    whole, mine = _tp_bytes(specs, p, 2)
    split = sum(t.numel() for t, a in zip(tree_leaves(p), tree_leaves(specs))
                if a is not None)
    log(f"[tp] params + gradients + Adam moments + EMA shadows (float32): "
        f"{whole / 1e6:.1f} MB on one device, {mine / 1e6:.1f} MB on a rank "
        f"of model 2 ({(whole - mine) / 1e6:.1f} MB less; the split leaves "
        f"hold {split / 1e6:.2f} M values)")
    del refs
    torch.cuda.empty_cache()
    _tp_stack_check(card)

    from vqvae_wavenet_torch.training.train_loop import (init_train_state,
                                                         train_step)
    for dtype in ("f32", "bf16"):      # one card's step, for comparison
        cfg, p, s, x, y = _sp_case(8, dtype, "cuda")
        ts = init_train_state(p, s)
        del p, s
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TP_STEPS + 3):
            (ts, _), ms = _timed(lambda: train_step(ts, {"x": x, "y": y},
                                                    cfg), "cuda")
        log(f"[tp] one card, the single-device step {dtype} B=8: warm step "
            f"{ms:.1f} ms, {1e3 / ms:.3f} steps/s (host clock); peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (this process, "
            f"its other tensors included)  ({card})")
        del ts
        torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    if n < 2:
        log("[tp] NCCL (a card per rank): not run, this machine has one card")
        return launches
    meshes = [(2, 2)] + ([(4, 2), (4, 1)] if n >= 4 else [])
    for world, n_model in meshes:
        res = run_ranks(_tp_rank, world, "cuda", 8, ("bf16",), TP_STEPS + 3,
                        False, n_model=n_model, timeout=600)
        r = res[0]["bf16"]
        log(f"[tp] {res[0]['backend'].upper()}, data {world // n_model} x "
            f"model {n_model} (a card a rank), bf16 B=8: warm step "
            f"{r['step_ms']:.1f} ms, {1e3 / r['step_ms']:.3f} steps/s (host "
            f"clock); peak memory per rank "
            + " ".join(f"{q['bf16']['peak_gb']:.2f}" for q in res)
            + f" GB; whole leaves equal on every rank "
            f"{len({tuple(q['bf16']['kept']) for q in res}) == 1}  ({card})")
        if len({tuple(q["bf16"]["kept"]) for q in res}) != 1:
            raise AssertionError("[tp] NCCL ranks drifted")
        for q in res:
            _add(launches, {k: v for k, v in q["bf16"]["launches"].items()
                            if v})
    return launches


def phase_dryrun(card: str):
    """vqvae_wavenet_torch.dryrun.dryrun_multichip(8) on the card(s): the
    JAX dryrun's six rows (it prints them), eight ranks sharing the
    cards over gloo when there are fewer than eight; no rank imports JAX.
    The kernels' counters: the ranks' own (fresh processes), and this
    process's generation counters set to 0 just before.  Returns the
    launches summed over the ranks and this process."""
    from vqvae_wavenet_torch.dryrun import dryrun_multichip
    from vqvae_wavenet_torch.ops import gen_kernels
    gen_kernels.launches = 0
    t0 = time.perf_counter()
    res = dryrun_multichip(8, device="cuda", timeout=600)
    secs = time.perf_counter() - t0
    launches = {"gen_wavenet": gen_kernels.launches}
    for r in res["launches"]:
        _add(launches, {k: v for k, v in r.items() if v})
    log(f"[dryrun] 8 ranks on {torch.cuda.device_count()} card(s): "
        f"{secs:.1f} s; launches {launches}; JAX imported by a rank "
        f"{any(res['imported'])}  ({card})")
    need = ("vq_argmin", "train_stack_fwd", "train_stack_bwd",
            "train_stack_fwd_sp", "train_stack_bwd_sp", "gen_wavenet")
    if any(res["imported"]) or min(launches.get(k, 0) for k in need) < 1:
        raise AssertionError(f"[dryrun] a row missed a kernel or imported "
                             f"JAX: {launches}")
    return launches


PORT_RANGES = ("vq_argmin", "gen_wavenet", "gen_wavenet_int8",
               "train_stack_fwd", "train_stack_bwd", "train_stack_fwd_sp",
               "train_stack_bwd_sp", "train_stack_bwd_chain",
               "train_stack_bwd_dk", "train_epilogue_fwd",
               "train_epilogue_bwd")
LIBRARY_KERNEL = re.compile(r"gemm|cublas|cutlass|xmma|cudnn|convolve|"
                            r"winograd|fft|fprop|dgrad|wgrad", re.I)


def _trace_breakdown(path: str):
    """Device time by group in a -profile trace (Chrome JSON of
    torch.profiler).  A device event (kernel, copy, set) is matched to the
    runtime call that launched it (args.correlation), and that call to the
    innermost profiler ranges around it on its host thread: a port
    kernel's wrapper range names it, the "optimizer" range holds the
    update; the rest go by kernel name: cuBLAS/cuDNN (gemm, conv, ... in
    the name), copies and sets, elementwise and other.  Returns (host ms
    of each traced step, device busy ms of each (the union of the device
    events that start in it), {group: ms}, {kernel name: (ms, count)}
    outside the port's kernels)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ranges: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    steps = sorted((a, b) for k in ranges for a, b, n in ranges[k]
                   if n == "train_step")
    groups: dict = {}
    names: dict = {}
    spans = []
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        call = launch.get(e.get("args", {}).get("correlation"))
        inside = [] if call is None else [
            n for a, b, n in ranges.get((call["pid"], call["tid"]), [])
            if a <= call["ts"] <= b]
        port = [n for n in inside if n in PORT_RANGES]
        if port:
            group = port[0]
        elif "optimizer" in inside:
            group = "optimizer"
        elif cat != "kernel":
            group = "copies and sets"
        elif LIBRARY_KERNEL.search(e["name"]):
            group = "cuBLAS/cuDNN"
        else:
            group = "elementwise and other"
        groups[group] = groups.get(group, 0.0) + e["dur"] / 1e3
        if not port:
            ms, c = names.get(e["name"], (0.0, 0))
            names[e["name"]] = (ms + e["dur"] / 1e3, c + 1)
    busy, end = [0.0] * len(steps), -1.0
    for a, b in sorted(spans):     # the union, by the step it starts in
        a = max(a, end)
        for i, (s0, s1) in enumerate(steps):
            if b > a and s0 <= a <= s1:
                busy[i] += (b - a) / 1e3
        end = max(end, b)
    return [(b - a) / 1e3 for a, b in steps], busy, groups, names


def phase_profile(card: str):
    """vqvae_wavenet_torch.train -profile: the shipped config in bf16 at
    -batch 8 -length 6656 for 16 steps (counters set to 0 before, read
    after), steps 10-14 traced; the trace read back by _trace_breakdown
    into device ms a traced step by group and the idle share of the step
    (1 - device busy / host step time), and the ten largest kernels
    outside the port's; the trace must hold the stack, loss-head and VQ
    kernels.  The untraced steps' host time is printed beside the traced
    ones' (the tracer's own cost).  Returns the run's launches."""
    from vqvae_wavenet_torch import train as train_cli
    from vqvae_wavenet_torch.ops import (epilogue_kernels, train_kernels,
                                         vq_kernels)
    data = _train_corpus()
    vq_kernels.launches = 0
    train_kernels.fwd_launches = train_kernels.bwd_launches = 0
    epilogue_kernels.fwd_launches = epilogue_kernels.bwd_launches = 0
    res = train_cli.main([
        "-dataset", "VCTK", "-length", "6656", "-batch", "8", "-step", "16",
        "-save", os.path.join(OUT, "profile_train", "weights"), "-params",
        _train_config("bf16"), "-data", data, "-device", "cuda",
        "-log_every", "1", "-interval", "1000", "-ckpt_interval", "1000",
        "-profile", os.path.join(OUT, "profile")])
    print()
    counts: dict = {}
    for r in (res["launches"] if isinstance(res["launches"], list)
              else [res["launches"]]):     # a list when data-parallel
        _add(counts, r)
    t0 = time.perf_counter()
    hosts, busys, groups, names = _trace_breakdown(res["trace"])
    secs = time.perf_counter() - t0
    n, host, busy = len(hosts), sum(hosts), sum(busys)
    if n != 5 or not host > 0:
        raise AssertionError(f"[profile] expected 5 traced steps, found {n}")
    need = ("train_stack_fwd", "train_stack_bwd", "train_epilogue_fwd",
            "train_epilogue_bwd", "vq_argmin")
    missing = [k for k in need if groups.get(k, 0.0) <= 0]
    if missing:
        raise AssertionError(f"[profile] the trace holds no device time for "
                             f"{missing}: {groups}")
    untraced = [t for i, t in enumerate(res["step_seconds"], 1)
                if i > 2 and not 10 <= i <= 14]
    per = {k: round(v / n, 3) for k, v in sorted(
        groups.items(), key=lambda kv: -kv[1])}
    log(f"[profile] bf16 B=8 x 6656, steps 10-14 traced: host "
        f"{host / n:.2f} ms a step (untraced steps 3-9, 15-16: "
        f"{1e3 * sum(untraced) / len(untraced):.2f} ms), device busy "
        f"{busy / n:.2f} ms a step, idle {1 - busy / host:.1%} (by step: "
        + ", ".join(f"{h:.2f} ms host / {b:.2f} busy"
                    for h, b in zip(hosts, busys))
        + f"); device ms a step by group {json.dumps(per)}; trace read in "
        f"{secs:.1f} s  ({card})")
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:10]
    log(f"[profile] device events a traced step: "
        f"{sum(c for _, c in names.values()) / n:.1f} outside the port's "
        f"kernels; the largest outside them, ms a step (calls): "
        + "; ".join(f"{k[:70]} {v[0] / n:.3f} ({v[1] // n})"
                    for k, v in top))
    return {k: counts[k] for k in need}


PHASES = ("vq", "gen", "gen-int8", "e2e", "magenta", "train-stack",
          "train-epilogue", "train-e2e", "sp-stack", "sp-train",
          "train-bwd2", "magenta-train", "encoders", "prior", "dp",
          "sp-mesh", "profile", "train-cond", "q512", "standalone",
          "summaries", "visualise", "tp", "dryrun")


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
                "magenta-train": lambda: phase_magenta_train(card),
                "encoders": lambda: phase_encoders(card),
                "prior": lambda: phase_prior(card),
                "dp": lambda: phase_dp(card),
                "sp-mesh": lambda: phase_sp_mesh(card),
                "profile": lambda: phase_profile(card),
                "train-cond": lambda: phase_train_cond(card),
                "q512": lambda: phase_q512(card),
                "standalone": lambda: phase_standalone(card),
                "summaries": lambda: phase_summaries(card),
                "visualise": lambda: phase_visualise(card),
                "tp": lambda: phase_tp(card),
                "dryrun": lambda: phase_dryrun(card)}
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
    # the new paths' launches add to the earlier main paths' counts
    extra: dict = {}
    _add(extra, phase_train_cond(card))
    _add(extra, phase_q512(card))
    _add(extra, phase_standalone(card))
    _add(extra, phase_summaries(card))
    phase_visualise(card)
    _add(extra, phase_encoders(card))
    _add(extra, phase_prior(card))
    _add(extra, phase_dp(card))
    _add(extra, phase_sp_mesh(card))
    _add(extra, phase_profile(card))
    _add(extra, phase_tp(card))
    _add(extra, phase_dryrun(card))
    launches["vq_argmin"] += extra.pop("vq_argmin", 0)
    launches["gen_wavenet"] += extra.pop("gen_wavenet", 0)
    magenta["gen_wavenet_int8"] += extra.pop("gen_wavenet_int8", 0)
    _add(train_launches, extra)
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
