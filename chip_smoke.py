#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  torch/CUDA versions and the card's name and power limit;
  2. build   compile csrc/vq_argmin.cu and csrc/gen_wavenet.cu with nvcc;
  3. vq      the VQ kernel against its plain twin at N = 384 and 65,536
             (k = 512, d = 64);
  4. gen     the generation kernel against its plain twin at the shipped
             wavenet_parameters.json widths with C = 128: teacher-forced
             logits (f32 and bf16), a greedy f32 clip, and sample-mode
             statistics at t = 0;
  5. e2e     the voice-conversion entry point (vqvae_wavenet_torch.generate)
             on a random full-width model_parameters.json model and a
             synthetic 8,192-sample wav, speakers p225 p226 None, in bf16
             and f32, greedy and sample; both kernels' launch counters are
             reset before and read after.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and
prints no result.  Outputs go under build/chip_smoke/ (gitignored).
"""
from __future__ import annotations

import json
import os
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

# tolerances (reasons in the phase docstrings)
F32_LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 5e-2
VQ_TIE_REL = 1e-5
GREEDY_TIE = 1e-4


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


def phase_build():
    from vqvae_wavenet_torch.ops import _build
    t0 = time.perf_counter()
    for name in ("vq_argmin", "gen_wavenet"):
        _build.load(name)
    log(f"[build] {time.perf_counter() - t0:.2f}s total; nvcc seconds per "
        f"source: {json.dumps({k: round(v, 2) for k, v in _build.build_seconds.items()})}")


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
    for n in (384, 65536):
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
        log(f"[vq] N={n} k={k} d={d}: mismatches {int((got != ref).sum())} "
            f"(outside ties {int(bad.sum())}), max |dist(kernel) - "
            f"dist(plain)| {err:.3g}; kernel {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us")
        if bad.any():
            raise AssertionError(f"VQ kernel disagrees with plain at N={n}")
        result[n] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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
            gcon, g_pp1 = gk.condition_terms(dec, w, b)
            kern = cuda_ms(lambda: gk.generate_clip_cuda(
                w, lcb, gcon, g_pp1, length=2048), 3) / 2048
            plain = cuda_ms(lambda: gk.generate_clip_plain(
                w, lcb[:, :1], gcon, g_pp1, length=64), 1) / 64
            times[(str(dtype).split(".")[-1], b)] = (kern, plain)
            log(f"[gen] {str(dtype).split('.')[-1]} B={b}: kernel "
                f"{kern * 1e3:.1f} us/sample, plain {plain * 1e3:.1f} "
                f"us/sample  ({card})")
    out["ms"], out["plain_ms"] = times[("bfloat16", 3)]
    return out


def phase_e2e(card: str):
    """The voice-conversion entry point at full width, through both
    kernels; returns the launch counts of the main-path runs."""
    from scipy.io import wavfile
    from vqvae_wavenet_torch import generate as gen_cli
    from vqvae_wavenet_torch.ops import gen_kernels, vq_kernels
    from vqvae_wavenet_torch.params import random_params_np, save_npz
    from vqvae_wavenet_torch.config import ModelConfig

    os.makedirs(OUT, exist_ok=True)
    cfg = ModelConfig.from_json(os.path.join(REPO, "model_parameters.json"))
    params, state = random_params_np(cfg, 109, seed=0)
    ckpt = os.path.join(OUT, "weights-0.npz")
    save_npz(ckpt, params, state)
    rng = np.random.default_rng(0)
    t = np.arange(8192) / 16000.0
    wav = (0.4 * np.sin(2 * np.pi * 180.0 * t) * (1 + 0.3 * np.sin(
        2 * np.pi * 3.0 * t)) + 0.02 * rng.standard_normal(t.size))
    audio = os.path.join(OUT, "input.wav")
    wavfile.write(audio, 16000, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    speakers = ["p225", "p226", "None"]

    vq_kernels.launches = 0
    gen_kernels.launches = 0
    for dtype in ("bf16", "f32"):
        for mode in ("greedy", "sample"):
            res = gen_cli.main([
                "-restore", ckpt, "-audio", audio, "-speakers", *speakers,
                "-mode", mode, "-params",
                os.path.join(REPO, "model_parameters.json"),
                "-data", os.path.join(REPO, "data"), "-dtype", dtype,
                "-device", "cuda", "-seed", "3"])
            outs = [wavfile.read(p)[1] for p in res["paths"]]
            if len(outs) != 3 or any(o.shape != (8192,) for o in outs):
                raise AssertionError("expected three 8192-sample wavs")
            for o in outs:
                if not (np.isfinite(o).all() and np.abs(o).max() <= 1.0):
                    raise AssertionError("non-finite or out-of-range audio")
            if np.array_equal(outs[0], outs[2]):
                raise AssertionError("'None' speaker output equals p225's")
            per_stream = res["samples"] / 3 / res["seconds"]
            log(f"[e2e] {dtype} {mode}: {res['seconds']:.3f}s for 3x8192 "
                f"samples: {per_stream:,.0f} samples/s per stream, "
                f"{3 * per_stream:,.0f} aggregate (encode + generate, host "
                f"clock)  ({card})")
    launches = {"vq_argmin": vq_kernels.launches,
                "gen_wavenet": gen_kernels.launches}
    log(f"[e2e] kernel launches in the main-path runs: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError("a kernel of the path was never launched")
    return launches


def main() -> int:
    card = phase_device()
    sys.path.insert(0, REPO)
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    set_full_f32()
    phase_build()
    vq = phase_vq()
    gen = phase_gen(card)
    launches = phase_e2e(card)
    kernels = [
        {"name": "vq_argmin", "route": "cuda", "source": VQ_SOURCE,
         "replaces": VQ_REPLACES, "launches": launches["vq_argmin"], **vq},
        {"name": "gen_wavenet", "route": "cuda", "source": GEN_SOURCE,
         "replaces": GEN_REPLACES, "launches": launches["gen_wavenet"],
         **gen},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
