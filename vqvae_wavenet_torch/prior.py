"""Prior CLI of the port (the flags of the JAX package's prior.py, plus
-device): train a WaveNet prior over a trained VQ-VAE's
code sequences, then sample novel audio end to end (prior codes ->
codebook lookup -> the generation kernel).

    # train the prior against a trained VQ-VAE checkpoint (the port's .npz)
    python -m vqvae_wavenet_torch.prior -restore saved_model/weights-110640.npz \\
        -dataset VCTK -length 6656 -batch 8 -step 50000 -save saved_model/prior \\
        [-ema 0.999] [-train_dtype f32|bf16] [-prior_restore saved_model/prior]

    # sample novel audio (no conditioning wav needed)
    python -m vqvae_wavenet_torch.prior -restore saved_model/weights-110640.npz \\
        -prior saved_model/prior/weights-50000 -sample 4 -seconds 1.0 \\
        -speakers p225 p226 p227 None [-mode sample|greedy]

``-restore`` names the VQ-VAE (``params.load_npz``: its EMA parameters and
model state, as the JAX prior restores ``ema_params``).  Training encodes
each batch with the frozen encoder and the VQ search (the VQ kernel on the
card), and takes an Adam step (lr -lr, training/optimizer.py's algebra)
on the prior's mean code NLL, with the EMA shadow at decay -ema (0: the
shadow is the parameters themselves).  ``-train_dtype bf16`` casts the
prior's parameters (and the speaker vector) to bfloat16 for the forward;
the NLL and the master parameters stay float32.  Every -interval steps
the NLL and the code perplexity and usage of the batch go to
<save>/metrics.jsonl; <save>/weights-<step>.npz (training/checkpoint.py's
layout: params/ is the EMA shadow) is written every -ckpt_interval steps
and at the end, and -prior_restore resumes from one (a file, or the save
directory's newest).

``-sample N`` reads the prior checkpoint's params/ (the EMA shadow, or the
parameters when training ran with -ema 0), samples N code sequences of
-seconds (cut to whole latent frames) with temperature -temperature, looks
them up in the codebook, builds the local condition with each speaker
('None': the all-zero one-hot) and decodes all N clips in one launch of
the generation kernel on CUDA in bf16 (its plain twin in f32 on the CPU,
as the port's generate.py defaults); codes and decoder draw from numpy
seed 0 (the JAX prior.py's fixed keys); it writes
prior_<speaker>.wav (a repeated speaker gets _<index>) beside the prior.
-dataset takes VCTK, LibriSpeech or Aishell, as the training CLI does
(the manifests under -data; sampling without -speakers conditions on
the dataset's speaker count).  On a host with several GPUs
training is data-parallel as the JAX prior's step over the 'data' axis
(prior.py:239-253): gcd(-batch, GPU count) spawned ranks, each encoding and
taking the NLL of its contiguous slice of the batch (read by rank 0 and
broadcast), the gradients summed over the ranks before one identical
update, the NLL, code perplexity and usage over the whole batch; rank 0
alone prints and writes.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

SEED = 0
# the speaker tables' sizes a checkpoint of each dataset was trained with
# (JAX prior.py:126-128; VCTK's is the table generate.py pins)
SPEAKERS = {"VCTK": 109, "Aishell": 340, "LibriSpeech": 251}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-restore", dest="restore_path", required=True,
                        help="trained VQ-VAE weights (the port's .npz)")
    parser.add_argument("-params", default="model_parameters.json",
                        dest="parameter_path")
    parser.add_argument("-data", default="data/", dest="data_path")
    # training flags
    parser.add_argument("-dataset", default="VCTK")
    parser.add_argument("-length", default=6656, type=int, dest="max_len")
    parser.add_argument("-batch", default=8, type=int, dest="batch_size")
    parser.add_argument("-step", default=50000, type=int, dest="num_steps")
    parser.add_argument("-save", default="saved_model/prior",
                        dest="save_path")
    parser.add_argument("-lr", default=1e-3, type=float)
    parser.add_argument("-interval", default=200, type=int)
    parser.add_argument("-ckpt_interval", default=2000, type=int,
                        help="steps between prior checkpoints")
    parser.add_argument("-prior_restore", default=None, metavar="PATH",
                        help="resume prior training from a prior checkpoint "
                             "(weights-<step>, or the save dir for its "
                             "newest)")
    parser.add_argument("-ema", default=0.999, type=float, dest="ema_decay",
                        help="EMA decay of the prior's shadow parameters "
                             "(sampling reads the shadow); 0 disables")
    parser.add_argument("-train_dtype", default="f32",
                        choices=["f32", "bf16"],
                        help="bf16 runs the prior's forward in bfloat16 "
                             "(master parameters and the NLL stay f32)")
    parser.add_argument("-log_every", default=0, type=int, metavar="N",
                        help="print the nll line every N steps (0: every "
                             "step)")
    # sampling flags
    parser.add_argument("-prior", dest="prior_path",
                        help="trained prior checkpoint; enables sampling")
    parser.add_argument("-sample", type=int, default=0,
                        help="number of clips to sample")
    parser.add_argument("-seconds", type=float, default=1.0)
    parser.add_argument("-speakers", nargs="+", default=None)
    parser.add_argument("-mode", default="sample",
                        choices=["sample", "greedy"],
                        help="the decoder's sampling mode")
    parser.add_argument("-temperature", default=1.0, type=float)
    parser.add_argument("-device", default="cuda",
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


def _launch_counts() -> dict:
    from vqvae_wavenet_torch.ops import gen_kernels, vq_kernels
    return {"vq_argmin": vq_kernels.launches,
            "gen_wavenet": gen_kernels.launches,
            "gen_wavenet_int8": gen_kernels.int8_launches}


def main(argv=None):
    """Train the prior, or with -sample N sample from it.  Training returns
    {"nll", "code_perplexity" (at the printed steps), "step_seconds",
    "path", "step", "launches"} (per-step wall seconds end in a device
    synchronise on CUDA; with several data ranks "launches" is a list with
    one dict per rank and the rest rank 0's); sampling returns {"audio",
    "paths", "codes", "seconds", "gen_seconds", "samples", "launches"}."""
    args = parse_args(argv)
    from vqvae_wavenet_torch.generate import resolve_device
    from vqvae_wavenet_torch.parallel import run_ranks
    from vqvae_wavenet_torch.parallel.mesh import data_ranks

    if args.dataset not in SPEAKERS:
        raise NotImplementedError(f"dataset {args.dataset} not implemented")
    device = resolve_device(args.device)
    cfg = _vqvae_config(args)
    if args.sample > 0:
        return _sample(args, cfg, _load_vqvae(args, device)[0],
                       SPEAKERS[args.dataset], device)
    ranks = data_ranks(args.batch_size, device.type)
    if ranks == 1:
        return _train(args, device, None)
    results = run_ranks(_rank, ranks, device.type, vars(args))
    return dict(results[0], launches=[r["launches"] for r in results])


def _rank(sh, args: dict):
    """One data-parallel rank of prior training (spawned by run_ranks)."""
    return _train(argparse.Namespace(**args), sh.device, sh)


def _vqvae_config(args):
    from vqvae_wavenet_torch.config import ModelConfig
    cfg = ModelConfig.from_json(args.parameter_path)
    if not cfg.use_vq or cfg.model_family != "vqvae":
        raise ValueError("a prior needs a VQ-VAE model (use_vq=true)")
    return cfg


def _load_vqvae(args, device):
    """The VQ-VAE's (params, model state) on ``device``, f32 math."""
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.params import load_npz
    set_full_f32()
    return load_npz(args.restore_path, device)


def prior_loss_and_grads(params, codes: torch.Tensor, h, *,
                         bf16: bool = False, sh=None):
    """(the mean code NLL, its gradients in tree_leaves(params) order,
    zeros where the loss does not reach a parameter) of the prior on
    ``codes`` [B, T_lat] with speaker vectors ``h``; under
    ``bf16`` the parameters and h are cast to bfloat16 for the forward.
    With ``sh`` (a data-parallel rank's codes, equal parts): each rank
    backpropagates its share (local NLL / N), the gradients are summed over
    the ranks in float32 and the NLL is the mean over the ranks -- the
    single-device step on the whole batch (prior.py:239-253)."""
    from vqvae_wavenet_torch.models.prior import prior_loss
    from vqvae_wavenet_torch.models.vqvae import _cast
    from vqvae_wavenet_torch.parallel.comm import all_reduce_, sum_grads
    from vqvae_wavenet_torch.training.optimizer import (tree_leaves,
                                                        tree_unflatten)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        if bf16:
            p = _cast(p, torch.bfloat16)
            h = None if h is None else h.to(torch.bfloat16)
        loss = prior_loss(p, codes, h)
        grads = torch.autograd.grad(loss if sh is None else loss / sh.world,
                                    leaves, allow_unused=True)
    loss = loss.detach()
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    if sh is not None:
        grads = sum_grads(grads, sh)
        loss = all_reduce_(loss.reshape(1), sh)[0] / sh.world
    return loss, grads


def code_stats(codes: torch.Tensor, k: int, sh=None):
    """(perplexity, usage) of the batch's empirical code distribution (the
    prior's analogue of the VQ perplexity, prior.py:230-236), over every
    rank's codes with ``sh``."""
    from vqvae_wavenet_torch.parallel.comm import all_reduce_
    counts = torch.bincount(codes.reshape(-1), minlength=k).float()
    if sh is not None:
        all_reduce_(counts, sh)
    p = counts / counts.sum().clamp_min(1.0)
    return (torch.exp(-torch.sum(p * torch.log(p + 1e-10))),
            (p > 0).float().mean())


def _train(args, device, sh):
    """Prior training on one device (sh None) or as data-parallel rank
    sh.rank: this rank's contiguous slice of every batch, which rank 0
    reads and broadcasts; rank 0 alone prints and writes."""
    from vqvae_wavenet_torch.data import DATASETS
    from vqvae_wavenet_torch.models import encoders as enc
    from vqvae_wavenet_torch.models import vq as vq_mod
    from vqvae_wavenet_torch.models.prior import init_prior_params_np
    from vqvae_wavenet_torch.models.vqvae import speaker_vector
    from vqvae_wavenet_torch.params import to_torch
    from vqvae_wavenet_torch.parallel.mesh import (global_batch, rank_rows,
                                                   replicate_)
    from vqvae_wavenet_torch.training.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from vqvae_wavenet_torch.training.metrics import MetricWriter
    from vqvae_wavenet_torch.training.optimizer import fused_adam_ema_step
    from vqvae_wavenet_torch.training.train_loop import (init_train_state,
                                                         to_device)

    lead = sh is None or sh.rank == 0
    cfg = _vqvae_config(args)
    vq_params, model_state = _load_vqvae(args, device)
    dataset = DATASETS[args.dataset](
        batch_size=args.batch_size, max_len=args.max_len,
        relative_path=args.data_path, seed=0)
    shapes = {"x": (args.batch_size, args.max_len, 1),
              "y": (args.batch_size, 1, dataset.num_speakers)}
    gc_dim = (cfg.speaker_embedding if cfg.speaker_embedding > 0
              else dataset.num_speakers)
    if args.prior_restore is not None and lead:
        ts = to_device(restore_checkpoint(args.prior_restore), device)
    else:
        ts = init_train_state(to_torch(init_prior_params_np(
            cfg.k, gc_channels=gc_dim), device), {})
    if args.prior_restore is not None and sh is not None:
        ts = replicate_(ts, sh)
    gs = ts["step"]
    if lead:
        print(f"[prior restore] last prior step: {gs}")
        if sh is not None:
            print(f"[dp] {sh.world} data ranks of "
                  f"{args.batch_size // sh.world} clips, backend "
                  f"{sh.backend}")
    lr = float(np.float32(args.lr))
    bf16 = args.train_dtype == "bf16"

    @torch.no_grad()
    def encode_codes(x, y):
        z_e, _ = enc.encoder_forward(cfg.encoder, vq_params["encoder"],
                                     model_state.get("encoder", {}), x,
                                     norm=cfg.encoder_norm)
        q = vq_mod.quantize(vq_params["vq"], z_e, mode=cfg.vq_mode)
        return q["q_z_x"], speaker_vector(vq_params, cfg, y)

    writer = None
    if lead:
        os.makedirs(args.save_path, exist_ok=True)
        writer = MetricWriter(args.save_path)
    log_every = args.log_every or 1
    nll, perplexity, step_seconds = [], [], []
    t_win, last_print = time.perf_counter(), 0
    path = None
    if sh is None or sh.local_rank == 0:
        dataset.start()
    try:
        for step in range(1, 1 + args.num_steps):
            t0 = time.perf_counter()
            batch = global_batch(dataset.next, shapes, device, sh)
            if sh is not None:
                batch = {k: rank_rows(v, sh) for k, v in batch.items()}
            # the frozen encoder runs in inference mode: no statistics
            codes, h = encode_codes(batch["x"], batch["y"])
            loss, grads = prior_loss_and_grads(ts["params"], codes, h,
                                               bf16=bf16, sh=sh)
            params, ema, opt_state = fused_adam_ema_step(
                ts["params"], ts["ema_params"], ts["opt_state"], grads,
                lambda count: lr, ema_decay=args.ema_decay)
            ts = dict(ts, params=params, ema_params=ema, opt_state=opt_state,
                      step=ts["step"] + 1)
            ppl, usage = code_stats(codes, cfg.k, sh)
            metrics = {"nll": loss, "code_perplexity": ppl,
                       "code_usage": usage}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_seconds.append(time.perf_counter() - t0)
            if lead and (gs + step) % args.interval == 0:
                writer.scalars(gs + step, {f"prior/{k}": v
                                           for k, v in metrics.items()})
                writer.flush()
            if step % log_every == 0 or step == args.num_steps:
                nll.append(float(loss))
                perplexity.append(float(ppl))
                now = time.perf_counter()
                t = (now - t_win) / (step - last_print)
                t_win, last_print = now, step
                if lead:
                    print(f"\r[prior step {gs + step}] [nll {nll[-1]:.5f}] "
                          f"[perplexity {perplexity[-1]:.1f}] "
                          f"[batch {t:.3f}s]", end="")
                    sys.stdout.flush()
            if lead and step % args.ckpt_interval == 0:
                save_checkpoint(args.save_path, ts)
        if lead:
            path = save_checkpoint(args.save_path, ts)
            print(f"\nsaved prior to {path}")
    finally:
        dataset.stop()
        if writer is not None:
            writer.close()
    return {"nll": nll, "code_perplexity": perplexity,
            "step_seconds": step_seconds, "path": path, "step": ts["step"],
            "launches": _launch_counts()}


def _sample(args, cfg, vq_params, num_speakers, device):
    from scipy.io import wavfile
    from vqvae_wavenet_torch.generate import speaker_one_hots
    from vqvae_wavenet_torch.generation.fast import generate
    from vqvae_wavenet_torch.models.encoders import encoder_downsample_rate
    from vqvae_wavenet_torch.models.prior import prior_sample
    from vqvae_wavenet_torch.models.vqvae import (build_local_condition,
                                                  speaker_vector)

    if args.prior_path is None:
        raise ValueError("-sample needs -prior (a prior checkpoint)")
    prior_params = _read_prior(args.prior_path, device)
    b = args.sample
    if args.speakers:
        if len(args.speakers) != b:
            raise ValueError(f"-speakers names {len(args.speakers)} "
                             f"speakers for -sample {b}")
        y = speaker_one_hots(args.speakers, args.data_path)
    else:
        y = np.zeros((b, 1, num_speakers), np.float32)
    y = torch.from_numpy(y).to(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    downsample = encoder_downsample_rate(cfg.encoder)
    length = int(args.seconds * 16000) // downsample * downsample
    if length < downsample:
        raise ValueError(f"-seconds {args.seconds} is shorter than one "
                         f"latent frame ({downsample} samples)")
    t_lat = length // downsample

    t0 = time.perf_counter()
    generator = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        h = speaker_vector(vq_params, cfg, y)                 # [B, 1, gc]
        codes = prior_sample(prior_params, generator, batch_size=b,
                             length=t_lat, gc=h,
                             temperature=args.temperature)
        z_q = vq_params["vq"]["embedding"][codes]
        lc = build_local_condition(vq_params, cfg, z_q, y, target_len=length)
        t1 = time.perf_counter()
        audio = generate(vq_params["decoder"], cfg.wavenet, lc, length=length,
                         generator=generator, mode=args.mode, dtype=dtype,
                         verbose=True)
        audio = audio.cpu().numpy()
    t2 = time.perf_counter()
    print(f"[prior] {b}x{t_lat} codes in {t1 - t0:.2f}s, {b}x{length} "
          f"samples in {t2 - t1:.2f}s ({b * length / (t2 - t1):,.0f} "
          f"samples/s, including any first-use kernel build)")
    out_dir = (args.prior_path if os.path.isdir(args.prior_path)
               else os.path.dirname(os.path.abspath(args.prior_path)))
    paths, seen = [], set()
    for i in range(b):
        name = args.speakers[i] if args.speakers else f"sample{i}"
        if name in seen:
            name = f"{name}_{i}"
        seen.add(name)
        path = os.path.join(out_dir, f"prior_{name}.wav")
        wavfile.write(path, 16000, audio[i].astype(np.float32))
        paths.append(path)
    print(f"wrote {b} sampled wav(s) to {out_dir}")
    return {"audio": audio, "paths": paths, "codes": codes.cpu().numpy(),
            "seconds": t2 - t0, "gen_seconds": t2 - t1,
            "samples": b * length, "launches": _launch_counts()}


def _read_prior(path: str, device):
    """The prior's sampling parameters: a checkpoint's params/ (its EMA
    shadow; the parameters themselves under -ema 0).  ``path`` is a
    weights-<step> (with or without .npz) or a directory (its newest)."""
    from vqvae_wavenet_torch.params import load_tree
    from vqvae_wavenet_torch.training.checkpoint import latest_checkpoint
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no weights-<step>.npz in {path}")
        path = latest
    if not path.endswith(".npz"):
        path += ".npz"
    return load_tree(path, device, prefixes=("params",))["params"]


if __name__ == "__main__":
    main()
