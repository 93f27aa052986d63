"""Training CLI of the port (the flags of the JAX package's train.py,
which keeps the reference's train.py:12-37, plus -device):

    python -m vqvae_wavenet_torch.train -dataset VCTK -length 6656 -batch 8 \
        -step 100000 -save saved_model/weights [-restore saved_model/weights-N] \
        [-interval 200] [-params model_parameters.json] [-device cuda|cpu]

One step is vqvae_forward + autograd (the stack, loss-head and VQ kernels
on the card) + the fused Adam/EMA update.  Scalars go to
<save dir>/metrics.jsonl every -interval steps; the progress line prints
every -log_every steps; weights-<step>.npz is written every -ckpt_interval
steps and at the end (training/checkpoint.py; the port's generate.py
restores it).  The initial weights and the crop sampler draw from numpy
seed 0.  -time_shards > 1, -coordinator, -loader native and -profile
belong to parts that are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

SEED = 0


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-dataset", default="VCTK", type=str,
                        help="VCTK or LibriSpeech or Aishell", metavar="DATASET")
    parser.add_argument("-length", default=6656, type=int, dest="max_len",
                        metavar="int",
                        help="number of samples one audio will contain")
    parser.add_argument("-step", default=1000000, type=int, dest="num_steps",
                        metavar="int", help="number of steps to train")
    parser.add_argument("-batch", default=8, type=int, dest="batch_size",
                        metavar="int", help="batch size")
    parser.add_argument("-interval", default=200, type=int, dest="interval",
                        metavar="int", help="save log every interval step")
    parser.add_argument("-restore", dest="restore_path", metavar="string",
                        help="path to restore weights")
    parser.add_argument("-save", default="saved_model/weights",
                        dest="save_path", metavar="string",
                        help="path to save weights")
    parser.add_argument("-params", default="model_parameters.json",
                        dest="parameter_path", metavar="str",
                        help="path to parameters file")
    parser.add_argument("-data", default="data/", dest="data_path",
                        metavar="str", help="dataset root directory")
    parser.add_argument("-ckpt_interval", default=2000, type=int,
                        help="steps between checkpoints")
    parser.add_argument("-profile", default=None, metavar="DIR",
                        help="not ported (ROADMAP.md queue A)")
    parser.add_argument("-coordinator", default=None, metavar="HOST:PORT",
                        help="multi-host training: not ported (ROADMAP.md "
                             "queue A, DP)")
    parser.add_argument("-num_processes", default=None, type=int,
                        help="multi-host training: not ported (ROADMAP.md "
                             "queue A, DP)")
    parser.add_argument("-process_id", default=None, type=int,
                        help="multi-host training: not ported (ROADMAP.md "
                             "queue A, DP)")
    parser.add_argument("-log_every", default=1, type=int, metavar="N",
                        help="print the progress line every N steps")
    parser.add_argument("-loader", default="auto",
                        choices=["auto", "python", "native"],
                        help="input pipeline; the port has the python one "
                             "('native' is not ported)")
    parser.add_argument("-trim_silence", action="store_true",
                        help="trim leading/trailing silence before the "
                             "random crop (dataset.py:23-31)")
    parser.add_argument("-time_shards", default=1, type=int, metavar="N",
                        help="sequence parallelism: not ported (ROADMAP.md "
                             "queue A, SP)")
    parser.add_argument("-decoder_halo", default="auto",
                        choices=["auto", "fused", "layer", "recompute"],
                        help="SP decoder scheme: not ported (ROADMAP.md "
                             "queue A, SP)")
    parser.add_argument("-device", default="cuda",
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.time_shards > 1 or args.decoder_halo != "auto":
        raise NotImplementedError("-time_shards > 1 and -decoder_halo "
                                  "(sequence parallelism) are not ported "
                                  "yet: ROADMAP.md queue A, SP")
    if args.coordinator is not None or args.num_processes not in (None, 1) \
            or args.process_id not in (None, 0):
        raise NotImplementedError("-coordinator, -num_processes and "
                                  "-process_id (multi-host training) are not "
                                  "ported yet: ROADMAP.md queue A, DP")
    if args.loader == "native":
        raise NotImplementedError("-loader native (the C++ loader) is not "
                                  "ported yet: ROADMAP.md queue A")
    if args.profile is not None:
        raise NotImplementedError("-profile is not ported yet: ROADMAP.md "
                                  "queue A")


def main(argv=None):
    """Train; returns {"losses", "step_seconds", "path", "step"} (the
    per-step wall seconds end in a device synchronise on CUDA)."""
    args = parse_args(argv)
    _refuse_unported(args)
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.data import DATASETS
    from vqvae_wavenet_torch.generate import resolve_device
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    from vqvae_wavenet_torch.training.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from vqvae_wavenet_torch.training.metrics import MetricWriter, display_time
    from vqvae_wavenet_torch.training.train_loop import (
        init_train_state, to_device, train_step)

    device = resolve_device(args.device)
    set_full_f32()
    if args.dataset not in DATASETS:
        raise NotImplementedError(f"dataset {args.dataset} not implemented")
    dataset = DATASETS[args.dataset](
        batch_size=args.batch_size, max_len=args.max_len,
        relative_path=args.data_path, seed=SEED,
        trim_silence=args.trim_silence).start()
    cfg = ModelConfig.from_json(args.parameter_path)
    if cfg.verbose:
        print("wavenet receptive_field:", cfg.wavenet.receptive_field)
    if args.restore_path is not None:
        ts = to_device(restore_checkpoint(args.restore_path), device)
    else:
        params, state = random_params_np(cfg, dataset.num_speakers,
                                         seed=SEED)
        ts = init_train_state(to_torch(params, device),
                              to_torch(state, device))
    gs = ts["step"]
    print(f"[restore] last global step: {gs}")

    save_dir = os.path.dirname(args.save_path) or "."
    os.makedirs(save_dir, exist_ok=True)
    writer = MetricWriter(save_dir)
    losses, step_seconds = [], []
    t_win, last_print = time.perf_counter(), 0
    path = None
    try:
        for step in range(1, 1 + args.num_steps):
            t0 = time.perf_counter()
            host = dataset.next()
            batch = {k: torch.from_numpy(v).to(device) for k, v in
                     host.items()}
            ts, metrics = train_step(ts, batch, cfg)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_seconds.append(time.perf_counter() - t0)
            if (gs + step) % args.interval == 0:
                writer.scalars(gs + step, metrics)
                writer.flush()
            if step % args.log_every == 0 or step == args.num_steps:
                rl = float(metrics["reconstruction_loss"])
                losses.append(float(metrics["loss"]))
                now = time.perf_counter()
                t = (now - t_win) / (step - last_print)
                t_win, last_print = now, step
                line = "\r[step %d] %.2f" % (
                    gs + step, step / args.num_steps * 100) + "%"
                line += " [recons %.5f] [lr %.5f]" % (rl, metrics["lr"])
                if "distances_mean" in metrics:
                    line += " [dist %.2f]" % float(metrics["distances_mean"])
                print(line + display_time(t, (args.num_steps - step) * t),
                      end="")
                sys.stdout.flush()
            if step % args.ckpt_interval == 0:
                save_checkpoint(save_dir, ts)
        path = save_checkpoint(save_dir, ts)
        print(f"\nsaved {path}")
    finally:
        dataset.stop()
        writer.close()
    return {"losses": losses, "step_seconds": step_seconds, "path": path,
            "step": ts["step"]}


if __name__ == "__main__":
    main()
