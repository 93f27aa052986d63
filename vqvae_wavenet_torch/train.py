"""Training CLI of the port (the flags of the JAX package's train.py,
which keeps the reference's train.py:12-37, plus -device):

    python -m vqvae_wavenet_torch.train -dataset VCTK -length 6656 -batch 8 \
        -step 100000 -save saved_model/weights [-restore saved_model/weights-N] \
        [-interval 200] [-params model_parameters.json] [-device cuda|cpu] \
        [-time_shards N [-decoder_halo auto|fused]]

One step is vqvae_forward (with -params magenta_parameters.json, the
Magenta family's magenta_forward) + autograd (the stack, loss-head and VQ
kernels on the card) + the fused Adam/EMA update.  The config's encoder
may be "64", "Magenta" or "2019"; -length must be a multiple of its
samples a latent frame (64, 64, 320: Encoder_2019 trains at e.g. -length
6400), so that the frames divide the clip as the decoder needs.  "train_dtype": "bf16"
in the params JSON trains in bf16 mixed precision in either family.  The
stack's backward is the layer sweep, or the two-kernel form when
vqvae_wavenet_torch.ops.train_kernels.BWD_FUSED_DK is "off".  Scalars go to
<save dir>/metrics.jsonl every -interval steps; the progress line prints
every -log_every steps; weights-<step>.npz is written every -ckpt_interval
steps and at the end (training/checkpoint.py; the port's generate.py
restores it).  The initial weights and the crop sampler draw from numpy
seed 0.

-time_shards N trains sequence-parallel (parallel/timeshard.py): N ranks
are spawned, rank r on cuda:(r % device_count) (or the CPU), each with its
time slice of every batch, which rank 0 reads and broadcasts; the stack
kernels run per dilation cycle on halo-extended shards (their SP variants)
and the gradients are summed over the ranks before the update.  Rank 0
alone prints, writes metrics.jsonl and the checkpoints, which are the
single-device format.  -decoder_halo auto is 'fused' on every device
('layer' and 'recompute' are not ported); SP of the Magenta family is not
ported and raises.  -coordinator, -num_processes,
-process_id, -loader native and -profile belong to parts that are not
ported yet and raise.
"""
from __future__ import annotations

import argparse
import functools
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
                        help="sequence parallelism: split the time axis of "
                             "every batch over N spawned ranks (-length/N a "
                             "multiple of 64)")
    parser.add_argument("-decoder_halo", default="auto",
                        choices=["auto", "fused", "layer", "recompute"],
                        help="SP decoder scheme: 'fused' (= 'auto') runs "
                             "one stack kernel call per dilation cycle with "
                             "its recompute halo; 'layer' and 'recompute' "
                             "are not ported (ROADMAP.md queue A, SP)")
    parser.add_argument("-device", default="cuda",
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.decoder_halo in ("layer", "recompute"):
        raise NotImplementedError(f"-decoder_halo {args.decoder_halo} is not "
                                  f"ported (only 'fused'): ROADMAP.md queue "
                                  f"A, SP")
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
    """Train; returns {"losses", "step_seconds", "path", "step",
    "launches"} (the per-step wall seconds end in a device synchronise on
    CUDA; "launches" holds the kernels' launch counts, under -time_shards a
    list with one dict per rank and the other keys rank 0's)."""
    args = parse_args(argv)
    _refuse_unported(args)
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.generate import resolve_device
    device = resolve_device(args.device)
    cfg = ModelConfig.from_json(args.parameter_path)
    check_length(cfg, args.max_len)
    if args.time_shards == 1:
        return _train(args, device, None)
    from vqvae_wavenet_torch.parallel import run_ranks
    from vqvae_wavenet_torch.parallel.timeshard import check_supported
    check_supported(cfg, args.max_len, args.time_shards, args.decoder_halo)
    results = run_ranks(_sp_rank, args.time_shards, device.type, vars(args))
    return dict(results[0], launches=[r["launches"] for r in results])


def _sp_rank(sh, args: dict):
    """One rank of a -time_shards run (spawned by run_ranks)."""
    return _train(argparse.Namespace(**args), sh.device, sh)


def _launch_counts() -> dict:
    from vqvae_wavenet_torch.ops import (epilogue_kernels, train_kernels,
                                         vq_kernels)
    return {"vq_argmin": vq_kernels.launches,
            "train_stack_fwd": train_kernels.fwd_launches,
            "train_stack_bwd": train_kernels.bwd_launches,
            "train_stack_fwd_sp": train_kernels.fwd_sp_launches,
            "train_stack_bwd_sp": train_kernels.bwd_sp_launches,
            "train_stack_bwd_chain": train_kernels.chain_launches,
            "train_stack_bwd_dk": train_kernels.dk_launches,
            "train_epilogue_fwd": epilogue_kernels.fwd_launches,
            "train_epilogue_bwd": epilogue_kernels.bwd_launches}


def _train(args, device: torch.device, sh):
    """The training loop on one device (sh None) or as rank sh.rank of a
    sequence-parallel run."""
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.data import DATASETS
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    from vqvae_wavenet_torch.training.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from vqvae_wavenet_torch.training.metrics import MetricWriter, display_time
    from vqvae_wavenet_torch.training.train_loop import (
        init_train_state, to_device, train_step)

    set_full_f32()
    lead = sh is None or sh.rank == 0
    if args.dataset not in DATASETS:
        raise NotImplementedError(f"dataset {args.dataset} not implemented")
    dataset = DATASETS[args.dataset](
        batch_size=args.batch_size, max_len=args.max_len,
        relative_path=args.data_path, seed=SEED,
        trim_silence=args.trim_silence)
    if lead:
        dataset.start()
    cfg = ModelConfig.from_json(args.parameter_path)
    if cfg.verbose and lead:
        print("wavenet receptive_field:", cfg.wavenet.receptive_field)
    if args.restore_path is not None:
        ts = to_device(restore_checkpoint(args.restore_path), device)
    else:
        params, state = random_params_np(cfg, dataset.num_speakers,
                                         seed=SEED)
        ts = init_train_state(to_torch(params, device),
                              to_torch(state, device))
    gs = ts["step"]
    if sh is None:
        def step_fn(ts, batch):
            return train_step(ts, batch, cfg)
    else:
        from vqvae_wavenet_torch.parallel.timeshard import sp_loss_and_grads
        t_l = args.max_len // sh.world
        grads_fn = functools.partial(sp_loss_and_grads, sh=sh,
                                     decoder_halo=args.decoder_halo)

        def step_fn(ts, batch):
            x_l = batch["x"][:, sh.rank * t_l:(sh.rank + 1) * t_l]
            return train_step(ts, {"x": x_l.contiguous(), "y": batch["y"]},
                              cfg, grads_fn=grads_fn)
    if lead:
        print(f"[restore] last global step: {gs}")
        if sh is not None:
            print(f"[sp] {sh.world} time shards of {args.max_len // sh.world}"
                  f" samples, backend {sh.backend}"
                  + (", ranks share a GPU: halos and gradients staged "
                     "through host memory" if sh.staged else ""))

    save_dir = os.path.dirname(args.save_path) or "."
    writer = None
    if lead:
        os.makedirs(save_dir, exist_ok=True)
        writer = MetricWriter(save_dir)
    losses, step_seconds = [], []
    t_win, last_print = time.perf_counter(), 0
    path = None
    try:
        for step in range(1, 1 + args.num_steps):
            t0 = time.perf_counter()
            batch = _next_batch(dataset, args, device, sh, lead)
            ts, metrics = step_fn(ts, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_seconds.append(time.perf_counter() - t0)
            if lead and (gs + step) % args.interval == 0:
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
                if lead:
                    print(line + display_time(t, (args.num_steps - step) * t),
                          end="")
                    sys.stdout.flush()
            if lead and step % args.ckpt_interval == 0:
                save_checkpoint(save_dir, ts)
        if lead:
            path = save_checkpoint(save_dir, ts)
            print(f"\nsaved {path}")
    finally:
        dataset.stop()
        if writer is not None:
            writer.close()
    return {"losses": losses, "step_seconds": step_seconds, "path": path,
            "step": ts["step"], "launches": _launch_counts()}


def check_length(cfg, length: int) -> None:
    """Raise ValueError unless ``length`` is a multiple of the encoder's
    samples a latent frame (the decoder's frames must divide the clip,
    vqvae_wavenet_tpu/models/wavenet.py:164-183)."""
    if cfg.model_family != "vqvae":
        return
    from vqvae_wavenet_torch.models.encoders import encoder_downsample_rate
    rate = encoder_downsample_rate(cfg.encoder)
    if length % rate:
        raise ValueError(
            f"-length {length} is not a multiple of {rate}, the samples a "
            f"latent frame of encoder {cfg.encoder!r}: its frames would not "
            f"divide the clip (Encoder_2019 trains at e.g. -length 6400)")


def _next_batch(dataset, args, device, sh, lead: bool):
    """The next batch on ``device``: read here, or under SP read by rank 0
    and broadcast to every rank."""
    if lead:
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 dataset.next().items()}
    else:
        batch = {"x": torch.empty((args.batch_size, args.max_len, 1),
                                  device=device),
                 "y": torch.empty((args.batch_size, 1, dataset.num_speakers),
                                  device=device)}
    if sh is not None:
        from vqvae_wavenet_torch.parallel.comm import broadcast_
        for k in sorted(batch):
            broadcast_(batch[k], sh)
    return batch


if __name__ == "__main__":
    main()
