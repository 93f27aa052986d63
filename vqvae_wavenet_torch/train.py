"""Training CLI of the port (the flags of the JAX package's train.py,
which keeps the reference's train.py:12-37, plus -device):

    python -m vqvae_wavenet_torch.train -dataset VCTK -length 6656 -batch 8 \
        -step 100000 -save saved_model/weights [-restore saved_model/weights-N] \
        [-interval 200] [-params model_parameters.json] [-device cuda|cpu] \
        [-time_shards N [-decoder_halo auto|fused|layer|recompute]] \
        [-profile DIR] \
        [-coordinator HOST:PORT -num_processes P -process_id h]

One step is vqvae_forward (with -params magenta_parameters.json, the
Magenta family's magenta_forward) + autograd (the stack, loss-head and VQ
kernels on the card) + the fused Adam/EMA update.  The config's
"time_jitter" jitters the latent frames with moves drawn from the global
step, "condition_upsample" conditions the decoder per sample through
cond_conv, and "quantization_channels" may be any multiple of 8 (past
256 the bf16 loss head walks 256-column chunks).  The config's encoder
may be "64", "Magenta" or "2019"; -length must be a multiple of its
samples a latent frame (64, 64, 320: Encoder_2019 trains at e.g. -length
6400), so that the frames divide the clip as the decoder needs.  "train_dtype": "bf16"
in the params JSON trains in bf16 mixed precision in either family.  The
stack's backward is the layer sweep, or the two-kernel form when
vqvae_wavenet_torch.ops.train_kernels.BWD_FUSED_DK is "off".  Every
-interval steps the scalars, the gradients' global norm
(global_norm/gradient_norm) and the reference's histogram set
(training/metrics.py::summary_histograms) go to a TensorBoard event file
in the save directory (written without tensorboardX) and the scalars to
<save dir>/metrics.jsonl; the progress line prints
every -log_every steps; weights-<step>.npz is written every -ckpt_interval
steps and at the end (training/checkpoint.py; the port's generate.py
restores it).  The initial weights and the crop sampler draw from numpy
seed 0.

On a host with several GPUs the step is data-parallel, as JAX's
train.py:113-125 shards the batch: gcd(-batch, GPU count) ranks are
spawned, rank l on cuda:l with rows l*B/N .. (l+1)*B/N - 1 of every batch,
which the host's first rank reads and broadcasts; the batch norms, the VQ
statistics (and the EMA codebook's) and the loss means span every rank,
and the gradients are summed over the ranks before one identical update on
each (training/train_loop.py::dp_loss_and_grads).  -coordinator HOST:PORT
-num_processes P -process_id h (given together, one process a host) join
P hosts into one group at tcp://HOST:PORT; -batch is per process (the
global batch is -batch * P, the hosts' batches in host order), and host h
draws its crops from numpy seed h.  Rank 0 alone prints, writes
metrics.jsonl and the checkpoints, which are the single-device format; a
restored state is rank 0's, broadcast.

-time_shards N adds sequence parallelism (parallel/timeshard.py), for
either family, any encoder, norm and VQ mode: the ranks form a data x
time mesh of n_data = gcd(global batch, devices // N) rows of N time
shards (parallel/mesh.py::mesh_shape; n_data = 1, the N ranks sharing the
devices, when there are fewer devices than N), global rank d * N + t on
cuda:(local rank % device_count) (or the CPU) with the time slice t of
its rows d of every batch; the stack kernels run per layer group on
halo-extended shards (their SP variants): -decoder_halo auto = fused, a
group per dilation cycle; recompute, one group with the receptive field's
halo; layer, a group per layer.  The gradients are summed over every rank
before the update.  -loader native reads the corpus with the repo's C++
loader (cpp/dataloader.cpp, built with g++ at first use; 16 kHz PCM16
only, raising with the reason otherwise), -loader auto (the default)
takes it where it is eligible, -loader python the python one.

-profile DIR traces steps 10-14 with torch.profiler (host and, on CUDA,
device activity; rank 0 only) and writes DIR/trace.json (Chrome trace);
every step runs in a "train_step" range, its gradients in
"loss_and_grads", its update in "optimizer", and each CUDA kernel's launch
in a range named after its counter (ops/*_kernels.py).
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
                        help="trace steps 10-14 with torch.profiler into "
                             "DIR/trace.json")
    parser.add_argument("-coordinator", default=None, metavar="HOST:PORT",
                        help="multi-host training: the address every host's "
                             "process meets at")
    parser.add_argument("-num_processes", default=None, type=int,
                        help="multi-host training: the number of hosts "
                             "(one process each)")
    parser.add_argument("-process_id", default=None, type=int,
                        help="multi-host training: this host's index")
    parser.add_argument("-log_every", default=1, type=int, metavar="N",
                        help="print the progress line every N steps")
    parser.add_argument("-loader", default="auto",
                        choices=["auto", "python", "native"],
                        help="input pipeline: the python loader, the native "
                             "C++ one (16 kHz PCM16 corpora), or auto (native "
                             "where it is eligible)")
    parser.add_argument("-trim_silence", action="store_true",
                        help="trim leading/trailing silence before the "
                             "random crop (dataset.py:23-31)")
    parser.add_argument("-time_shards", default=1, type=int, metavar="N",
                        help="sequence parallelism: split the time axis of "
                             "every clip over N ranks (-length/N a multiple "
                             "of the encoder's samples a frame); with more "
                             "devices, a data x time mesh")
    parser.add_argument("-decoder_halo", default="auto",
                        choices=["auto", "fused", "layer", "recompute"],
                        help="SP decoder scheme: 'fused' (= 'auto') one "
                             "stack kernel call per dilation cycle with its "
                             "halo, 'recompute' one call with the receptive "
                             "field's halo, 'layer' one call per layer "
                             "with its own halo")
    parser.add_argument("-device", default="cuda",
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


def _hosts(args):
    """(hosts, this host's index, the group's address or None) from the
    multi-host flags, which go together."""
    given = (args.coordinator, args.num_processes, args.process_id)
    if given == (None, None, None):
        return 1, 0, None
    if None in given:
        raise ValueError("-coordinator HOST:PORT, -num_processes P and "
                         "-process_id h go together (multi-host training)")
    if not 0 <= args.process_id < args.num_processes:
        raise ValueError(f"-process_id {args.process_id} is not one of "
                         f"{args.num_processes} processes")
    return args.num_processes, args.process_id, f"tcp://{args.coordinator}"


def main(argv=None):
    """Train; returns {"losses", "step_seconds", "path", "step", "trace",
    "launches"} (the per-step wall seconds end in a device synchronise on
    CUDA; "trace" is the -profile trace's path or None; "launches" holds
    the kernels' launch counts, with several ranks a list with one dict
    per rank of this host and the other keys this host's first rank's)."""
    args = parse_args(argv)
    hosts, host, init = _hosts(args)
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.generate import resolve_device
    from vqvae_wavenet_torch.parallel import run_in_group, run_ranks
    from vqvae_wavenet_torch.parallel.mesh import mesh_shape
    device = resolve_device(args.device)
    cfg = ModelConfig.from_json(args.parameter_path)
    check_length(cfg, args.max_len)
    n_time = args.time_shards
    if n_time > 1:
        from vqvae_wavenet_torch.parallel.timeshard import check_supported
        check_supported(cfg, args.max_len, n_time, args.decoder_halo)
    n_data, local = mesh_shape(args.batch_size, n_time, hosts, device.type)
    if n_data > 1 and n_time > 1:
        print(f"[mesh] data={n_data} x time={n_time}")
    if local * hosts == 1:
        return _train(args, device, None)
    if local == 1:      # this host's one rank: no child to spawn
        results = [run_in_group(_rank, host, hosts, init, device.type,
                                vars(args), hosts=hosts, n_time=n_time)]
    else:
        results = run_ranks(_rank, local, device.type, vars(args),
                            hosts=hosts, host=host, init_method=init,
                            n_time=n_time)
    return dict(results[0], launches=[r["launches"] for r in results])


def _rank(sh, args: dict):
    """One rank of a parallel run (spawned by run_ranks, or this host's
    only one)."""
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


PROFILE_STEPS = (10, 15)     # -profile traces steps 10-14 (train.py:210-219)


def _train(args, device: torch.device, sh):
    """The training loop on one device (sh None) or as rank sh.rank of a
    parallel run (data-parallel, and sequence-parallel when sh.n_time > 1)."""
    from torch.profiler import record_function
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.data import DATASETS, make_input_pipeline
    from vqvae_wavenet_torch.models.encoders import encoder_downsample_rate
    from vqvae_wavenet_torch.models.vqvae import jitter_moves
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    from vqvae_wavenet_torch.parallel.mesh import (global_batch, rank_rows,
                                                   replicate_)
    from vqvae_wavenet_torch.training.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from vqvae_wavenet_torch.training.metrics import (
        MetricWriter, display_time, summary_histograms)
    from vqvae_wavenet_torch.training.train_loop import (
        dp_loss_and_grads, init_train_state, to_device, train_step)

    set_full_f32()
    lead = sh is None or sh.rank == 0
    if args.dataset not in DATASETS:
        raise NotImplementedError(f"dataset {args.dataset} not implemented")
    # each host's first rank reads that host's batches, from its own seed
    # (the others only need the speaker count)
    kw = dict(batch_size=args.batch_size, max_len=args.max_len,
              relative_path=args.data_path, seed=SEED + (sh.host if sh else 0),
              trim_silence=args.trim_silence)
    if sh is None or sh.local_rank == 0:
        dataset = make_input_pipeline(args.dataset, loader=args.loader, **kw)
    else:
        dataset = DATASETS[args.dataset](**kw)
    shapes = {"x": (args.batch_size, args.max_len, 1),
              "y": (args.batch_size, 1, dataset.num_speakers)}
    cfg = ModelConfig.from_json(args.parameter_path)
    if cfg.verbose and lead:
        print("wavenet receptive_field:", cfg.wavenet.receptive_field)
    if args.restore_path is not None and lead:
        ts = to_device(restore_checkpoint(args.restore_path), device)
    else:
        params, state = random_params_np(cfg, dataset.num_speakers,
                                         seed=SEED)
        ts = init_train_state(to_torch(params, device),
                              to_torch(state, device))
    if args.restore_path is not None and sh is not None:
        ts = replicate_(ts, sh)
    gs = ts["step"]
    if sh is None:
        def step_fn(ts, batch, summ):
            return train_step(ts, batch, cfg, with_summaries=summ)
    else:
        if sh.n_time > 1:
            from vqvae_wavenet_torch.parallel.timeshard import (
                sp_loss_and_grads)
            grads_fn = functools.partial(sp_loss_and_grads, sh=sh,
                                         decoder_halo=args.decoder_halo)
        else:
            grads_fn = functools.partial(dp_loss_and_grads, sh=sh)
        t_l = args.max_len // sh.n_time
        rows = slice(sh.time_rank * t_l, (sh.time_rank + 1) * t_l)

        def step_fn(ts, batch, summ):
            return train_step(ts, dict(
                {k: rank_rows(v, sh) for k, v in batch.items()},
                x=rank_rows(batch["x"], sh)[:, rows].contiguous()),
                cfg, grads_fn=grads_fn, sh=sh, with_summaries=summ)
    if lead:
        print(f"[restore] last global step: {gs}")
        staged = (", ranks share a GPU: exchanges staged through host "
                  "memory" if sh is not None and sh.staged else "")
        clips = args.batch_size * (sh.hosts if sh else 1)
        if sh is not None and sh.n_time > 1:
            print(f"[sp] {sh.n_time} time shards of "
                  f"{args.max_len // sh.n_time} samples, backend "
                  f"{sh.backend}{staged}; {sh.n_data} data row(s) of "
                  f"{clips // sh.n_data} clips, decoder halo "
                  f"{args.decoder_halo}")
        elif sh is not None:
            print(f"[dp] {sh.world} data ranks ({sh.hosts} host(s)) of "
                  f"{clips // sh.world} clips, backend {sh.backend}"
                  f"{staged}")

    save_dir = os.path.dirname(args.save_path) or "."
    writer = None
    if lead:
        os.makedirs(save_dir, exist_ok=True)
        writer = MetricWriter(save_dir)
    losses, step_seconds = [], []
    t_win, last_print = time.perf_counter(), 0
    path = trace = prof = None
    try:
        for step in range(1, 1 + args.num_steps):
            if args.profile and lead and step == PROFILE_STEPS[0]:
                prof = _start_profile(device)
            elif prof is not None and step == PROFILE_STEPS[1]:
                trace = _stop_profile(prof, args.profile, device, step - 1)
                prof = None
            t0 = time.perf_counter()
            with record_function("train_step"):
                batch = global_batch(dataset.next, shapes, device, sh)
                if cfg.time_jitter:     # JAX's PRNGKey(gs + step)
                    batch["jitter"] = jitter_moves(
                        gs + step, batch["x"].shape[0], args.max_len
                        // encoder_downsample_rate(cfg.encoder)).to(device)
                want = (gs + step) % args.interval == 0
                ts, metrics = step_fn(ts, batch, want)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            step_seconds.append(time.perf_counter() - t0)
            if want:
                summ = metrics.pop("summaries")
            if lead and want:       # train.py:222-237
                scalars = dict(metrics, **{
                    "global_norm/gradient_norm": summ.pop("grad_norm")})
                writer.histograms(gs + step, summary_histograms(
                    ts["params"], summ))
                writer.scalars(gs + step, scalars)
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
        if prof is not None:
            trace = _stop_profile(prof, args.profile, device, args.num_steps)
            prof = None
        if lead:
            path = save_checkpoint(save_dir, ts)
            print(f"\nsaved {path}")
    finally:
        if prof is not None:
            prof.stop()
        dataset.stop()
        if writer is not None:
            writer.close()
    return {"losses": losses, "step_seconds": step_seconds, "path": path,
            "step": ts["step"], "trace": trace, "launches": _launch_counts()}


def _start_profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, out_dir: str, device: torch.device, last: int) -> str:
    """Stop the trace after the device has finished and write it as
    out_dir/trace.json; returns its path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"\n[profile] steps {PROFILE_STEPS[0]}-{last} traced to {path}")
    return path


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


if __name__ == "__main__":
    main()
