"""Voice-conversion CLI of the port (after the JAX package's generate.py).

    python -m vqvae_wavenet_torch.generate -restore saved_model/weights-110640.npz \
        -audio data/VCTK-Corpus/wav48/p225/p225_001.wav \
        -speakers p225 p226 None -mode sample [-params model_parameters.json] \
        [-dtype bf16|f32|int8] [-device cuda|cpu] [-data_shards N]

``-restore`` names the port's ``.npz``: a training checkpoint of the
port's train.py, or an export by tools/export_torch_npz.py of an orbax
checkpoint.  The main family generates from the EMA parameters, the
Magenta family from the raw ones (a checkpoint's train/params), as the
JAX generate.py restores.  The conditioning wav is
trimmed to a multiple of 512 samples and encoded once (the config's
encoder, "64", "Magenta" or "2019" -> VQ -> speaker concat; or, with
``-params magenta_parameters.json``, the Magenta family's encoder -> VQ,
with the speaker as a per-layer global condition); sample i reads latent
frame i // ratio, ratio = length // frames (the 2019 encoder's 320-sample
frames need not divide the length: past the last frame, the last is
read); the local condition -- never the wav -- is zero-padded to a
1024/8192-sample bucket;
the whole clip is generated in one kernel launch on CUDA (with
``-data_shards N`` the speakers are split over cuda:0 .. cuda:N-1, one
launch each: parallel/genshard.py); one 16 kHz wav
per speaker is written beside the checkpoint, with the codebook and
speaker embeddings as .npy files.  ``-dtype int8`` quantizes the decoder
weights per row (the TPU kernel's int8 mode) on either device.
"""
from __future__ import annotations

import argparse
import os
import re
import time

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-restore", dest="restore_path", required=True,
                        help="path to the port's weights .npz")
    parser.add_argument("-audio", dest="audio_path", required=True,
                        help="path to audio")
    parser.add_argument("-speakers", nargs="+", dest="speakers",
                        required=True, help="speaker id")
    parser.add_argument("-mode", default="sample", dest="mode",
                        choices=["sample", "greedy"],
                        help="decode mode, sample or greedy")
    parser.add_argument("-params", default="model_parameters.json",
                        dest="parameter_path", metavar="str",
                        help="path to parameters file")
    parser.add_argument("-data", default="data/", dest="data_path",
                        metavar="str", help="dataset root (speaker files)")
    parser.add_argument("-seed", default=0, type=int, help="sampling seed")
    parser.add_argument("-dtype", default=None, dest="dtype",
                        choices=["f32", "bf16", "int8"],
                        help="generation dtype (default: bf16 on CUDA, f32 "
                             "on CPU; int8 = per-row quantized weights with "
                             "bf16 activations); sampling is always f32")
    parser.add_argument("-data_shards", default=1, type=int,
                        dest="data_shards",
                        help="shard the speaker batch over N devices (N "
                             "dividing the speakers, at most the device "
                             "count)")
    parser.add_argument("-device", default="cuda", dest="device",
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


def speaker_one_hots(speakers, data_path):
    """Speaker table rules of the reference (generate.py:46-61): corpus by
    the first speaker's prefix, sizes VCTK=109 / aishell=340 /
    LibriSpeech=251, 'None' -> all-zero vector.  Returns the one-hots
    [len(speakers), 1, num_speakers]."""
    from vqvae_wavenet_torch.data import get_speaker_to_int

    def find(name, sub):
        for cand in (os.path.join(data_path, name),
                     os.path.join(data_path, sub, name)):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f"{name} under {data_path}")

    if speakers[0][0] == "p":  # VCTK
        table = get_speaker_to_int(find("vctk_speakers.txt", "vctk_info"))
        num_speakers = 109
    elif speakers[0][0].lower() == "s":  # aishell
        table = get_speaker_to_int(find("aishell_speakers.txt", "aishell_info"))
        num_speakers = 340
    else:  # LibriSpeech
        table = get_speaker_to_int(find("librispeech_speakers.txt",
                                        "librispeech_info"))
        num_speakers = 251
    one_hot = np.zeros((len(speakers), 1, num_speakers), np.float32)
    for i, s in enumerate(speakers):
        if s.lower() != "none":
            one_hot[i, 0, table[s]] = 1.0
    return one_hot


def _vqvae_generate(params, state, cfg, x, y, padded, generator, mode, dtype,
                    devices=None):
    """Encoder -> VQ -> speaker concat, then generation of ``padded``
    samples, the streams sharded over ``devices`` (default: x's).  Sample
    i reads frame i // ratio with the floor ratio of the real length
    (length // frames; the TF1 reference's), passed down explicitly: the
    condition is first extended with copies of its last frame to cover the
    real length (samples past the last frame read it), then zero-padded to
    the bucket, which only the cut tail reads."""
    from vqvae_wavenet_torch.models.vqvae import vqvae_encode
    from vqvae_wavenet_torch.parallel.genshard import generate_sharded
    from vqvae_wavenet_torch.ops.gen_kernels import (condition_frames,
                                                     frame_ratio)
    length = x.shape[1]
    lc, _codes = vqvae_encode(params, state, cfg, x, y)
    ratio = frame_ratio(length, lc.shape[1])
    lc = condition_frames(lc, length, ratio)
    need = -(-padded // ratio)
    if need > lc.shape[1]:
        lc = torch.nn.functional.pad(lc, (0, 0, 0, need - lc.shape[1]))
    return generate_sharded(params["decoder"], cfg.wavenet, lc,
                            length=padded, devices=devices or [x.device],
                            generator=generator, mode=mode, dtype=dtype,
                            verbose=True, ratio=ratio)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda requested but no CUDA device is "
                           "available (use -device cpu)")
    return device


def shard_devices(n: int, device: torch.device):
    """The devices of -data_shards n: cuda:0 .. cuda:n-1 (or the one
    device); raises ValueError past the device count (genshard.py:40-43)."""
    from vqvae_wavenet_torch.parallel.mesh import device_count
    count = device_count(device.type)
    if not 1 <= n <= count:
        raise ValueError(f"-data_shards {n}: {count} {device.type} "
                         f"device(s) attached")
    if n == 1 or device.type != "cuda":
        return [device] * n
    return [torch.device("cuda", i) for i in range(n)]


def main(argv=None):
    args = parse_args(argv)
    from scipy.io import wavfile
    from vqvae_wavenet_torch.config import ModelConfig
    from vqvae_wavenet_torch.data import read_wav_16k
    from vqvae_wavenet_torch.models.magenta import magenta_generate
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.params import load_npz

    device = resolve_device(args.device)
    devices = shard_devices(args.data_shards, device)
    if args.dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    else:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}[args.dtype]
    # the encoder runs in float32 either way: keep cuDNN/cuBLAS off TF32
    set_full_f32()

    cfg = ModelConfig.from_json(args.parameter_path)
    magenta = cfg.model_family == "magenta"
    m = re.search(r"-(\d+)(\.npz)?$", args.restore_path.rstrip("/"))
    gs = int(m.group(1)) if m else 0
    batch_size = len(args.speakers)

    wav = read_wav_16k(args.audio_path)
    # truncate to a multiple of the largest dilation (generate.py:38-39)
    wav = wav[: len(wav) // 512 * 512]
    length = len(wav)
    # the condition (not the wav) is padded to a bucket; the kept samples
    # never read the padded frames (sample t reads frame t // ratio)
    bucket = 8192 if length > 4096 else 1024
    padded = -(-length // bucket) * bucket
    x = torch.from_numpy(np.tile(wav.reshape(1, -1, 1), (batch_size, 1, 1))
                         ).float().to(device)
    y = speaker_one_hots(args.speakers, args.data_path)

    # the Magenta family generates from the raw parameters (a training
    # checkpoint's train/params), the main family from the EMA shadows
    params, state = load_npz(args.restore_path, device, raw_params=magenta)
    save_path = (args.restore_path.split("/weights")[0]
                 if "/weights" in args.restore_path
                 else os.path.dirname(os.path.abspath(args.restore_path)))
    os.makedirs(save_path, exist_ok=True)
    if cfg.use_vq:
        np.save(os.path.join(save_path, f"embedding_{gs}.npy"),
                params["vq"]["embedding"].cpu().numpy())
    spk_key = "speaker_emb" if magenta else "speaker_embedding"
    if cfg.speaker_embedding > 0 and spk_key in params:
        np.save(os.path.join(save_path, f"speaker_embedding_{gs}.npy"),
                params[spk_key].cpu().numpy())

    t0 = time.perf_counter()
    generator = torch.Generator().manual_seed(args.seed)
    with torch.no_grad():
        if magenta:
            # encodes the exact wav and zero-pads the latent frames itself
            audio = magenta_generate(params, x, torch.from_numpy(y).to(device),
                                     length=padded, generator=generator,
                                     mode=args.mode, dtype=dtype, verbose=True,
                                     devices=devices)
        else:
            audio = _vqvae_generate(params, state, cfg, x,
                                    torch.from_numpy(y).to(device), padded,
                                    generator, args.mode, dtype, devices)
    audio = audio[:, :length].cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"[generate] {batch_size}x{padded} samples in {dt:.2f}s "
          f"({batch_size * padded / dt:,.0f} samples/s, including any "
          f"first-use kernel build)")

    paths = []
    for i, s in enumerate(args.speakers):
        s = "no_speaker" if s == "None" else s
        path = os.path.join(save_path, f"{gs}_{s}.wav")
        wavfile.write(path, 16000, audio[i].astype(np.float32))
        paths.append(path)
    print(f"wrote {batch_size} wav(s) to {save_path}")
    return {"audio": audio, "paths": paths, "seconds": dt,
            "samples": batch_size * padded}


if __name__ == "__main__":
    main()
