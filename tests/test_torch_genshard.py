"""Batch-sharded generation of the port (parallel/genshard.py) on the CPU,
where every shard runs the plain twin of the generation kernel.

  * Greedy float32: the sharded waveform equals the single-device one
    stream by stream (bitwise: each stream's steps are the same
    arithmetic), for the main family's decoder, the Magenta family
    (magenta_generate, 4 decoder layers at narrow widths as
    tests/test_torch_magenta_train.py patches them) and Encoder_2019
    through generate.py at a length its frames do not divide (800 samples,
    3 frames: the floor ratio 266 with the last frame read past 798);
    and it equals JAX's generate_sharded on a 2-device mesh (JAX's XLA
    scan) within 1e-6, far below the smallest mu-law step, i.e. identical
    bins (tests/test_torch_generate.py).
  * Sample mode: shard i equals the single-device call on its streams with
    its own generator (``shard_generators``); one shard is ``generate``
    with the caller's generator.
  * A batch that the shards do not divide raises ValueError.
  * The CLI: -data_shards 2 (the device count patched to 2, two CPU
    shards) writes what -data_shards 1 writes, greedy; more shards than
    devices raise.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_generate import conditions, model, tiny_cfg
from vqvae_wavenet_torch.config import ModelConfig
from vqvae_wavenet_torch.generation.fast import generate
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.parallel.genshard import (generate_sharded,
                                                   shard_generators)
from vqvae_wavenet_torch.params import random_params_np, save_npz, to_torch

set_full_f32()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGENTA_JSON = os.path.join(REPO, "magenta_parameters.json")
CPU2 = [torch.device("cpu")] * 2


def test_greedy_sharded_equals_single_device_and_jax():
    from vqvae_wavenet_tpu.parallel.genshard import (data_mesh,
                                                     generate_sharded as jgs)
    cfg = tiny_cfg()
    p = model(cfg)
    lc, _ = conditions(4, 4)
    got = generate_sharded(to_torch(p), cfg, torch.from_numpy(lc),
                           length=64, devices=CPU2, mode="greedy")
    one = generate(to_torch(p), cfg, torch.from_numpy(lc), length=64,
                   mode="greedy")
    assert got.shape == (4, 64) and torch.equal(got, one)
    ref = np.asarray(jgs(jax.tree_util.tree_map(jnp.asarray, p), cfg,
                         jnp.asarray(lc), length=64, mode="greedy",
                         engine="xla", mesh=data_mesh(2)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_sample_shards_equal_their_single_device_calls():
    cfg = tiny_cfg()
    p = to_torch(model(cfg, c_gc=3))
    lc, gc = (torch.from_numpy(a) for a in conditions(4, 4, c_gc=3))
    got = generate_sharded(p, cfg, lc, length=48, devices=CPU2,
                           mode="sample",
                           generator=torch.Generator().manual_seed(5),
                           global_condition=gc, gate_order="sigmoid_first")
    gens = shard_generators(torch.Generator().manual_seed(5), 2)
    for i in range(2):
        rows = slice(2 * i, 2 * i + 2)
        ref = generate(p, cfg, lc[rows], length=48, mode="sample",
                       generator=gens[i], global_condition=gc[rows],
                       gate_order="sigmoid_first")
        assert torch.equal(got[rows], ref), i
    assert not torch.equal(got[:2], got[2:])
    # one shard: generate itself, with the caller's generator
    one = generate_sharded(p, cfg, lc, length=48, devices=CPU2[:1],
                           mode="sample",
                           generator=torch.Generator().manual_seed(5),
                           global_condition=gc, gate_order="sigmoid_first")
    ref = generate(p, cfg, lc, length=48, mode="sample",
                   generator=torch.Generator().manual_seed(5),
                   global_condition=gc, gate_order="sigmoid_first")
    assert torch.equal(one, ref)


def test_batch_that_does_not_divide_raises():
    cfg = tiny_cfg()
    lc, _ = conditions(3, 4)
    with pytest.raises(ValueError, match="divide"):
        generate_sharded(to_torch(model(cfg)), cfg, torch.from_numpy(lc),
                         length=16, devices=CPU2, mode="greedy")


def test_magenta_sharded_greedy_equals_single_device(monkeypatch):
    from vqvae_wavenet_torch.models import magenta
    for name, v in (("NUM_LAYERS", 4), ("NUM_STAGES", 2), ("WIDTH", 16),
                    ("SKIP_WIDTH", 24), ("AE_WIDTH", 32)):
        monkeypatch.setattr(magenta, name, v)
    params, _ = random_params_np(ModelConfig.from_json(MAGENTA_JSON), 3,
                                 seed=2)
    params = to_torch(params)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 256, 1)).astype(
        np.float32))
    gc = torch.from_numpy(np.eye(3, dtype=np.float32)[[0, 2]][:, None])
    got = magenta.magenta_generate(params, x, gc, length=256, mode="greedy",
                                   devices=CPU2)
    one = magenta.magenta_generate(params, x, gc, length=256, mode="greedy")
    assert got.shape == (2, 256) and torch.equal(got, one)


def test_encoder_2019_sharded_at_a_length_its_frames_do_not_divide():
    from vqvae_wavenet_torch.generate import _vqvae_generate
    wn = dict(quantization_channels=32, num_cycles=1, num_cycle_layers=3,
              dilation_rates=[1, 2, 4], kernel_size=2, dilation_filters=8,
              skip_filters=8, residual_filters=8, preprocess_kernel_size=2,
              preprocess_filters=8)
    from vqvae_wavenet_torch.config import WavenetConfig
    cfg = ModelConfig(encoder="2019", use_vq=True, speaker_embedding=4, k=8,
                      latent_dim=4, wavenet=WavenetConfig(**wn))
    params, state = random_params_np(cfg, 3, seed=8)
    params, state = to_torch(params), to_torch(state)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 800, 1)).astype(
        np.float32))
    y = torch.from_numpy(np.eye(3, dtype=np.float32)[[1, 2]][:, None])
    runs = [_vqvae_generate(params, state, cfg, x, y, 1024, None, "greedy",
                            torch.float32, devices)
            for devices in (CPU2, None)]
    assert runs[0].shape == (2, 1024) and torch.equal(*runs)


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A tiny model's random checkpoint, the VCTK speaker table and a
    1,024-sample wav."""
    from scipy.io import wavfile
    root = tmp_path_factory.mktemp("genshard_cli")
    (root / "vctk_info").mkdir()
    speakers = ["p225", "p226"] + [f"p{300 + i}" for i in range(107)]
    (root / "vctk_info" / "vctk_speakers.txt").write_text(
        "".join(f"{s}, {i}\n" for i, s in enumerate(speakers)))
    t = np.arange(1024) / 16000.0
    wavfile.write(str(root / "input.wav"), 16000,
                  (0.4 * np.sin(2 * np.pi * 220.0 * t) * 32767).astype(
                      np.int16))
    wn = {"verbose": False, "quantization_channels": 64, "num_cycles": 1,
          "num_cycle_layers": 4, "dilation_rates": [1, 2, 4, 8],
          "kernel_size": 2, "dilation_filters": 8, "skip_filters": 8,
          "residual_filters": 8,
          "preprocess": {"kernel_size": 4, "filters": 8}}
    (root / "wavenet.json").write_text(json.dumps(wn))
    mp = {"encoder": "64", "use_vq": True, "speaker_embedding": 8, "k": 16,
          "latent_dim": 8, "beta": 0.25, "verbose": False,
          "wavenet_parameters": str(root / "wavenet.json")}
    (root / "model.json").write_text(json.dumps(mp))
    params, state = random_params_np(ModelConfig.from_json(
        str(root / "model.json")), 109, seed=1)
    save_npz(str(root / "weights-7.npz"), params, state)
    return root


def _cli(root, shards):
    from vqvae_wavenet_torch import generate
    return generate.main(["-restore", str(root / "weights-7.npz"),
                          "-audio", str(root / "input.wav"), "-speakers",
                          "p225", "p226", "-mode", "greedy", "-params",
                          str(root / "model.json"), "-data", str(root),
                          "-device", "cpu", "-data_shards", str(shards)])


def test_cli_data_shards_writes_what_one_shard_writes(cli_setup,
                                                      monkeypatch):
    from vqvae_wavenet_torch.parallel import mesh
    one = _cli(cli_setup, 1)["audio"]
    monkeypatch.setattr(mesh, "device_count", lambda device_type: 2)
    two = _cli(cli_setup, 2)["audio"]
    assert one.shape == (2, 1024) and np.array_equal(one, two)
    monkeypatch.setattr(mesh, "device_count", lambda device_type: 4)
    with pytest.raises(ValueError, match="divide"):
        _cli(cli_setup, 4)             # 2 speakers over 4 shards


def test_cli_refuses_more_shards_than_devices(cli_setup):
    with pytest.raises(ValueError, match="data_shards 2"):
        _cli(cli_setup, 2)
