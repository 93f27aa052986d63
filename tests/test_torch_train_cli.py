"""The port's training CLI end to end on a synthetic VCTK-layout corpus, on
the CPU: ``python -m vqvae_wavenet_torch.train`` with a tiny model runs two
steps and writes weights-2.npz, resumes from it to step 3, and the port's
generate.py restores that checkpoint and writes the wavs -- all in a
process where ``import jax`` fails, which also proves that the training
path and every module of the port import nothing of JAX.  Then a JAX train
state goes through ``tools/export_torch_npz.py -train_state`` and the
port resumes it.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT_MODULES = [
    "vqvae_wavenet_torch", "vqvae_wavenet_torch.config",
    "vqvae_wavenet_torch.data", "vqvae_wavenet_torch.params",
    "vqvae_wavenet_torch.generate", "vqvae_wavenet_torch.train",
    "vqvae_wavenet_torch.generation.fast",
    "vqvae_wavenet_torch.models.encoders", "vqvae_wavenet_torch.models.vq",
    "vqvae_wavenet_torch.models.magenta", "vqvae_wavenet_torch.ops.signal",
    "vqvae_wavenet_torch.models.prior", "vqvae_wavenet_torch.prior",
    "vqvae_wavenet_torch.models.vqvae", "vqvae_wavenet_torch.models.wavenet",
    "vqvae_wavenet_torch.ops._build", "vqvae_wavenet_torch.ops.conv",
    "vqvae_wavenet_torch.ops.mu_law", "vqvae_wavenet_torch.ops.vq_kernels",
    "vqvae_wavenet_torch.ops.gen_kernels",
    "vqvae_wavenet_torch.ops.train_kernels",
    "vqvae_wavenet_torch.ops.epilogue_kernels",
    "vqvae_wavenet_torch.parallel", "vqvae_wavenet_torch.parallel.comm",
    "vqvae_wavenet_torch.parallel.timeshard",
    "vqvae_wavenet_torch.training.optimizer",
    "vqvae_wavenet_torch.training.train_loop",
    "vqvae_wavenet_torch.training.checkpoint",
    "vqvae_wavenet_torch.training.metrics"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two speakers x two 1 s utterances in the VCTK layout, the 109-entry
    speaker table generate.py expects, and a tiny model config."""
    root = tmp_path_factory.mktemp("train_cli")
    data = root / "data"
    info = data / "vctk_info"
    info.mkdir(parents=True)
    speakers = ["p225", "p226"] + [f"p{300 + i}" for i in range(107)]
    (info / "vctk_speakers.txt").write_text(
        "".join(f"{s}, {i}\n" for i, s in enumerate(speakers)))
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    files = []
    for s, f0 in (("p225", 220.0), ("p226", 440.0)):
        (data / "VCTK-Corpus" / "wav48" / s).mkdir(parents=True)
        for u in range(2):
            wav = 0.4 * np.sin(2 * np.pi * f0 * t) \
                + 0.02 * rng.standard_normal(t.size)
            name = f"{s}/{s}_{u:03d}.wav"
            wavfile.write(str(data / "VCTK-Corpus" / "wav48" / name), 16000,
                          (wav * 32767).astype(np.int16))
            files.append(name)
    (info / "vctk_train.txt").write_text("\n".join(files) + "\n")
    wavfile.write(str(root / "input.wav"), 16000,
                  (0.4 * np.sin(2 * np.pi * 220.0 * t[:1024])
                   * 32767).astype(np.int16))
    wn = {"verbose": False, "quantization_channels": 256, "num_cycles": 2,
          "num_cycle_layers": 3, "dilation_rates": [1, 2, 4, 8, 16, 32],
          "kernel_size": 2, "dilation_filters": 16, "skip_filters": 16,
          "residual_filters": 16,
          "preprocess": {"kernel_size": 4, "filters": 16}}
    (root / "tiny_wavenet.json").write_text(json.dumps(wn))
    mp = {"encoder": "64", "use_vq": True, "speaker_embedding": 8, "k": 16,
          "latent_dim": 8, "beta": 0.25, "verbose": False,
          "wavenet_parameters": str(root / "tiny_wavenet.json"),
          "learning_rate_schedule": {"0": 1e-3}}
    (root / "tiny_model.json").write_text(json.dumps(mp))
    return root


def train_args(corpus, save, *extra):
    return ["-dataset", "VCTK", "-length", "1024", "-batch", "2",
            "-save", str(save / "weights"),
            "-params", str(corpus / "tiny_model.json"),
            "-data", str(corpus / "data"), "-interval", "1",
            "-device", "cpu", *extra]


NO_JAX_SCRIPT = r"""
import importlib, os, runpy, sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
sys.path.insert(0, {repo!r})
import numpy as np
sys.argv = ["train"] + {first!r}
runpy.run_module("vqvae_wavenet_torch.train", run_name="__main__")
for m in {modules!r}:
    importlib.import_module(m)
from vqvae_wavenet_torch import generate, train
save = {save!r}
assert os.path.exists(os.path.join(save, "weights-2.npz"))
res = train.main({resume!r})
assert res["step"] == 3 and np.isfinite(res["losses"]).all(), res
assert os.path.exists(os.path.join(save, "weights-3.npz"))
rows = open(os.path.join(save, "metrics.jsonl")).read().splitlines()
assert len(rows) == 3, rows
out = generate.main({gen!r})
assert out["audio"].shape == (2, 1024) and np.isfinite(out["audio"]).all()
assert not any(m == "jax" or m.startswith("vqvae_wavenet_tpu")
               for m, v in sys.modules.items() if v is not None)
print("NO_JAX_TRAIN_OK")
"""


def test_train_resume_generate_without_jax(corpus, tmp_path):
    save = tmp_path / "saved"
    wav = corpus / "input.wav"
    script = NO_JAX_SCRIPT.format(
        repo=REPO, modules=PORT_MODULES, save=str(save),
        first=train_args(corpus, save, "-step", "2"),
        resume=train_args(corpus, save, "-step", "1", "-restore",
                          str(save / "weights-2")),
        gen=["-restore", str(save / "weights-3.npz"), "-audio", str(wav),
             "-speakers", "p225", "None", "-mode", "greedy",
             "-params", str(corpus / "tiny_model.json"),
             "-data", str(corpus / "data"), "-device", "cpu"])
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_TRAIN_OK" in out.stdout
    assert "[restore] last global step: 2" in out.stdout
    for name in ("3_p225.wav", "3_no_speaker.wav"):
        assert (save / name).exists()


def test_export_train_state_resumes_a_jax_run(corpus, tmp_path):
    import jax
    from vqvae_wavenet_tpu.config import ModelConfig
    from vqvae_wavenet_tpu.training.checkpoint import save_checkpoint
    from vqvae_wavenet_tpu.training.train_loop import init_train_state
    from vqvae_wavenet_torch import train
    from vqvae_wavenet_torch.training.checkpoint import restore_checkpoint
    from vqvae_wavenet_torch.training.optimizer import tree_leaves

    cfg = ModelConfig.from_json(str(corpus / "tiny_model.json"))
    ts = jax.jit(lambda k: init_train_state(k, cfg, 109))(
        jax.random.PRNGKey(3))
    (tmp_path / "jax_model").mkdir()
    ckpt = save_checkpoint(str(tmp_path / "jax_model"), ts, wait=True)
    save = tmp_path / "port"
    save.mkdir()
    spec = importlib.util.spec_from_file_location(
        "export_torch_npz", os.path.join(REPO, "tools", "export_torch_npz.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main(["-restore", ckpt, "-params", str(corpus / "tiny_model.json"),
               "-out", str(save / "weights-0.npz"), "-train_state"])

    got = restore_checkpoint(str(save / "weights-0"))
    ref = jax.device_get(ts)
    for name in ("params", "ema_params", "model_state"):
        for a, b in zip(tree_leaves(got[name]),
                        jax.tree_util.tree_leaves(ref[name])):
            np.testing.assert_array_equal(a.numpy(), b)
    assert got["step"] == 0 and got["opt_state"]["count"] == 0
    res = train.main(train_args(corpus, save, "-step", "1", "-restore",
                                str(save / "weights-0")))
    assert res["step"] == 1 and (save / "weights-1.npz").exists()


def test_cuda_device_without_gpu_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from vqvae_wavenet_torch import train
    args = train_args(corpus, tmp_path, "-step", "1")
    args[args.index("-device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(args)


def test_loader_native_trains(corpus, tmp_path, capfd):
    """-loader native reads the 16 kHz PCM16 corpus with the C++ loader
    (built from cpp/dataloader.cpp into build/) and trains; the loaders'
    batches are compared in tests/test_torch_native_loader.py."""
    from vqvae_wavenet_torch import native_loader, train
    if native_loader.build_error() is not None:
        pytest.skip("g++ cannot build the native loader here")
    res = train.main(train_args(corpus, tmp_path, "-step", "2", "-loader",
                                "native"))
    assert "[data] native C++ loader: 4 files" in capfd.readouterr().out
    assert res["step"] == 2 and np.isfinite(res["losses"]).all()


@pytest.mark.parametrize("flag,devices,ranks,line", [
    (["-decoder_halo", "recompute"], 1, 2,
     "1 data row(s) of 2 clips, decoder halo recompute"),
    (["-decoder_halo", "layer"], 1, 2,
     "1 data row(s) of 2 clips, decoder halo layer"),
    ([], 4, 4, "2 data row(s) of 1 clips, decoder halo auto")])
def test_time_shards_options_train(corpus, tmp_path, capfd, monkeypatch,
                                   flag, devices, ranks, line):
    """-time_shards 2 trains a step with each decoder halo, and on a host
    of four devices (the count patched) as a data 2 x time 2 mesh."""
    from vqvae_wavenet_torch import train
    from vqvae_wavenet_torch.parallel import mesh
    monkeypatch.setattr(mesh, "device_count", lambda device_type: devices)
    res = train.main(train_args(corpus, tmp_path, "-step", "1",
                                "-time_shards", "2", *flag))
    out = capfd.readouterr().out
    assert res["step"] == 1 and np.isfinite(res["losses"]).all()
    assert len(res["launches"]) == ranks
    assert (tmp_path / "weights-1.npz").exists()
    assert ("[mesh] data=2 x time=2" in out) == (ranks == 4)
    assert "[sp] 2 time shards of 512 samples, backend gloo; " + line in out


def test_time_shards_across_two_hosts(corpus, tmp_path):
    """-time_shards 2 with -coordinator/-num_processes/-process_id: two
    one-device hosts hold one time row (data = 1), which takes the global
    batch of both hosts' clips; both report the same losses."""
    from vqvae_wavenet_torch.parallel import free_port
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = []
    for h in (0, 1):
        args = train_args(corpus, tmp_path / f"host{h}", "-step", "1",
                          "-time_shards", "2", "-coordinator",
                          f"127.0.0.1:{port}", "-num_processes", "2",
                          "-process_id", str(h))
        script = ("import json, sys; sys.path.insert(0, %r)\n"
                  "from vqvae_wavenet_torch import train\n"
                  "res = train.main(%r)\n"
                  "print('HOST_LOSSES', json.dumps(res['losses']))\n"
                  % (REPO, args))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], cwd=str(tmp_path), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, out + err
        outs.append(out)
    losses = [json.loads(o.split("HOST_LOSSES", 1)[1]) for o in outs]
    assert losses[0] == losses[1] and np.isfinite(losses[0]).all()
    assert "[sp] 2 time shards of 512 samples, backend gloo; 1 data " \
        "row(s) of 4 clips" in outs[0]
    assert (tmp_path / "host0" / "weights-1.npz").exists()
    assert not (tmp_path / "host1").exists()


@pytest.mark.parametrize("flag", [["-coordinator", "localhost:1234"],
                                  ["-num_processes", "4"],
                                  ["-process_id", "1"],
                                  ["-coordinator", "localhost:1234",
                                   "-num_processes", "2", "-process_id",
                                   "2"]])
def test_incomplete_multihost_flags_raise(corpus, tmp_path, flag):
    """The multi-host flags go together, with a process id below the
    process count (tests/test_torch_dp.py runs two hosts)."""
    from vqvae_wavenet_torch import train
    with pytest.raises(ValueError, match="process"):
        train.main(train_args(corpus, tmp_path, "-step", "1", *flag))
