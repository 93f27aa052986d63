"""The port's voice-conversion CLI end to end on a synthetic corpus:
JAX init_train_state -> orbax save_checkpoint -> tools/export_torch_npz.py
-> python -m vqvae_wavenet_torch.generate -device cpu, against the JAX
generate.py on the same checkpoint; plus the no-jax import proof.

Tolerance: greedy float32 wavs at atol 1e-6, far below the smallest mu-law
step (~8.5e-5), so the generated bins are identical.
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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Speaker tables, a 1,024-sample conditioning wav and tiny configs
    (the layout of tests/test_cli.py)."""
    root = tmp_path_factory.mktemp("torch_cli")
    info = root / "data" / "vctk_info"
    info.mkdir(parents=True)
    speakers = ["p225", "p226"] + [f"p{300 + i}" for i in range(107)]
    (info / "vctk_speakers.txt").write_text(
        "".join(f"{s}, {i}\n" for i, s in enumerate(speakers)))
    t = np.arange(1024) / 16000.0
    wav = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * np.sin(
        2 * np.pi * 1300.0 * t)
    wavfile.write(str(root / "input.wav"), 16000,
                  (wav * 32767).astype(np.int16))
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


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_npz", os.path.join(REPO, "tools", "export_torch_npz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli_args(corpus, restore, *extra):
    return ["-restore", str(restore), "-audio", str(corpus / "input.wav"),
            "-speakers", "p225", "p226", "None", "-mode", "greedy",
            "-params", str(corpus / "tiny_model.json"),
            "-data", str(corpus / "data"), *extra]


def test_export_and_generate_match_jax(corpus):
    import jax
    import generate as jax_generate
    from vqvae_wavenet_tpu.config import ModelConfig
    from vqvae_wavenet_tpu.training.checkpoint import save_checkpoint
    from vqvae_wavenet_tpu.training.train_loop import init_train_state
    from vqvae_wavenet_torch import generate as torch_generate

    cfg = ModelConfig.from_json(str(corpus / "tiny_model.json"))
    ts = init_train_state(jax.random.PRNGKey(3), cfg, 109)
    (corpus / "jax_model").mkdir()
    ckpt = save_checkpoint(str(corpus / "jax_model"), ts, wait=True)

    npz = corpus / "torch_model" / "weights-0.npz"
    npz.parent.mkdir()
    _export_tool().main(["-restore", ckpt, "-params",
                         str(corpus / "tiny_model.json"), "-out", str(npz)])

    jax_generate.main(_cli_args(corpus, ckpt))
    res = torch_generate.main(_cli_args(corpus, npz, "-device", "cpu"))
    for name in ("0_p225.wav", "0_p226.wav", "0_no_speaker.wav"):
        sr, ref = wavfile.read(str(corpus / "jax_model" / name))
        sr2, got = wavfile.read(str(corpus / "torch_model" / name))
        assert sr == sr2 == 16000 and got.shape == ref.shape == (1024,)
        np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_array_equal(
        np.load(corpus / "torch_model" / "embedding_0.npy"),
        np.load(corpus / "jax_model" / "embedding_0.npy"))
    assert res["audio"].shape == (3, 1024)


NO_JAX_SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
sys.path.insert(0, {repo!r})
import numpy as np
import vqvae_wavenet_torch
from vqvae_wavenet_torch import generate
from vqvae_wavenet_torch.config import ModelConfig
from vqvae_wavenet_torch.params import random_params_np, save_npz
cfg = ModelConfig.from_json({model!r})
params, state = random_params_np(cfg, 109, seed=0)
save_npz({npz!r}, params, state)
res = generate.main({args!r})
assert res["audio"].shape == (3, 1024) and np.isfinite(res["audio"]).all()
assert not any(m == "jax" or m.startswith("vqvae_wavenet_tpu")
               for m, v in sys.modules.items() if v is not None)
print("NO_JAX_OK")
"""


def test_port_runs_without_jax(corpus, tmp_path):
    npz = tmp_path / "weights-7.npz"
    script = NO_JAX_SCRIPT.format(
        repo=REPO, model=str(corpus / "tiny_model.json"), npz=str(npz),
        args=_cli_args(corpus, npz, "-device", "cpu", "-mode", "sample"))
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK" in out.stdout
    for name in ("7_p225.wav", "7_p226.wav", "7_no_speaker.wav"):
        assert (tmp_path / name).exists()


def test_cuda_device_without_gpu_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from vqvae_wavenet_torch import generate as torch_generate
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_generate.main(_cli_args(corpus, tmp_path / "weights-1.npz",
                                      "-device", "cuda"))
