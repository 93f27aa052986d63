"""The Magenta family's voice-conversion path of the torch port against the
JAX package (vqvae_wavenet_tpu/models/magenta.py), on the CPU.

Tolerances: the encoder at its real widths (368, 64) within 1e-5 of
max|z_e| (seven float32 convs summed in another order in XLA and in torch)
with identical VQ codes; a small Magenta-shaped decoder's teacher-forced
logits at rtol/atol 1e-4 and greedy float32 waveforms at atol 1e-6, far
below the smallest mu-law step (~8.5e-5), so the bins are identical; the
exported checkpoint exactly.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vqvae_wavenet_tpu.config import ModelConfig as JModelConfig
from vqvae_wavenet_tpu.config import WavenetConfig
from vqvae_wavenet_tpu.generation import fast as jfast
from vqvae_wavenet_tpu.models import magenta as jmagenta
from vqvae_wavenet_tpu.models import vq as jvq
from vqvae_wavenet_tpu.models.wavenet import init_wavenet_params
from vqvae_wavenet_torch.config import ModelConfig
from vqvae_wavenet_torch.generation import fast as tfast
from vqvae_wavenet_torch.models import magenta as tmagenta
from vqvae_wavenet_torch.models import vq as tvq
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import (flatten, load_npz, random_params_np,
                                        save_npz, to_torch)

set_full_f32()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGENTA_JSON = os.path.join(REPO, "magenta_parameters.json")


@pytest.fixture(scope="module")
def full_params():
    """A random full-preset Magenta tree (numpy), from a seed."""
    cfg = ModelConfig.from_json(MAGENTA_JSON)
    params, state = random_params_np(cfg, 109, seed=0)
    assert state == {}
    return params


def test_config_matches_jax():
    got = ModelConfig.from_json(MAGENTA_JSON)
    ref = JModelConfig.from_json(MAGENTA_JSON)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "wavenet":     # the port's WavenetConfig has no verbose
            a = dataclasses.asdict(a)
            b = {k: tuple(v) if k == "dilation_rates" else v
                 for k, v in dataclasses.asdict(b).items() if k in a}
        assert a == b, f.name
    assert got.wavenet.num_layers == 50 and got.wavenet.kernel_size == 2
    assert got.wavenet.preprocess_kernel_size == 2


def test_random_tree_has_the_jax_structure(full_params):
    shapes = jax.eval_shape(
        lambda k: jmagenta.init_magenta_params(k, 109), jax.random.PRNGKey(0))
    ref, got = {}, {}
    flatten(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes), "p", ref)
    flatten(full_params, "p", got)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    dec = full_params["decoder"]
    for leaf in (dec["layers"]["bias"], dec["layers"]["gc_bias"],
                 dec["postprocess1"]["gc_bias"],
                 full_params["encoder"]["layers"][3]["gate"]["bias"]):
        assert (leaf == 1.0).all()


def test_encoder_and_codes_match_jax(full_params):
    x = np.random.default_rng(3).uniform(-0.8, 0.8, (2, 512, 1)
                                         ).astype(np.float32)
    enc = full_params["encoder"]
    ref = np.asarray(jmagenta.magenta_encode(
        jax.tree_util.tree_map(jnp.asarray, enc), jnp.asarray(x)))
    got = tmagenta.magenta_encode(to_torch(enc), torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 8, 64)
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err
    vq = full_params["vq"]
    codes_ref = np.asarray(jvq.quantize(
        {"embedding": jnp.asarray(vq["embedding"])}, jnp.asarray(ref),
        mode="st")["q_z_x"])
    codes = tvq.quantize(to_torch(vq), got, mode="st")["q_z_x"]
    np.testing.assert_array_equal(codes.numpy(), codes_ref)


def small_cfg():
    """Magenta's decoder shape at small widths: K=2, PK=2."""
    return WavenetConfig(quantization_channels=32, num_cycles=2,
                         num_cycle_layers=3, dilation_rates=[1, 2, 4] * 2,
                         kernel_size=2, dilation_filters=16, skip_filters=24,
                         residual_filters=16, preprocess_kernel_size=2,
                         preprocess_filters=16)


def small_decoder(cfg, c_lc=8, c_gc=6, seed=0):
    """init_wavenet_params with gc, every bias 1.0 and the add_gc biases,
    as init_magenta_params sets them (magenta.py:97-108)."""
    p = jax.device_get(init_wavenet_params(jax.random.PRNGKey(seed), cfg,
                                           c_lc, c_gc))
    for grp in p.values():
        for k in list(grp):
            if "bias" in k:
                grp[k] = np.ones_like(grp[k])
    L, D, S = cfg.num_layers, cfg.dilation_filters, cfg.skip_filters
    p["layers"]["gc_bias"] = np.ones((L, 2 * D), np.float32)
    p["postprocess1"]["gc_bias"] = np.ones((S,), np.float32)
    return p


def conditions(b, t_cond, c_lc=8, c_gc=6, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t_cond, c_lc)).astype(np.float32),
            rng.standard_normal((b, 1, c_gc)).astype(np.float32))


def test_small_decoder_teacher_forced_matches_jax():
    cfg = small_cfg()
    p = small_decoder(cfg)
    lc, gc = conditions(2, 5)
    x = np.random.default_rng(2).uniform(-0.9, 0.9, (2, 40, 1)
                                         ).astype(np.float32)
    ref = np.asarray(jfast.teacher_forced_stepper(
        jax.tree_util.tree_map(jnp.asarray, p), cfg, jnp.asarray(x),
        jnp.asarray(lc), gate_order="sigmoid_first",
        global_condition=jnp.asarray(gc)))
    got = tfast.teacher_forced_stepper(
        to_torch(p), cfg, torch.from_numpy(x), torch.from_numpy(lc),
        gate_order="sigmoid_first", global_condition=torch.from_numpy(gc))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_small_decoder_greedy_matches_jax():
    cfg = small_cfg()
    p = small_decoder(cfg)
    lc, gc = conditions(2, 4)
    ref = np.asarray(jfast.generate(
        jax.tree_util.tree_map(jnp.asarray, p), cfg, jnp.asarray(lc),
        length=48, mode="greedy", gate_order="sigmoid_first", engine="xla",
        global_condition=jnp.asarray(gc)))
    got = tfast.generate(to_torch(p), cfg, torch.from_numpy(lc), length=48,
                         mode="greedy", gate_order="sigmoid_first",
                         global_condition=torch.from_numpy(gc))
    assert len(np.unique(ref)) > 1
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_npz_round_trip_keeps_the_encoder_list(full_params, tmp_path):
    path = str(tmp_path / "weights-5.npz")
    save_npz(path, full_params, {})
    params, state = load_npz(path)
    assert state == {}
    assert isinstance(params["encoder"]["layers"], list)
    assert set(params["encoder"]["layers"][0]) == {"conv", "gate", "res"}
    ref, got = {}, {}
    flatten(full_params, "p", ref)
    flatten(params, "p", got)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_export_round_trips_a_jax_checkpoint(tmp_path):
    """A JAX Magenta train state (the init's tree, filled from a numpy
    seed) -> orbax -> tools/export_torch_npz.py -> the raw params."""
    from vqvae_wavenet_tpu.training.checkpoint import save_checkpoint
    from vqvae_wavenet_tpu.training.train_loop import init_train_state
    cfg = JModelConfig.from_json(MAGENTA_JSON)
    shapes = jax.eval_shape(lambda k: init_train_state(k, cfg, 109),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    ts = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    ts["params"] = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype),
        shapes["params"])
    (tmp_path / "jax").mkdir()
    ckpt = save_checkpoint(str(tmp_path / "jax"), ts, wait=True)
    spec = importlib.util.spec_from_file_location(
        "export_torch_npz", os.path.join(REPO, "tools", "export_torch_npz.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / "weights-0.npz")
    tool.main(["-restore", ckpt, "-params", MAGENTA_JSON, "-out", out])
    params, state = load_npz(out)
    assert state == {}
    ref, got = {}, {}
    flatten(ts["params"], "p", ref)       # raw params, not the EMA zeros
    flatten(params, "p", got)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


NO_JAX_CLI = r"""
import sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
sys.path.insert(0, {repo!r})
import numpy as np
import torch
# one thread: the step's products are [2, 576] x [576, 512]; more threads
# only spin against the other workers of a parallel test run
torch.set_num_threads(1)
from vqvae_wavenet_torch import generate
from vqvae_wavenet_torch.config import ModelConfig
from vqvae_wavenet_torch.ops import gen_kernels
from vqvae_wavenet_torch.params import random_params_np, save_npz
params, state = random_params_np(ModelConfig.from_json({model!r}), 109, 0)
save_npz({npz!r}, params, state)
res = generate.main({args!r})
assert res["audio"].shape == (2, 512) and np.isfinite(res["audio"]).all()
assert gen_kernels.launches == gen_kernels.int8_launches == 0
assert not any(m == "jax" or m.startswith("vqvae_wavenet_tpu")
               for m, v in sys.modules.items() if v is not None)
print("NO_JAX_MAGENTA_OK")
"""


def test_cli_int8_full_preset_without_jax(tmp_path):
    """python -m vqvae_wavenet_torch.generate -params magenta_parameters.json
    -dtype int8 -device cpu on a random full-preset .npz: one finite wav per
    speaker (512 samples, generated in a 1,024 bucket), with jax blocked."""
    t = np.arange(512) / 16000.0
    wavfile.write(str(tmp_path / "in.wav"), 16000,
                  (0.4 * np.sin(2 * np.pi * 220.0 * t) * 32767
                   ).astype(np.int16))
    npz = tmp_path / "weights-9.npz"
    args = ["-restore", str(npz), "-audio", str(tmp_path / "in.wav"),
            "-speakers", "p225", "None", "-mode", "sample", "-params",
            MAGENTA_JSON, "-data", os.path.join(REPO, "data"), "-dtype",
            "int8", "-device", "cpu"]
    script = NO_JAX_CLI.format(repo=REPO, model=MAGENTA_JSON, npz=str(npz),
                               args=args)
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_MAGENTA_OK" in out.stdout
    for name in ("9_p225.wav", "9_no_speaker.wav"):
        sr, wav = wavfile.read(str(tmp_path / name))
        assert sr == 16000 and wav.shape == (512,)
        assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    assert (tmp_path / "speaker_embedding_9.npy").exists()


def test_cli_refuses_data_shards(tmp_path):
    """More shards than devices (the CPU is one) raise before any file is
    read (tests/test_torch_genshard.py runs sharded generation)."""
    from vqvae_wavenet_torch import generate
    with pytest.raises(ValueError, match="data_shards"):
        generate.main(["-restore", str(tmp_path / "w-1.npz"), "-audio", "x",
                       "-speakers", "p225", "-params", MAGENTA_JSON,
                       "-data_shards", "2", "-device", "cpu"])
