"""Sequence-parallel training of the port on the CPU: ranks spawned with
torch.multiprocessing, gloo between them, the stack's plain twins.

  * 2 ranks against JAX's ``time_sharded_loss(decoder_halo='fused')`` on
    the 2-device CPU mesh, at the widths of JAX's own SP tests
    (tests/test_timeshard.py:587-663: R = S = 128, 2D = 128, dilations
    [1, 2, 1, 2], K = 3, B = 1, T = 512, biases bumped): the loss within
    rtol 2e-4 and every gradient leaf within 5e-3 of max(its largest
    |value|, 1e-4 of the largest of any leaf), JAX's own tolerances;
  * the same ranks in bf16 against the port's single-device bf16 step:
    the loss within rtol 2e-2 and each leaf's gradient within rel L2 5e-2
    or abs L2 1e-2 of the global norm (tests/test_timeshard.py:371-391),
    or else no further (rel L2, x 1.1) from the f32 gradient than the
    single-device bf16 gradient is.  The second branch serves the leaves
    whose bf16 gradient is noise-dominated: the encoder's conv kernels,
    whose gradients are rounded to bf16 at every layer and lie ~32% (rel
    L2) from f32; scaling the input by 1 + 1e-6 moves the single-device
    bf16 gradient of those leaves by 7-11%, and SP moves it by 6-8%.  JAX's
    own SP misses JAX's rule on the same leaves at this shape (rel L2
    0.09);
  * 4 ranks with dilations [1, 64, 1, 64] at T = 256: every group's halo
    (192 rows) spans three shards and the starts are 192/128/64/0
    (tests/test_timeshard.py:666-693), against the port's single-device
    loss_and_grads on the port's own random init, with the f32 tolerances
    above;
  * after one step every rank holds the same parameters;
  * the CLI ``-time_shards 2 -device cpu`` trains two steps and the port's
    generate.py converts with rank 0's checkpoint, in a process where jax
    and the JAX package cannot be imported, nor in the ranks it spawns.
The ranks import this module, which therefore imports jax only inside
functions; they report what they imported, and none may be jax.
"""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vqvae_wavenet_torch.config import ModelConfig, WavenetConfig  # noqa
from vqvae_wavenet_torch.ops.conv import set_full_f32  # noqa: E402
from vqvae_wavenet_torch.parallel import run_ranks  # noqa: E402
from vqvae_wavenet_torch.parallel.timeshard import (  # noqa: E402
    check_supported, fused_sp_groups, halo_sizes, sp_loss_and_grads)
from vqvae_wavenet_torch.params import from_jax_tree  # noqa: E402
from vqvae_wavenet_torch.training.optimizer import tree_leaves  # noqa
from vqvae_wavenet_torch.training.train_loop import (  # noqa: E402
    init_train_state, loss_and_grads, train_step)

WN = dict(quantization_channels=64, num_cycles=2, num_cycle_layers=2,
          dilation_rates=[1, 2, 1, 2], kernel_size=3, dilation_filters=64,
          skip_filters=128, residual_filters=128, preprocess_kernel_size=8,
          preprocess_filters=128)
MODEL = dict(encoder="64", use_vq=True, speaker_embedding=4, k=8,
             latent_dim=4, beta=0.25, learning_rate_schedule={0: 1e-3})
MULTIHOP = [1, 64, 1, 64]
RANK_TIMEOUT = 240


def port_cfg(dils=None, **kw):
    wn = dict(WN, dilation_rates=list(dils or WN["dilation_rates"]))
    return ModelConfig(**dict(MODEL, wavenet=WavenetConfig(**wn), **kw))


def jax_case(dils, B, T, seed):
    """numpy (params, state, x, y) from JAX's init with every bias bumped
    by 0.1, as tests/test_timeshard.py::bump_biases does."""
    import jax
    import jax.numpy as jnp
    from vqvae_wavenet_tpu.config import ModelConfig as JModelConfig
    from vqvae_wavenet_tpu.config import WavenetConfig as JWavenetConfig
    from vqvae_wavenet_tpu.models.vqvae import init_vqvae
    cfg = JModelConfig(**dict(MODEL, wavenet=JWavenetConfig(
        **dict(WN, dilation_rates=list(dils)))))
    params, state = init_vqvae(jax.random.PRNGKey(seed), cfg, num_speakers=4)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 if "bias" in str(p[-1]) else v, params)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (B, T, 1)).astype(np.float32)
    y = np.asarray(jax.nn.one_hot(jnp.arange(B) % 4, 4)[:, None, :])
    return cfg, jax.device_get(params), jax.device_get(state), x, y


def port_case(dils, B, T, seed):
    """numpy (params, state, x, y) from the port's own random init, every
    bias bumped by 0.1."""
    from vqvae_wavenet_torch.params import random_params_np
    params, state = random_params_np(port_cfg(dils), 4, seed=seed)

    def bump(tree, name=""):
        if isinstance(tree, dict):
            return {k: bump(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [bump(v) for v in tree]
        return tree + np.float32(0.1) if "bias" in name else tree
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (B, T, 1)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[np.arange(B) % 4][:, None, :]
    return bump(params), state, x, y


def _imported_jax():
    return sorted(m for m in sys.modules if m == "jax"
                  or m.startswith(("jax.", "vqvae_wavenet_tpu")))


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def sp_rank(sh, params, state, x, y, dils, dtypes):
    """One rank: for each train_dtype, the SP loss and gradients of its
    time slice, then one step; rank 0 returns the gradients, every rank
    digests of its gradients and updated parameters."""
    set_full_f32()
    t_l = x.shape[1] // sh.world
    batch = {"x": torch.from_numpy(x[:, sh.rank * t_l:(sh.rank + 1) * t_l]),
             "y": torch.from_numpy(y)}
    out = {}
    for dtype in dtypes:
        cfg = port_cfg(dils, train_dtype=dtype)
        p, s = from_jax_tree(params, state)
        loss, aux, grads = sp_loss_and_grads(p, s, cfg, batch, sh)
        ts, _ = train_step(init_train_state(p, s), batch, cfg, sh=sh,
                           grads_fn=lambda *a: sp_loss_and_grads(*a, sh))
        out[dtype] = {
            "loss": float(loss), "recon": float(aux["reconstruction_loss"]),
            "perplexity": float(aux["perplexity"]),
            "grads": [g.numpy() for g in grads] if sh.rank == 0 else None,
            "digest": (_digest(grads), _digest(tree_leaves(ts["params"])))}
    out["imported"] = _imported_jax()
    return out


def single_device(params, state, x, y, dils, dtype):
    cfg = port_cfg(dils, train_dtype=dtype)
    p, s = from_jax_tree(params, state)
    loss, aux, grads = loss_and_grads(p, s, cfg, {"x": torch.tensor(x),
                                                  "y": torch.tensor(y)})
    return float(loss), [g.numpy() for g in grads]


def check_f32_grads(got, ref):
    """JAX's rule (tests/test_timeshard.py:654-663)."""
    gmax = max(np.abs(r).max() for r in ref)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = max(np.abs(r).max(), 1e-4 * gmax)
        err = np.abs(np.asarray(g, np.float64) - r).max() / scale
        assert err < 5e-3, (i, r.shape, err)


def check_bf16_grads(got, ref, ref32):
    """JAX's rule for bf16 (tests/test_timeshard.py:380-392) against the
    single-device bf16 gradient ``ref``, or no further from the f32
    gradient ``ref32`` than ``ref`` is, within 10% (module docstring)."""
    gn = np.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64)))
                     for r in ref))
    for i, (g, r, r32) in enumerate(zip(got, ref, ref32)):
        g = np.asarray(g, np.float64)
        nd = np.linalg.norm(g - r)
        rel = nd / (np.linalg.norm(r) + 1e-12)
        if not (rel < 5e-2 or nd < 1e-2 * gn):
            assert (np.linalg.norm(g - r32)
                    <= 1.1 * np.linalg.norm(r - r32)), (i, r.shape, rel)


@pytest.fixture(scope="module")
def two_ranks():
    dils = WN["dilation_rates"]
    cfg, params, state, x, y = jax_case(dils, 1, 512, seed=0)
    res = run_ranks(sp_rank, 2, "cpu", params, state, x, y, dils,
                    ("f32", "bf16"), timeout=RANK_TIMEOUT, n_time=2)
    return cfg, params, state, x, y, res


def test_two_ranks_match_jax_time_sharded_loss(two_ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from vqvae_wavenet_tpu.parallel.timeshard import time_sharded_loss
    cfg, params, state, x, y, res = two_ranks
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("time",))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: time_sharded_loss(
        p, state, cfg, jnp.asarray(x), jnp.asarray(y), mesh,
        decoder_halo="fused")[0]))(params)
    jg = [np.asarray(g, np.float64)
          for g in jax.tree_util.tree_leaves(jax.device_get(jg))]
    for r in res:
        assert r["f32"]["loss"] == pytest.approx(float(jl), rel=2e-4)
    check_f32_grads(res[0]["f32"]["grads"], jg)


def test_two_ranks_bf16_track_the_single_device_step(two_ranks):
    _, params, state, x, y, res = two_ranks
    dils = WN["dilation_rates"]
    loss, grads = single_device(params, state, x, y, dils, "bf16")
    assert res[0]["bf16"]["loss"] == pytest.approx(loss, rel=2e-2)
    check_bf16_grads(res[0]["bf16"]["grads"], grads,
                     single_device(params, state, x, y, dils, "f32")[1])


def test_ranks_agree_and_import_no_jax(two_ranks):
    res = two_ranks[-1]
    for dtype in ("f32", "bf16"):
        assert len({r[dtype]["digest"] for r in res}) == 1, dtype
        assert len({r[dtype]["loss"] for r in res}) == 1, dtype
        assert np.isfinite(res[0][dtype]["perplexity"])
    assert all(r["imported"] == [] for r in res), [r["imported"]
                                                    for r in res]


def test_four_ranks_multihop_match_single_device():
    params, state, x, y = port_case(MULTIHOP, 1, 256, seed=1)
    res = run_ranks(sp_rank, 4, "cpu", params, state, x, y, MULTIHOP,
                    ("f32",), timeout=RANK_TIMEOUT, n_time=4)
    loss, grads = single_device(params, state, x, y, MULTIHOP, "f32")
    for r in res:
        assert r["f32"]["loss"] == pytest.approx(loss, rel=2e-4)
    assert len({r["f32"]["digest"] for r in res}) == 1
    check_f32_grads(res[0]["f32"]["grads"], grads)


def test_halo_sizes_and_cycle_plans_match_jax():
    from vqvae_wavenet_tpu.config import WavenetConfig as JWavenetConfig
    from vqvae_wavenet_tpu.parallel import timeshard as jts
    shipped = dict(quantization_channels=256, num_cycles=3,
                   num_cycle_layers=10, dilation_rates=[2 ** i for i in
                                                        range(10)] * 3,
                   kernel_size=3, dilation_filters=256, skip_filters=512,
                   residual_filters=256, preprocess_kernel_size=32,
                   preprocess_filters=256)
    for wn, t_l in ((shipped, 3328), (shipped, 1664), (WN, 256),
                    (dict(WN, dilation_rates=MULTIHOP), 64)):
        ours, theirs = WavenetConfig(**wn), JWavenetConfig(**wn)
        assert halo_sizes(ours, 64) == jts.halo_sizes(theirs, 64)
        assert fused_sp_groups(ours, 64, t_l) == jts._fused_sp_groups(
            theirs, 64, t_l)
    groups, q = fused_sp_groups(WavenetConfig(**shipped), 64, 1664)
    assert q == 128 and [h for _, _, h in groups] == [2048] * 3


@pytest.mark.parametrize("kw,length,world,halo,error", [
    ({}, 384, 4, "fused", ValueError),          # 96-sample shards
    (dict(time_jitter=True), 512, 2, "fused", NotImplementedError),
    (dict(condition_upsample=True), 512, 2, "fused", NotImplementedError)])
def test_unported_sp_options_raise(kw, length, world, halo, error):
    with pytest.raises(error, match="JAX's SP asserts the same"
                       if error is NotImplementedError else "shards"):
        check_supported(port_cfg(**kw), length, world, halo)


@pytest.mark.parametrize("kw,halo,plan", [
    (dict(vq_mode="ema"), "fused", [(0, 2, 256), (2, 4, 256)]),
    (dict(encoder_norm="group"), "fused", [(0, 2, 256), (2, 4, 256)]),
    ({}, "layer", [(l, l + 1, 64) for l in range(4)])])
def test_sp_options_have_a_plan(kw, halo, plan):
    """The options SP once refused: check_supported returns their decoder
    plan (JAX's q = 256 for 256-sample shards; a frame a layer)."""
    assert check_supported(port_cfg(**kw), 512, 2, halo) == plan


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two speakers x two 1 s utterances in the VCTK layout, the 109-entry
    speaker table, a tiny model config (widths 16, two cycles of
    dilations 1-4 and 8-32), and stub packages named jax and
    vqvae_wavenet_tpu whose import fails."""
    from scipy.io import wavfile
    root = tmp_path_factory.mktemp("sp_cli")
    info = root / "data" / "vctk_info"
    info.mkdir(parents=True)
    speakers = ["p225", "p226"] + [f"p{300 + i}" for i in range(107)]
    (info / "vctk_speakers.txt").write_text(
        "".join(f"{s}, {i}\n" for i, s in enumerate(speakers)))
    t = np.arange(16000) / 16000.0
    files = []
    for s, f0 in (("p225", 220.0), ("p226", 440.0)):
        (root / "data" / "VCTK-Corpus" / "wav48" / s).mkdir(parents=True)
        for u in range(2):
            name = f"{s}/{s}_{u:03d}.wav"
            wavfile.write(str(root / "data" / "VCTK-Corpus" / "wav48" / name),
                          16000, (0.4 * np.sin(2 * np.pi * f0 * (1 + u) * t)
                                  * 32767).astype(np.int16))
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
    (root / "wavenet.json").write_text(json.dumps(wn))
    mp = {"encoder": "64", "use_vq": True, "speaker_embedding": 8, "k": 16,
          "latent_dim": 8, "beta": 0.25, "verbose": False,
          "wavenet_parameters": str(root / "wavenet.json"),
          "learning_rate_schedule": {"0": 1e-3}}
    (root / "model.json").write_text(json.dumps(mp))
    for pkg in ("jax", "vqvae_wavenet_tpu"):
        (root / "stubs" / pkg).mkdir(parents=True)
        (root / "stubs" / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} may not be imported here')\n")
    return root


SP_CLI_SCRIPT = r"""
import os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {stubs!r})      # inherited by the spawned ranks
sys.modules["jax"] = None
import numpy as np
from vqvae_wavenet_torch import generate, train
res = train.main({train_args!r})
assert res["step"] == 2 and np.isfinite(res["losses"]).all(), res
assert len(res["launches"]) == 2, res["launches"]
assert os.path.exists(os.path.join({save!r}, "weights-2.npz"))
rows = open(os.path.join({save!r}, "metrics.jsonl")).read().splitlines()
assert len(rows) == 2, rows
out = generate.main({gen_args!r})
assert out["audio"].shape == (1, 1024) and np.isfinite(out["audio"]).all()
assert not any(m == "jax" or m.startswith("vqvae_wavenet_tpu")
               for m, v in sys.modules.items() if v is not None)
print("SP_CLI_OK")
"""


def test_cli_time_shards_trains_and_generates_without_jax(corpus, tmp_path):
    save = tmp_path / "saved"
    train_args = ["-dataset", "VCTK", "-length", "1024", "-batch", "2",
                  "-step", "2", "-save", str(save / "weights"),
                  "-params", str(corpus / "model.json"),
                  "-data", str(corpus / "data"), "-interval", "1",
                  "-device", "cpu", "-time_shards", "2"]
    gen_args = ["-restore", str(save / "weights-2.npz"),
                "-audio", str(corpus / "input.wav"), "-speakers", "p226",
                "-mode", "greedy", "-params", str(corpus / "model.json"),
                "-data", str(corpus / "data"), "-device", "cpu"]
    script = SP_CLI_SCRIPT.format(repo=REPO, stubs=str(corpus / "stubs"),
                                  train_args=train_args, save=str(save),
                                  gen_args=gen_args)
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SP_CLI_OK" in out.stdout
    assert "[sp] 2 time shards of 512 samples, backend gloo" in out.stdout
    assert (save / "2_p226.wav").exists()


FAKE_NVCC = """#!/bin/sh
echo run >> "$FAKE_NVCC_COUNT"
sleep 0.3
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
: > "$out"
"""


def test_concurrent_builds_compile_each_source_once(tmp_path, monkeypatch):
    """Ranks that reach a missing library at once: the build lock lets one
    compile it and the others find it (a stand-in nvcc counts its runs)."""
    import threading
    from vqvae_wavenet_torch.ops import _build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// a kernel\n")
    count = tmp_path / "runs"
    monkeypatch.setenv("FAKE_NVCC_COUNT", str(count))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC", str(tmp_path / "csrc"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    errors = []

    def build():
        try:
            _build.build(["k"])
        except Exception as e:           # reported below, with the others
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert count.read_text().split() == ["run"]
    assert os.path.exists(_build._library_path("k"))
