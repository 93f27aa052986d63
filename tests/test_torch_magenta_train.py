"""The Magenta family's training in the torch port against the JAX package
(vqvae_wavenet_tpu/models/magenta.py, training/train_loop.py), on the CPU.

The family's hyperparameters are module constants in both packages.  So
that JAX's gradient of the decoder fits a CPU test, the tests that run
the model patch NUM_LAYERS / NUM_STAGES in both modules to 4 layers of 2
stages (dilations 1, 2, 1, 2); the encoder, the VQ and the widths
(R = D = 256, S = 512) stay the family's own.  The CLI test also narrows
the widths (``tiny_magenta``).

Tolerances.  regularization_loss: rtol 1e-6 (float32 sums of squares in
another order).  magenta_forward in f32 at B=1, T=512: the loss within
1e-5 relative, identical VQ codes, every gradient leaf within 1e-4 of its
largest |value|.  Two optimizer steps, each from JAX's state before it:
as tests/test_torch_train_step.py holds the main family (Adam beta1 here
0.5): the loss within 1e-4, the updates of params and EMA shadows within
1e-3 where the gradient is well above rounding, else 2.5 lr.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vqvae_wavenet_tpu.config import ModelConfig as JModelConfig
from vqvae_wavenet_tpu.models import magenta as jmagenta
from vqvae_wavenet_tpu.training import train_loop as jloop
from vqvae_wavenet_torch.config import ModelConfig
from vqvae_wavenet_torch.models import magenta as tmagenta
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import (from_jax_train_state,
                                        random_params_np, to_torch)
from vqvae_wavenet_torch.training import train_loop as tloop
from vqvae_wavenet_torch.training.optimizer import tree_leaves

set_full_f32()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGENTA_JSON = os.path.join(REPO, "magenta_parameters.json")
LR = 1e-4                       # MAGENTA_LR_SCHEDULE[0]


@pytest.fixture
def shallow(monkeypatch):
    """4 decoder layers of 2 stages in both packages."""
    for mod in (jmagenta, tmagenta):
        monkeypatch.setattr(mod, "NUM_LAYERS", 4)
        monkeypatch.setattr(mod, "NUM_STAGES", 2)


@pytest.fixture
def tiny_magenta(shallow, monkeypatch):
    """The shallow decoder at narrow widths, and a narrow encoder (the
    port only: the CLI test runs no JAX)."""
    for name, v in (("WIDTH", 16), ("SKIP_WIDTH", 24), ("AE_WIDTH", 32)):
        monkeypatch.setattr(tmagenta, name, v)


def jax_state(seed=0, num_speakers=3):
    cfg = JModelConfig.from_json(MAGENTA_JSON)
    return jax.device_get(jax.jit(lambda k: jloop.init_train_state(
        k, cfg, num_speakers))(jax.random.PRNGKey(seed)))


def batch_np(seed, B=1, T=512, S=3):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    x = (0.4 * np.sin(2 * np.pi * rng.uniform(150, 400, (B, 1)) * t)
         + 0.05 * rng.standard_normal((B, T))).astype(np.float32)[..., None]
    y = np.zeros((B, 1, S), np.float32)
    y[np.arange(B), 0, rng.integers(0, S, B)] = 1.0
    return {"x": x, "y": y}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def test_regularization_loss_matches_jax():
    """At the full preset (35M weights) XLA's float32 sum of squares of
    the 13M-element decoder kernel lies 4.6e-6 from the exact sum, and the
    whole loss 1.1e-6 (torch's pairwise sums: 4e-8).  So both are held to
    the float64 sum: the port within rtol 1e-6, and the port within JAX's
    own distance from it + 1e-6 of JAX."""
    cfg = ModelConfig.from_json(MAGENTA_JSON)
    params, _ = random_params_np(cfg, 109, seed=2)
    ref = float(jmagenta.regularization_loss(
        jax.tree_util.tree_map(jnp.asarray, params)))
    got = float(tmagenta.regularization_loss(to_torch(params)))
    exact = sum(1e-6 * (10.0 if "embedding" in path else 1.0)
                * float(np.sum(np.square(leaf.astype(np.float64))))
                for path, leaf in tmagenta._named_leaves(params))
    assert got == pytest.approx(exact, rel=1e-6)
    assert abs(got - ref) <= abs(ref - exact) + 1e-6 * abs(ref)
    # the 10x rule selects the codebook (vq/embedding), not speaker_emb
    small = {"vq": {"embedding": np.ones((2, 2), np.float32)},
             "speaker_emb": np.ones((3, 2), np.float32)}
    ref = float(jmagenta.regularization_loss(
        jax.tree_util.tree_map(jnp.asarray, small)))
    got = float(tmagenta.regularization_loss(to_torch(small)))
    assert ref == pytest.approx(1e-6 * (10 * 4 + 6), rel=1e-6)
    assert got == pytest.approx(ref, rel=1e-6)


def test_forward_loss_and_grads_match_jax(shallow):
    ts = jax_state(seed=1)
    b = batch_np(3)

    def loss_fn(p):
        return jmagenta.magenta_forward(p, jnp.asarray(b["x"]),
                                        jnp.asarray(b["y"]), engine="xla")
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        ts["params"])
    jaux, jgrads = jax.device_get((jaux, jgrads))

    pts = from_jax_train_state(ts)
    loss, aux, grads = tloop.loss_and_grads(
        pts["params"], {}, ModelConfig.from_json(MAGENTA_JSON),
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert rel(loss, jl) < 1e-5
    for k in ("reconstruction_loss", "vq_loss", "commitment_loss",
              "reg_loss", "perplexity", "distances_mean"):
        assert rel(aux[k], jaux[k]) < 1e-5, k
    np.testing.assert_array_equal(aux["q_z_x"].numpy(), jaux["q_z_x"])
    ref = jax.tree_util.tree_leaves(jgrads)
    assert len(ref) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert g is not None and rel(g, r) < 1e-4, (i, rel(g, r))


def t64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def check_update(name, new, old, jnew, jold, jgrads, scale):
    """The port's one-step update of tree ``name`` against JAX's, per
    element in float64, as tests/test_torch_train_step.py::check_update
    holds the main family (2 ulp of the new value, plus 1e-3 of JAX's
    update where the gradient is above 1e-2 of its leaf's largest, else
    2.5 lr * scale).  Returns the largest |update| of the port's tree."""
    gmax = max(float(g.abs().max()) for g in jgrads)
    moved = 0.0
    for k, (a, a0, r, r0) in enumerate(zip(
            tree_leaves(new[name]), tree_leaves(old[name]),
            jax.tree_util.tree_leaves(jnew[name]),
            jax.tree_util.tree_leaves(jold[name]))):
        r, r0 = t64(r), t64(r0)
        dp, dj = a.double() - a0.double(), r - r0
        g = jgrads[k].abs()
        sharp = (g > 1e-2 * g.max()) & (g.max() > 1e-6 * gmax)
        ulp = 2 * torch.finfo(torch.float32).eps * torch.maximum(r.abs(),
                                                                 r0.abs())
        tol = ulp + torch.where(sharp, 1e-3 * dj.abs().clamp_min(LR * scale),
                                2.5 * LR * scale + 1e-4 * dj.abs().max())
        bad = (dp - dj).abs() > tol
        assert not bad.any(), (name, k, tuple(a.shape), int(bad.sum()))
        moved = max(moved, float(dp.abs().max()))
    return moved


def test_two_steps_match_jax(shallow):
    """Two Adam(beta1 0.5) steps, each port step from JAX's state before
    it (EMA decay 0.5 so the shadows' order shows)."""
    cfg_j = JModelConfig.from_json(MAGENTA_JSON)
    cfg_t = ModelConfig.from_json(MAGENTA_JSON)
    decay = 0.5
    jts = jax_state(seed=4)
    step = jax.jit(lambda ts, b: jloop.train_step(ts, b, None, cfg=cfg_j,
                                                  ema_decay=decay))
    for i in range(2):
        b = batch_np(10 + i, B=2)
        pts = from_jax_train_state(jts)
        jnew, jm = jax.device_get(step(
            jts, {k: jnp.asarray(v) for k, v in b.items()}))
        pnew, pm = tloop.train_step(
            pts, {k: torch.from_numpy(v) for k, v in b.items()}, cfg_t,
            ema_decay=decay)
        assert rel(pm["loss"], jm["loss"]) < 1e-4
        assert rel(pm["reg_loss"], jm["reg_loss"]) < 1e-5
        assert pm["lr"] == pytest.approx(float(jm["lr"])) == LR
        assert pnew["step"] == int(jnew["step"]) == i + 1
        assert pnew["opt_state"]["count"] == int(jnew["opt_state"][0].count)
        assert pnew["model_state"] == {}
        # the step's gradients from JAX's first moments (mu = 0.5 mu + 0.5 g)
        jgrads = [(t64(m1) - 0.5 * t64(m0)) / 0.5 for m0, m1 in zip(
                      jax.tree_util.tree_leaves(jts["opt_state"][0].mu),
                      jax.tree_util.tree_leaves(jnew["opt_state"][0].mu))]
        moved = check_update("params", pnew, pts, jnew, jts, jgrads, 1.0)
        assert moved > 0.5 * LR
        check_update("ema_params", pnew, pts, jnew, jts, jgrads, 1 - decay)
        jts = jnew


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two speakers x two 1 s utterances in the VCTK layout and the
    109-entry speaker table."""
    data = tmp_path_factory.mktemp("magenta_train") / "data"
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
    wavfile.write(str(data.parent / "input.wav"), 16000,
                  (0.4 * np.sin(2 * np.pi * 220.0 * t[:1024])
                   * 32767).astype(np.int16))
    return data


def train_args(data, save, *extra):
    return ["-dataset", "VCTK", "-length", "1024", "-batch", "2",
            "-save", str(save / "weights"), "-params", MAGENTA_JSON,
            "-data", str(data), "-interval", "1", "-device", "cpu", *extra]


@pytest.mark.parametrize("bwd", ["auto", "off"])
def test_cli_trains_and_generate_reads_raw_params(tiny_magenta, corpus,
                                                  tmp_path, monkeypatch,
                                                  bwd):
    """python -m vqvae_wavenet_torch.train -params magenta_parameters.json
    on the CPU: the loss falls over 3 steps (either backward); the
    checkpoint's raw params (train/params) are what generate reads."""
    from vqvae_wavenet_torch import generate, train
    from vqvae_wavenet_torch.ops import train_kernels
    from vqvae_wavenet_torch.params import load_npz
    from vqvae_wavenet_torch.training.checkpoint import restore_checkpoint
    monkeypatch.setattr(train_kernels, "BWD_FUSED_DK", bwd)
    res = train.main(train_args(corpus, tmp_path, "-step", "3"))
    losses = res["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    ckpt = tmp_path / "weights-3.npz"
    ts = restore_checkpoint(str(ckpt))
    raw, state = load_npz(str(ckpt), raw_params=True)
    ema, _ = load_npz(str(ckpt))
    assert state == {}
    for a, b, e in zip(tree_leaves(raw), tree_leaves(ts["params"]),
                       tree_leaves(ema)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(raw["decoder"]["layers"]["kernel"],
                           ema["decoder"]["layers"]["kernel"])
    out = generate.main(["-restore", str(ckpt), "-audio",
                         str(corpus.parent / "input.wav"), "-speakers",
                         "p225", "None", "-mode", "greedy", "-params",
                         MAGENTA_JSON, "-data", str(corpus),
                         "-device", "cpu"])
    assert out["audio"].shape == (2, 1024)
    assert np.isfinite(out["audio"]).all()


def test_cli_time_shards_trains(corpus, tmp_path):
    """-time_shards 2 trains the family's full preset (the spawned ranks
    read the module's own constants) for a step on 256-sample shards."""
    from vqvae_wavenet_torch import train
    args = train_args(corpus, tmp_path, "-step", "1", "-time_shards", "2")
    args[args.index("-length") + 1] = "512"
    args[args.index("-batch") + 1] = "1"
    res = train.main(args)
    assert res["step"] == 1 and np.isfinite(res["losses"]).all()
    assert len(res["launches"]) == 2
    assert (tmp_path / "weights-1.npz").exists()


def test_export_train_state_round_trip(shallow, corpus, tmp_path):
    """A JAX Magenta train state -> orbax -> tools/export_torch_npz.py
    -train_state -> the port's checkpoint, leaf for leaf; the port then
    resumes it for one step."""
    from vqvae_wavenet_tpu.training.checkpoint import save_checkpoint
    from vqvae_wavenet_torch import train
    from vqvae_wavenet_torch.training.checkpoint import restore_checkpoint
    ts = jax_state(seed=5, num_speakers=109)
    rng = np.random.default_rng(6)
    adam = ts["opt_state"][0]
    ts["opt_state"] = (adam._replace(mu=jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), adam.mu)),
        ) + tuple(ts["opt_state"][1:])
    (tmp_path / "jax").mkdir()
    ckpt = save_checkpoint(str(tmp_path / "jax"), ts, wait=True)
    spec = importlib.util.spec_from_file_location(
        "export_torch_npz", os.path.join(REPO, "tools", "export_torch_npz.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    save = tmp_path / "port"
    save.mkdir()
    tool.main(["-restore", ckpt, "-params", MAGENTA_JSON, "-out",
               str(save / "weights-0.npz"), "-train_state"])
    got = restore_checkpoint(str(save / "weights-0"))
    for name, ref in (("params", ts["params"]),
                      ("ema_params", ts["ema_params"])):
        for a, b in zip(tree_leaves(got[name]),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a.numpy(), b)
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(got["opt_state"][name]),
                        jax.tree_util.tree_leaves(
                            getattr(ts["opt_state"][0], name))):
            np.testing.assert_array_equal(a.numpy(), b)
    assert got["model_state"] == {} and got["step"] == 0
    assert got["opt_state"]["count"] == 0
    res = train.main(train_args(corpus, save, "-step", "1", "-restore",
                                str(save / "weights-0")))
    assert res["step"] == 1 and np.isfinite(res["losses"]).all()
