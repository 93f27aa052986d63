"""Data parallelism (DP) of the port on the CPU: two ranks spawned with
torch.multiprocessing talk over gloo, each with its contiguous half of a
global batch (parallel/mesh.py), the kernels' plain twins.

  * The main family's step (Encoder_64, VQ 'st' and 'ema'; the tiny config
    of tests/test_torch_train_step.py at a global B=4, JAX's init carried
    over by ``params.from_jax_train_state``) against JAX's train_step on
    the global batch, on one device and on a 2-device mesh
    (make_jit_train_step with mesh=), with test_torch_train_step.py's
    tolerances: the loss, metrics and gradients within 1e-4 relative, the
    update by ``check_update`` and the batch-norm running statistics and
    the EMA codebook state by ``check_state``.  The ranks end bitwise
    equal.
  * One step of the Magenta family (4 decoder layers, narrow widths, as
    tests/test_torch_magenta_train.py patches them) and one of
    Encoder_2019 (T = 640: two 320-sample frames a clip) under two ranks,
    against the port's own single-device step on the global batch: the
    loss and metrics within 1e-5 relative, every gradient leaf within 1e-4
    of its largest |value| (float32 sums split in two halves).
  * The prior's step under two ranks against JAX's prior loss and
    gradients on the global batch (1e-5 of each leaf's largest, as
    tests/test_torch_prior.py) and optax.adam's update, and the code
    perplexity and usage of the whole batch.
  * The CLI: two processes joined by -coordinator 127.0.0.1:PORT
    -num_processes 2 -process_id {0,1} train two steps; both report the
    same losses and host 0 alone writes; ``-profile DIR`` writes a Chrome
    trace of steps 10-14 with the step, gradient and optimizer ranges.
  * Four ranks seen as two hosts of two: each host's first rank alone
    reads its host's batch, and every rank gets the global batch, the
    hosts' batches in host order (``global_batch``); a restored train
    state is rank 0's everywhere (``replicate_``).
  * No rank and no CLI process imports jax or the JAX package.
The ranks import this module, which therefore imports jax only inside
functions.
"""
import functools
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
from vqvae_wavenet_torch.parallel import Shards, run_ranks  # noqa: E402
from vqvae_wavenet_torch.parallel.mesh import (  # noqa: E402
    data_ranks, rank_rows)
from vqvae_wavenet_torch.training.optimizer import tree_leaves  # noqa
from vqvae_wavenet_torch.training.train_loop import (  # noqa: E402
    dp_loss_and_grads, init_train_state, loss_and_grads, train_step)

MAGENTA_JSON = os.path.join(REPO, "magenta_parameters.json")
RANK_TIMEOUT = 240
B = 4                           # the global batch: 2 clips a rank
LR = 8e-5                       # tests/test_torch_train_step.py's schedule
SHALLOW_MAGENTA = (("NUM_LAYERS", 4), ("NUM_STAGES", 2), ("WIDTH", 16),
                   ("SKIP_WIDTH", 24), ("AE_WIDTH", 32))
PRIOR = dict(k=16, embed=8, filters=16, gc=4, T=24, lr=1e-3)


def tiny_cfg(**kw):
    """tests/test_torch_train_step.py::tiny_cfg in the port's config."""
    wn = WavenetConfig(
        quantization_channels=32, num_cycles=1, num_cycle_layers=3,
        dilation_rates=[1, 2, 4], kernel_size=2, dilation_filters=8,
        skip_filters=8, residual_filters=8, preprocess_kernel_size=2,
        preprocess_filters=8)
    base = dict(encoder="64", use_vq=True, speaker_embedding=4, k=8,
                latent_dim=4, beta=0.25, wavenet=wn,
                learning_rate_schedule={0: LR, 100: 6e-5, 200: 4e-5})
    base.update(kw)
    return ModelConfig(**base)


def batch_np(seed=1, T=128, S=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    y = np.zeros((B, 1, S), np.float32)
    y[np.arange(B), 0, rng.integers(0, S, B)] = 1.0
    return {"x": x, "y": y}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def to_np(tree):
    return _map(tree, lambda v: v.detach().numpy()
                if isinstance(v, torch.Tensor) else v)


def to_t(tree):
    return _map(tree, lambda v: torch.from_numpy(np.array(v))
                if isinstance(v, np.ndarray) else v)


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _imported_jax():
    return sorted(m for m in sys.modules if m == "jax"
                  or m.startswith(("jax.", "vqvae_wavenet_tpu")))


def magenta_case():
    """The shallow, narrow Magenta family (the constants patched in this
    process) and its random init."""
    from vqvae_wavenet_torch.models import magenta
    from vqvae_wavenet_torch.params import random_params_np
    for name, v in SHALLOW_MAGENTA:
        setattr(magenta, name, v)
    cfg = ModelConfig.from_json(MAGENTA_JSON)
    params, state = random_params_np(cfg, 3, seed=4)
    return cfg, params, state, batch_np(seed=5, T=512)


def encoder_2019_case():
    from vqvae_wavenet_torch.params import random_params_np
    cfg = tiny_cfg(encoder="2019")
    params, state = random_params_np(cfg, 3, seed=6)
    return cfg, params, state, batch_np(seed=7, T=640)


def _rank_step(sh, cfg, ts, batch):
    """This rank's DP gradients of the global batch and one DP step."""
    part = {k: rank_rows(torch.from_numpy(v), sh) for k, v in batch.items()}
    loss, aux, grads = dp_loss_and_grads(ts["params"], ts["model_state"],
                                         cfg, part, sh)
    new, metrics = train_step(ts, part, cfg, sh=sh,
                              grads_fn=functools.partial(dp_loss_and_grads,
                                                         sh=sh))
    keys = ("loss", "reconstruction_loss", "vq_loss", "commitment_loss",
            "perplexity", "distances_mean", "reg_loss")
    return {"loss": float(loss),
            "metrics": {k: float(metrics[k]) for k in keys if k in metrics},
            "grads": [g.numpy() for g in grads] if sh.rank == 0 else None,
            "new": to_np(new) if sh.rank == 0 else None,
            "digest": _digest(tree_leaves({k: new[k] for k in
                                           ("params", "ema_params",
                                            "model_state")}))}


def dp_rank(sh, states, batches, prior):
    """One rank: the main family's DP step per VQ mode from the given
    (port-layout, numpy) train states, the Magenta family's and
    Encoder_2019's from their seeds, and the prior's."""
    set_full_f32()
    out = {}
    for mode, ts in states.items():
        out[mode] = _rank_step(sh, tiny_cfg(vq_mode=mode), to_t(ts),
                               batches[mode])
    for name, case in (("magenta", magenta_case),
                       ("2019", encoder_2019_case)):
        cfg, params, state, batch = case()
        ts = init_train_state(to_t(params), to_t(state))
        out[name] = _rank_step(sh, cfg, ts, batch)
    out["prior"] = _prior_rank_step(sh, *prior)
    out["imported"] = _imported_jax()
    return out


def _prior_rank_step(sh, params, codes, h):
    from vqvae_wavenet_torch.prior import code_stats, prior_loss_and_grads
    from vqvae_wavenet_torch.training.optimizer import fused_adam_ema_step
    ts = init_train_state(to_t(params), {})
    b = codes.shape[0] // sh.world
    rows = slice(sh.rank * b, (sh.rank + 1) * b)
    c_l = torch.from_numpy(codes[rows]).long()
    loss, grads = prior_loss_and_grads(ts["params"], c_l,
                                       torch.from_numpy(h[rows]), sh=sh)
    new, _, _ = fused_adam_ema_step(ts["params"], ts["ema_params"],
                                    ts["opt_state"], grads,
                                    lambda count: PRIOR["lr"], ema_decay=0.0)
    ppl, usage = code_stats(c_l, PRIOR["k"], sh)
    return {"loss": float(loss), "perplexity": float(ppl),
            "usage": float(usage),
            "grads": [g.numpy() for g in grads] if sh.rank == 0 else None,
            "new": to_np(new) if sh.rank == 0 else None,
            "digest": _digest(tree_leaves(new))}


# ----------------------------------------------------------- JAX references

@functools.lru_cache(maxsize=None)
def jax_case(vq_mode):
    """JAX's init of tests/test_torch_train_step.py's tiny config (3
    speakers), its config, and a global batch."""
    import jax
    from vqvae_wavenet_tpu.config import ModelConfig as JModelConfig
    from vqvae_wavenet_tpu.config import WavenetConfig as JWavenetConfig
    from vqvae_wavenet_tpu.training import train_loop as jloop
    port = tiny_cfg(vq_mode=vq_mode)
    jcfg = JModelConfig(
        encoder="64", use_vq=True, speaker_embedding=4, k=8, latent_dim=4,
        beta=0.25, vq_mode=vq_mode, learning_rate_schedule={0: LR, 100: 6e-5,
                                                            200: 4e-5},
        wavenet=JWavenetConfig(**{f: getattr(port.wavenet, f) for f in (
            "quantization_channels", "num_cycles", "num_cycle_layers",
            "dilation_rates", "kernel_size", "dilation_filters",
            "skip_filters", "residual_filters", "preprocess_kernel_size",
            "preprocess_filters")}))
    jts = jax.device_get(jax.jit(lambda k: jloop.init_train_state(
        k, jcfg, num_speakers=3))(jax.random.PRNGKey(0)))
    return jcfg, jts, batch_np(seed=11 if vq_mode == "st" else 12)


def jax_prior_case():
    import jax
    from vqvae_wavenet_tpu.models import prior as jprior
    p = jprior.init_prior_params(jax.random.PRNGKey(3), PRIOR["k"],
                                 embed_dim=PRIOR["embed"],
                                 filters=PRIOR["filters"],
                                 gc_channels=PRIOR["gc"])
    p = jax.tree_util.tree_map(np.asarray, jax.device_get(p))
    rng = np.random.default_rng(3)
    for layer in p["layers"]:          # non-zero biases
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape).astype(
            np.float32)
    codes = rng.integers(0, PRIOR["k"], (B, PRIOR["T"])).astype(np.int32)
    h = rng.standard_normal((B, 1, PRIOR["gc"])).astype(np.float32)
    return p, codes, h


@pytest.fixture(scope="module")
def two_ranks():
    from vqvae_wavenet_torch.params import from_jax_train_state
    states = {m: to_np(from_jax_train_state(jax_case(m)[1]))
              for m in ("st", "ema")}
    batches = {m: jax_case(m)[2] for m in ("st", "ema")}
    prior = jax_prior_case()
    res = run_ranks(dp_rank, 2, "cpu", states, batches, prior,
                    timeout=RANK_TIMEOUT)
    return res


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def check_grads(got, ref, tol):
    """Every leaf within ``tol`` of its largest |reference|; a leaf below
    1e-6 of the largest gradient of any leaf (rounding noise on both
    sides, tests/test_torch_train_step.py) within that floor."""
    assert len(got) == len(ref)
    floor = 1e-6 * max(np.abs(r).max() for r in ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        if np.abs(r).max() < floor:
            assert np.abs(g).max() < floor, i
        else:
            assert rel(g, r) < tol, (i, r.shape, rel(g, r))


@pytest.mark.parametrize("vq_mode", ["st", "ema"])
def test_dp_step_matches_jax_single_device(two_ranks, vq_mode):
    """Loss, metrics and gradients against JAX's value_and_grad on the
    global batch, and the update, the BN running statistics and the EMA
    codebook state against JAX's train_step on one device."""
    import jax
    import jax.numpy as jnp
    from test_torch_train_step import check_state, check_update, t64
    from vqvae_wavenet_tpu.models.vqvae import vqvae_forward as jforward
    from vqvae_wavenet_tpu.training import train_loop as jloop
    from vqvae_wavenet_torch.params import from_jax_train_state
    jcfg, jts, b = jax_case(vq_mode)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jforward(p, jts["model_state"], jcfg, jb["x"], jb["y"],
                           train=True), has_aux=True))(jts["params"])
    jaux, jgrads = jax.device_get((jaux, jgrads))
    r0 = two_ranks[0][vq_mode]
    assert rel(r0["loss"], jl) < 1e-4
    for k in ("reconstruction_loss", "vq_loss", "commitment_loss",
              "perplexity", "distances_mean"):
        assert rel(r0["metrics"][k], jaux[k]) < 1e-4, k
    check_grads(r0["grads"], jax.tree_util.tree_leaves(jgrads), 1e-4)

    jnew, _ = jax.jit(functools.partial(jloop.train_step, cfg=jcfg))(
        jts, jb, None)
    jnew = jax.device_get(jnew)
    old, new = from_jax_train_state(jts), to_t(r0["new"])
    grads = [(t64(m1) - 0.9 * t64(m0)) / 0.1 for m0, m1 in zip(
        jax.tree_util.tree_leaves(jts["opt_state"][0].mu),
        jax.tree_util.tree_leaves(jnew["opt_state"][0].mu))]
    assert check_update("params", new, old, jnew, jts, grads, 1.0) > 0.5 * LR
    check_update("ema_params", new, old, jnew, jts, grads, 1e-3)
    check_state(new, old, jnew, jts)


@pytest.mark.parametrize("vq_mode", ["st", "ema"])
def test_dp_step_matches_jax_on_a_two_device_mesh(two_ranks, vq_mode):
    """The same step against JAX's data-parallel step: make_jit_train_step
    with a 2 x 1 mesh, the batch sharded over 'data'."""
    import jax
    import jax.numpy as jnp
    from test_torch_train_step import check_state, check_update, t64
    from vqvae_wavenet_tpu.parallel.mesh import make_mesh
    from vqvae_wavenet_tpu.training import train_loop as jloop
    from vqvae_wavenet_torch.params import from_jax_train_state
    jcfg, jts, b = jax_case(vq_mode)
    mesh = make_mesh(num_data=2, num_model=1, devices=jax.devices()[:2])
    step = jloop.make_jit_train_step(jcfg, mesh=mesh, donate=False)(jts)
    jnew, jm = step(jts, {k: jnp.asarray(v) for k, v in b.items()}, None)
    jnew, jm = jax.device_get((jnew, jm))
    r0 = two_ranks[0][vq_mode]
    for k in ("loss", "reconstruction_loss", "perplexity"):
        assert rel(r0["metrics"][k], jm[k]) < 1e-4, k
    old, new = from_jax_train_state(jts), to_t(r0["new"])
    grads = [(t64(m1) - 0.9 * t64(m0)) / 0.1 for m0, m1 in zip(
        jax.tree_util.tree_leaves(jts["opt_state"][0].mu),
        jax.tree_util.tree_leaves(jnew["opt_state"][0].mu))]
    assert check_update("params", new, old, jnew, jts, grads, 1.0) > 0.5 * LR
    check_update("ema_params", new, old, jnew, jts, grads, 1e-3)
    check_state(new, old, jnew, jts)
    if vq_mode == "ema":
        # the codebook moved by its EMA over both ranks' codes
        assert not np.allclose(r0["new"]["params"]["vq"]["embedding"],
                               jts["params"]["vq"]["embedding"])


@pytest.mark.parametrize("name,case", [("magenta", magenta_case),
                                       ("2019", encoder_2019_case)])
def test_dp_step_matches_the_single_device_step(two_ranks, name, case,
                                                monkeypatch):
    """Magenta family and Encoder_2019: two ranks against the port's own
    step on the global batch."""
    from vqvae_wavenet_torch.models import magenta
    for attr, _ in SHALLOW_MAGENTA:        # magenta_case patches them
        monkeypatch.setattr(magenta, attr, getattr(magenta, attr))
    set_full_f32()
    cfg, params, state, b = case()
    ts = init_train_state(to_t(params), to_t(state))
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, aux, grads = loss_and_grads(ts["params"], ts["model_state"], cfg,
                                      batch)
    r0 = two_ranks[0][name]
    assert rel(r0["loss"], loss) < 1e-5
    for k, v in r0["metrics"].items():
        if k != "loss":
            assert rel(v, aux[k]) < 1e-5, k
    check_grads(r0["grads"], [g.numpy() for g in grads], 1e-4)
    assert len({r[name]["digest"] for r in two_ranks}) == 1


def test_dp_prior_step_matches_jax(two_ranks):
    import jax
    import jax.numpy as jnp
    import optax
    from vqvae_wavenet_tpu.models import prior as jprior
    p, codes, h = jax_prior_case()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jl, jg = jax.value_and_grad(jprior.prior_loss)(jp, jnp.asarray(codes),
                                                  jnp.asarray(h))
    opt = optax.adam(PRIOR["lr"])
    upd, _ = opt.update(jg, opt.init(jp))
    jnew = jax.device_get(optax.apply_updates(jp, upd))
    jg = jax.tree_util.tree_leaves(jax.device_get(jg))
    r0 = two_ranks[0]["prior"]
    assert rel(r0["loss"], jl) < 1e-5
    check_grads(r0["grads"], jg, 1e-5)
    # optax's first step moves every element by lr * g / (|g| + eps):
    # within 1e-3 of it where the gradient is well above rounding, else
    # within 2.5 lr (a gradient within rounding of zero can flip sign)
    for got, ref, old, g in zip(tree_leaves(to_t(r0["new"])),
                                jax.tree_util.tree_leaves(jnew),
                                jax.tree_util.tree_leaves(p), jg):
        dp = got.double().numpy() - old
        dj = np.asarray(ref, np.float64) - old
        sharp = np.abs(g) > 1e-2 * np.abs(g).max()
        tol = np.where(sharp, 1e-3 * np.abs(dj), 2.5 * PRIOR["lr"]) \
            + 2 * np.finfo(np.float32).eps * np.abs(old)
        assert (np.abs(dp - dj) <= tol).all()
    counts = np.bincount(codes.reshape(-1), minlength=PRIOR["k"])
    q = counts / counts.sum()
    ppl = np.exp(-np.sum(q * np.log(q + 1e-10)))
    for r in two_ranks:
        assert r["prior"]["perplexity"] == pytest.approx(ppl, rel=1e-6)
        assert r["prior"]["usage"] == pytest.approx((q > 0).mean())
    assert len({r["prior"]["digest"] for r in two_ranks}) == 1


def test_dp_ranks_agree_and_import_no_jax(two_ranks):
    for name in ("st", "ema", "magenta", "2019"):
        assert len({r[name]["digest"] for r in two_ranks}) == 1, name
        assert len({json.dumps(r[name]["metrics"], sort_keys=True)
                    for r in two_ranks}) == 1, name
    assert all(r["imported"] == [] for r in two_ranks), [
        r["imported"] for r in two_ranks]


def layout_rank(sh):
    """Four ranks seen as two hosts of two (global_batch's broadcast from
    each host's first rank), and replicate_ from rank 0."""
    import dataclasses
    from vqvae_wavenet_torch.parallel.mesh import global_batch, replicate_
    two_hosts = dataclasses.replace(sh, hosts=2)
    reads = []

    def read():
        reads.append(sh.rank)
        return {"x": np.full((2, 3), two_hosts.host + 1.0, np.float32)}
    x = global_batch(read, {"x": (2, 3)}, sh.device, two_hosts)["x"]
    ts = init_train_state({"w": torch.full((3,), sh.rank + 1.0)}, {})
    ts = dict(ts, step=7 if sh.rank == 0 else 3)
    ts["opt_state"]["count"] = 5 if sh.rank == 0 else 1
    rep = replicate_(ts, sh)
    return {"x": x.numpy(), "reads": reads, "w": rep["params"]["w"].numpy(),
            "mu": rep["opt_state"]["mu"]["w"].numpy(), "step": rep["step"],
            "count": rep["opt_state"]["count"]}


def test_host_batch_and_replicate_over_ranks():
    """Each host's first rank alone reads, and every rank gets the hosts'
    batches in host order; a restored state is rank 0's on every rank."""
    res = run_ranks(layout_rank, 4, "cpu", timeout=RANK_TIMEOUT)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["x"], np.repeat([1.0, 2.0], 6)
                                      .reshape(4, 3))
        assert out["reads"] == ([r] if r % 2 == 0 else [])
        np.testing.assert_array_equal(out["w"], np.ones(3))
        np.testing.assert_array_equal(out["mu"], np.zeros(3))
        assert (out["step"], out["count"]) == (7, 5)


def test_rank_layout_follows_jax():
    """gcd(batch, devices) ranks a host (train.py:117-122); rank r takes
    rows r * B/N .. of the global batch (the hosts' batches in host
    order), so rank l of host h takes rows l * B/L .. of its host's
    batch."""
    assert data_ranks(8, "cpu") == 1
    x = torch.arange(8)
    sh = [Shards(r, 4, torch.device("cpu"), "gloo", hosts=2)
          for r in range(4)]
    assert [(s.host, s.local_rank) for s in sh] == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]
    host_batches = {0: x[:4], 1: x[4:]}
    for s in sh:
        b = 4 // s.local_world
        assert torch.equal(rank_rows(x, s), host_batches[s.host][
            s.local_rank * b:(s.local_rank + 1) * b])
    assert torch.equal(torch.cat([rank_rows(x, s) for s in sh]), x)


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two speakers x two 1 s utterances in the VCTK layout, the 109-entry
    speaker table, a tiny model config, and stub packages named jax and
    vqvae_wavenet_tpu whose import fails."""
    from scipy.io import wavfile
    root = tmp_path_factory.mktemp("dp_cli")
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


def cli_args(corpus, save, *extra):
    return ["-dataset", "VCTK", "-length", "512", "-batch", "1",
            "-save", str(save / "weights"), "-params",
            str(corpus / "model.json"), "-data", str(corpus / "data"),
            "-interval", "1", "-device", "cpu", *extra]


HOST_SCRIPT = r"""
import json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {stubs!r})
sys.modules["jax"] = None
from vqvae_wavenet_torch import train
res = train.main({args!r})
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith("vqvae_wavenet_tpu"))]
print("HOST_RESULT " + json.dumps({{"losses": res["losses"],
                                    "step": res["step"], "path": res["path"],
                                    "imported": bad}}))
"""


def test_multihost_cli_two_processes_agree(corpus, tmp_path):
    """Two hosts (one CPU rank each) at -batch 1: a global batch of 2 clips,
    host h's from its own seed; the same losses on both, checkpoints and
    metrics from host 0 alone, no jax in either process."""
    from vqvae_wavenet_torch.parallel import free_port
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = []
    for h in (0, 1):
        args = cli_args(corpus, tmp_path / f"host{h}", "-step", "2",
                        "-coordinator", f"127.0.0.1:{port}",
                        "-num_processes", "2", "-process_id", str(h))
        script = HOST_SCRIPT.format(repo=REPO, stubs=str(corpus / "stubs"),
                                    args=args)
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
        line = [s for s in out.splitlines() if s.startswith("HOST_RESULT")]
        outs.append((json.loads(line[-1].split(" ", 1)[1]), out))
    (r0, out0), (r1, _) = outs
    assert r0["step"] == r1["step"] == 2
    assert len(r0["losses"]) == 2 and np.isfinite(r0["losses"]).all()
    assert r0["losses"] == r1["losses"]
    assert r0["imported"] == r1["imported"] == []
    assert "[dp] 2 data ranks (2 host(s)) of 1 clips, backend gloo" in out0
    assert (tmp_path / "host0" / "weights-2.npz").exists()
    assert len((tmp_path / "host0" / "metrics.jsonl").read_text()
               .splitlines()) == 2
    assert r1["path"] is None and not (tmp_path / "host1").exists()


def test_profile_writes_a_chrome_trace(corpus, tmp_path):
    from vqvae_wavenet_torch import train
    res = train.main(cli_args(corpus, tmp_path / "run", "-step", "16",
                              "-profile", str(tmp_path / "trace"),
                              "-ckpt_interval", "100"))
    assert res["trace"] == str(tmp_path / "trace" / "trace.json")
    with open(res["trace"]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert names.count("train_step") == 5           # steps 10-14
    assert names.count("optimizer") == 5
    assert names.count("loss_and_grads") == 5
    assert res["step"] == 16 and np.isfinite(res["losses"]).all()
