"""Tensor parallelism (TP) of the port on the CPU: the data x model mesh
(parallel/__init__.py, parallel/mesh.py), ranks spawned with
torch.multiprocessing talking over gloo, the kernels' plain twins.

  * ``param_specs`` against JAX's ``param_shardings`` on every leaf of the
    main family's tree with Encoder_64 and with Encoder_2019 and of the
    Magenta family's, on a 4 x 2 mesh, and of a tree whose skip width the
    model axis does not divide (1 x 8).
  * The TP step at data 1 x model 2 and data 2 x model 2 against JAX's
    step on a 4 x 2 mesh (make_jit_train_step with mesh=), in f32, VQ
    'st' and 'ema': tests/test_parallel.py:83-116's config (skip_filters
    512, the learning rate of tests/test_torch_dp.py), JAX's init carried
    over, a global B=4 from numpy; test_torch_dp.py's tolerances (the
    gradients against JAX's value_and_grad on the global batch by
    ``check_grads``, the update by ``check_update``, the batch-norm and
    EMA codebook state by ``check_state``).
  * Encoder_2019, the Magenta family (test_torch_dp.py's shallow preset),
    one bf16 case and one with the two-kernel backward (BWD_FUSED_DK =
    "off") at data 2 x model 2 against the port's own single-device step
    on the global batch: the loss within 1e-5 relative (bf16: 1e-4), the
    gradients by ``check_grads`` at 1e-4 (bf16: within 2e-2 of the largest
    gradient of any leaf: the encoder's bf16 convs round a different split
    of the sums).
  * The summaries of a TP step: the gradients joined, their global norm
    (JAX's optax.global_norm), z_e of the global batch.
  * After three steps every leaf the rules keep whole (params, EMA
    shadows, Adam moments, model state) is bitwise equal on every rank,
    and every split leaf is the rank's slice of ``gather_state``;
    ``gather_state(shard_state(ts))`` is ts.
  * A mesh with time > 1 and model > 1 raises, and the rank layout is
    JAX's (d * n_model + m).
The ranks import this module, which therefore imports jax only inside
functions.
"""
import dataclasses
import functools
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_dp import (  # noqa: E402
    LR, MAGENTA_JSON, RANK_TIMEOUT, SHALLOW_MAGENTA, check_grads,
    encoder_2019_case, magenta_case, rel, tiny_cfg, to_np, to_t)
from vqvae_wavenet_torch.config import ModelConfig, WavenetConfig  # noqa
from vqvae_wavenet_torch.ops.conv import set_full_f32  # noqa: E402
from vqvae_wavenet_torch.parallel import Shards, layout, run_ranks  # noqa
from vqvae_wavenet_torch.parallel.comm import own_slice  # noqa: E402
from vqvae_wavenet_torch.parallel.mesh import (  # noqa: E402
    gather_state, gather_tree, param_specs, rank_rows, shard_state, tp_mesh)
from vqvae_wavenet_torch.training.optimizer import (  # noqa: E402
    tree_leaves, tree_unflatten)
from vqvae_wavenet_torch.training.train_loop import (  # noqa: E402
    dp_loss_and_grads, init_train_state, loss_and_grads, mesh_train_step)

B = 4
SPEAKERS = 4
TP_WAVENET = dict(quantization_channels=32, num_cycles=1, num_cycle_layers=2,
                  dilation_rates=[1, 2], kernel_size=2, dilation_filters=8,
                  skip_filters=512, residual_filters=8,
                  preprocess_kernel_size=2, preprocess_filters=8)


def tp_cfg(**kw):
    """tests/test_parallel.py:83-88's config in the port's terms."""
    return tiny_cfg(wavenet=WavenetConfig(**TP_WAVENET), **kw)


def batch_np(seed, T=128):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    y = np.zeros((B, 1, SPEAKERS), np.float32)
    y[np.arange(B), 0, np.arange(B) % SPEAKERS] = 1.0
    return {"x": x, "y": y}


def bf16_case():
    from vqvae_wavenet_torch.params import random_params_np
    cfg = tp_cfg(train_dtype="bf16")
    params, state = random_params_np(cfg, SPEAKERS, seed=8)
    return cfg, params, state, batch_np(seed=9)


def bwd_off_case():
    """The TP config in f32 with the two-kernel backward (the rank sets
    BWD_FUSED_DK = "off"; it computes the sweep's function)."""
    from vqvae_wavenet_torch.params import random_params_np
    cfg = tp_cfg()
    params, state = random_params_np(cfg, SPEAKERS, seed=10)
    return cfg, params, state, batch_np(seed=11)


PORT_CASES = {"2019": encoder_2019_case, "magenta": magenta_case,
              "bf16": bf16_case, "bwd_off": bwd_off_case}


def _digest(t):
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()) \
        .hexdigest()


def _rank_step(sh, cfg, ts, batch, steps=1):
    """One TP step of the global batch from the whole train state ``ts``
    (with the summaries): the rank's loss and metrics, the gradients and
    the new state joined into whole trees and the summaries' gradient
    norm and z_e (rank 0), and after ``steps`` steps the digests of the
    rank's whole leaves and of its split leaves against their slice of
    gather_state."""
    specs = param_specs(ts["params"], sh.n_model)
    mine = shard_state(ts, sh, specs)
    part = {k: rank_rows(torch.from_numpy(v), sh) for k, v in batch.items()}
    loss, _, grads = dp_loss_and_grads(mine["params"], mine["model_state"],
                                       cfg, part, sh, specs)
    grads = tree_leaves(gather_tree(tree_unflatten(mine["params"], grads),
                                    sh, specs))
    step = mesh_train_step(cfg, sh, specs)
    new, metrics = mesh_train_step(cfg, sh, specs, with_summaries=True)(
        mine, part)
    summ = metrics.pop("summaries")
    whole = gather_state(new, sh, specs)
    out = {"loss": float(loss),
           "metrics": {k: float(v) for k, v in metrics.items()
                       if isinstance(v, torch.Tensor)},
           "grads": [g.numpy() for g in grads] if sh.rank == 0 else None,
           "new": to_np(whole) if sh.rank == 0 else None,
           "grad_norm": float(summ["grad_norm"]),
           "summary_grads": [g.numpy() for g in tree_leaves(summ["grads"])]
           if sh.rank == 0 else None,
           "z_e": summ["z_e"].numpy() if sh.rank == 0 else None}
    for _ in range(steps - 1):
        new, _ = step(new, part)
    whole = gather_state(new, sh, specs)
    flat_specs = tree_leaves(specs)
    kept, sliced = [], []
    for tree in ("params", "ema_params", "opt_state", "model_state"):
        t_new, t_whole = new[tree], whole[tree]
        if tree == "opt_state":
            t_new = {k: t_new[k] for k in ("mu", "nu")}
            t_whole = {k: t_whole[k] for k in ("mu", "nu")}
        axes = (flat_specs * 2 if tree == "opt_state" else flat_specs
                if tree != "model_state" else [None] * len(tree_leaves(t_new)))
        for a, w, axis in zip(tree_leaves(t_new), tree_leaves(t_whole), axes):
            if axis is None:
                kept.append(_digest(a))
            else:
                sliced.append(torch.equal(a, own_slice(w, axis, sh)))
    out.update(kept=kept, sliced=sliced, n_split=sum(
        a is not None for a in flat_specs))
    return out


def tp_rank(sh, states, batches):
    """One rank: the main family's TP step per VQ mode from JAX's state
    (port layout, numpy; three steps of 'st') and, at data 2 x model 2,
    the port's cases; then the shard/gather round trip."""
    set_full_f32()
    out = {}
    for mode, ts in states.items():
        out[mode] = _rank_step(sh, tp_cfg(vq_mode=mode), to_t(ts),
                               batches[mode], steps=3 if mode == "st" else 1)
    if sh.n_data > 1:
        from vqvae_wavenet_torch.ops import train_kernels
        for name, case in PORT_CASES.items():
            cfg, params, state, batch = case()
            ts = init_train_state(to_t(params), to_t(state))
            train_kernels.BWD_FUSED_DK = "off" if name == "bwd_off" \
                else "auto"
            out[name] = _rank_step(sh, cfg, ts, batch)
        train_kernels.BWD_FUSED_DK = "auto"
    ts = to_t(states["st"])
    specs = param_specs(ts["params"], sh.n_model)
    back = gather_state(shard_state(ts, sh, specs), sh, specs)
    out["round_trip"] = all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                            else a == b for a, b in zip(
        tree_leaves({k: back[k] for k in ("params", "ema_params",
                                          "opt_state", "model_state")}),
        tree_leaves({k: ts[k] for k in ("params", "ema_params",
                                        "opt_state", "model_state")})))
    return out


# ----------------------------------------------------------- JAX references

def _jax_cfg(port):
    from vqvae_wavenet_tpu.config import ModelConfig as JModelConfig
    from vqvae_wavenet_tpu.config import WavenetConfig as JWavenetConfig
    return JModelConfig(
        encoder=port.encoder, use_vq=port.use_vq,
        speaker_embedding=port.speaker_embedding, k=port.k,
        latent_dim=port.latent_dim, beta=port.beta, vq_mode=port.vq_mode,
        learning_rate_schedule=dict(port.learning_rate_schedule),
        wavenet=JWavenetConfig(**{f: getattr(port.wavenet, f) for f in (
            "quantization_channels", "num_cycles", "num_cycle_layers",
            "dilation_rates", "kernel_size", "dilation_filters",
            "skip_filters", "residual_filters", "preprocess_kernel_size",
            "preprocess_filters")}))


@functools.lru_cache(maxsize=None)
def jax_case(vq_mode):
    """JAX's init of the TP config (4 speakers), its config, a batch."""
    import jax
    from vqvae_wavenet_tpu.training import train_loop as jloop
    jcfg = _jax_cfg(tp_cfg(vq_mode=vq_mode))
    jts = jax.device_get(jax.jit(lambda k: jloop.init_train_state(
        k, jcfg, num_speakers=SPEAKERS))(jax.random.PRNGKey(0)))
    return jcfg, jts, batch_np(seed=21 if vq_mode == "st" else 22)


@functools.lru_cache(maxsize=None)
def jax_reference(vq_mode):
    """JAX's loss, aux and gradients on the global batch (value_and_grad)
    and its new state and metrics after one step on a 4 x 2 mesh."""
    import jax
    import jax.numpy as jnp
    from vqvae_wavenet_tpu.models.vqvae import vqvae_forward as jforward
    from vqvae_wavenet_tpu.parallel.mesh import make_mesh
    from vqvae_wavenet_tpu.training import train_loop as jloop
    jcfg, jts, b = jax_case(vq_mode)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jforward(p, jts["model_state"], jcfg, jb["x"], jb["y"],
                           train=True), has_aux=True))(jts["params"])
    step = jloop.make_jit_train_step(jcfg, mesh=make_mesh(4, 2),
                                     donate=False)(jts)
    return jax.device_get((jl, jgrads, step(jts, jb, None)))


@pytest.fixture(scope="module")
def tp_runs():
    """{(n_data, n_model): the ranks' results}; the two meshes' ranks run
    at once."""
    from concurrent.futures import ThreadPoolExecutor
    from vqvae_wavenet_torch.params import from_jax_train_state
    states = {m: to_np(from_jax_train_state(jax_case(m)[1]))
              for m in ("st", "ema")}
    batches = {m: jax_case(m)[2] for m in ("st", "ema")}
    with ThreadPoolExecutor(2) as pool:
        runs = {(w // 2, 2): pool.submit(
            run_ranks, tp_rank, w, "cpu", states, batches, n_model=2,
            timeout=RANK_TIMEOUT) for w in (2, 4)}
        return {k: v.result() for k, v in runs.items()}


MESHES = [(1, 2), (2, 2)]


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("vq_mode", ["st", "ema"])
def test_tp_step_matches_jax_tp_step(tp_runs, mesh, vq_mode):
    """The loss, metrics and gradients against JAX's value_and_grad on the
    global batch; the update, the new batch-norm statistics and the EMA
    codebook state against JAX's step on a data 4 x model 2 mesh."""
    import jax
    from test_torch_train_step import check_state, check_update, t64
    from vqvae_wavenet_torch.params import from_jax_train_state
    _, jts, _ = jax_case(vq_mode)
    jl, jgrads, (jnew, jm) = jax_reference(vq_mode)
    r0 = tp_runs[mesh][0][vq_mode]
    assert rel(r0["loss"], jl) < 1e-4
    for k in ("loss", "reconstruction_loss", "vq_loss", "commitment_loss",
              "perplexity", "distances_mean"):
        assert rel(r0["metrics"][k], jm[k]) < 1e-4, k
    check_grads(r0["grads"], jax.tree_util.tree_leaves(jgrads), 1e-4)
    old, new = from_jax_train_state(jts), to_t(r0["new"])
    grads = [(t64(m1) - 0.9 * t64(m0)) / 0.1 for m0, m1 in zip(
        jax.tree_util.tree_leaves(jts["opt_state"][0].mu),
        jax.tree_util.tree_leaves(jnew["opt_state"][0].mu))]
    assert check_update("params", new, old, jnew, jts, grads, 1.0) > 0.5 * LR
    check_update("ema_params", new, old, jnew, jts, grads, 1e-3)
    check_state(new, old, jnew, jts)


@pytest.mark.parametrize("name", list(PORT_CASES))
def test_tp_step_matches_the_single_device_step(tp_runs, name, monkeypatch):
    """Encoder_2019, the Magenta family and bf16 at data 2 x model 2
    against the port's own step on the global batch."""
    from vqvae_wavenet_torch.models import magenta
    for attr, _ in SHALLOW_MAGENTA:        # magenta_case patches them
        monkeypatch.setattr(magenta, attr, getattr(magenta, attr))
    set_full_f32()
    cfg, params, state, b = PORT_CASES[name]()
    ts = init_train_state(to_t(params), to_t(state))
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, aux, grads = loss_and_grads(ts["params"], ts["model_state"], cfg,
                                      batch)
    grads = [np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
             for p, g in zip(tree_leaves(ts["params"]), grads)]
    r0 = tp_runs[(2, 2)][0][name]
    assert r0["n_split"] >= 2
    assert rel(r0["loss"], loss) < (1e-4 if name == "bf16" else 1e-5)
    if name == "bf16":
        top = max(np.abs(g).max() for g in grads)
        assert max(np.abs(a - g).max() for a, g in zip(r0["grads"],
                                                      grads)) < 2e-2 * top
    else:
        check_grads(r0["grads"], grads, 1e-4)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_tp_summaries_are_the_whole_batch(tp_runs, mesh):
    """The summaries of a TP step: the gradient tree joined over the model
    row (the step's gradients), its global norm counting each split leaf
    once (JAX's optax.global_norm of the single-device gradients), z_e of
    the global batch."""
    import optax
    _, jgrads, _ = jax_reference("st")
    r0 = tp_runs[mesh][0]["st"]
    for a, b in zip(r0["summary_grads"], r0["grads"]):
        np.testing.assert_array_equal(a, b)
    assert rel(r0["grad_norm"], float(optax.global_norm(jgrads))) < 1e-4
    assert len({r["st"]["grad_norm"] for r in tp_runs[mesh]}) == 1
    assert r0["z_e"].shape == (B, 2, 4)     # 128 samples a clip, 64 a frame


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_tp_ranks_keep_whole_leaves_bitwise_equal(tp_runs, mesh):
    """After three steps (one for the port's cases) every whole leaf has
    the same bits on every rank, every split leaf is the rank's slice of
    gather_state, and gather_state(shard_state(ts)) is ts."""
    runs = tp_runs[mesh]
    for name in runs[0]:
        if name == "round_trip":
            continue
        assert len({tuple(r[name]["kept"]) for r in runs}) == 1, name
        assert all(all(r[name]["sliced"]) and len(r[name]["sliced"])
                   == 4 * r[name]["n_split"] for r in runs), name
    assert all(r["round_trip"] for r in runs)


# ------------------------------------------------------------ the rules

def _jax_specs(jcfg, num_model, num_speakers=109):
    """JAX's split axis of every parameter leaf on a 4 x 2 (or 1 x 8) mesh,
    from the init's shapes alone."""
    import jax
    from vqvae_wavenet_tpu.parallel.mesh import make_mesh, param_shardings
    from vqvae_wavenet_tpu.training import train_loop as jloop
    shapes = jax.eval_shape(lambda k: jloop.init_train_state(
        k, jcfg, num_speakers)["params"], jax.random.PRNGKey(0))
    mesh = make_mesh(8 // num_model, num_model)
    out = []
    for s in jax.tree_util.tree_leaves(param_shardings(mesh, shapes)):
        axes = [i for i, n in enumerate(s.spec) if n == "model"]
        out.append(axes[0] if axes else None)
    return out, [tuple(x.shape) for x in jax.tree_util.tree_leaves(shapes)]


RULE_CASES = {
    "encoder_64": ({}, 2),
    "encoder_2019": ({"encoder": "2019"}, 2),
    "magenta": (None, 2),
    "skip_not_dividing": ({"skip": 20}, 8),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_param_specs_match_jax_rules(case):
    """param_specs on the port's tree = JAX's param_shardings on JAX's, leaf
    by leaf (a leaf the model axis does not divide kept whole)."""
    from vqvae_wavenet_torch.params import random_params_np
    from vqvae_wavenet_tpu.config import ModelConfig as JModelConfig
    extra, n_model = RULE_CASES[case]
    extra = None if extra is None else dict(extra)
    if extra is None:
        cfg = ModelConfig.from_json(MAGENTA_JSON)
        jcfg = JModelConfig.from_json(MAGENTA_JSON)
    else:
        cfg = ModelConfig.from_json(os.path.join(
            os.path.dirname(MAGENTA_JSON), "model_parameters.json"))
        wn = dataclasses.replace(cfg.wavenet, skip_filters=extra.pop(
            "skip", cfg.wavenet.skip_filters))
        cfg = dataclasses.replace(cfg, wavenet=wn, **extra)
        jcfg = _jax_cfg(cfg)
    params, _ = random_params_np(cfg, 109, seed=0)
    ref, shapes = _jax_specs(jcfg, n_model)
    got = tree_leaves(param_specs(params, n_model))
    assert [tuple(p.shape) for p in tree_leaves(params)] == shapes
    assert got == ref
    assert any(a is not None for a in got)
    if case == "skip_not_dividing":     # 768 splits over 8, 20 does not
        assert sum(a is not None for a in got) == 6


def test_tp_mesh_and_rank_layout_follow_jax():
    """make_mesh's default and assert; rank d * n_model + m holds data row
    d and model column m; no mesh has both a time and a model axis."""
    assert tp_mesh(8, num_model=2) == (4, 2)
    assert tp_mesh(8, 4, 2) == (4, 2)
    with pytest.raises(ValueError):
        tp_mesh(8, 3, 2)
    sh = [Shards(r, 8, torch.device("cpu"), "gloo", n_model=2)
          for r in range(8)]
    assert [(s.data_rank, s.model_rank) for s in sh] == [
        (d, m) for d in range(4) for m in range(2)]
    assert sh[0].n_data == 4 and sh[0].data_world == 4
    x = torch.arange(8)
    assert torch.equal(rank_rows(x, sh[5]), x[4:6])
    with pytest.raises(ValueError, match="do not compose"):
        layout(sh[0], n_time=2, n_model=2)
