"""Sequence parallelism (SP) on the data x time mesh, with group norm, the
EMA codebook and the decoder's 'layer' and 'recompute' halos, on the CPU:
ranks spawned with torch.multiprocessing talk over gloo, the stack's plain
twins.  Every case is held against JAX's SINGLE-DEVICE
``jax.value_and_grad`` of ``vqvae_forward`` on the same numpy weights and
batch (JAX's own SP tests hold its SP to the same function,
tests/test_timeshard.py:83-435), at the widths of
tests/test_torch_sp_train.py (R = S = 128, 2D = 128, dilations
[1, 2, 1, 2], K = 3, biases bumped):

  * data 2 x time 2 at a global B = 2, T = 256 (one clip and 128 samples
    a rank): f32 and bf16 with batch norm, f32 with group norm (whose
    statistics span the time row only), and one train_step with
    vq_mode 'ema';
  * 'layer' and 'recompute' on a time row of 2 (the same case), and of 4
    with dilations [1, 64, 1, 64] at T = 256 (64 samples a shard: the
    layer halos span two shards, the recompute halo of 320 rows five);
  * the plans: 'layer' past 64 layers is 'recompute', the cycle plan is
    JAX's wherever JAX has one; the rank layout follows JAX's mesh.

Tolerances are JAX's SP ones: the loss within rtol 2e-4, every f32
gradient leaf within 5e-3 of max(its largest |value|, 1e-4 of the largest
of any leaf); bf16 by tests/test_torch_sp_train.py::check_bf16_grads
against JAX's single-device bf16 gradient (or no further from JAX's f32
gradient than it is, within 10%).  The new batch-norm statistics and the
EMA codebook state: the change of each leaf within 1e-4 of its largest
change (+ 2 ulp of the value + 1e-8), the new codebook within 1e-4 of its
largest value.  The ranks import this module, which therefore imports jax
only inside functions; no rank may import jax.
"""
import functools
import math
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from test_torch_sp_train import (  # noqa: E402
    MODEL, MULTIHOP, RANK_TIMEOUT, WN, check_bf16_grads, check_f32_grads)
from vqvae_wavenet_torch.config import ModelConfig, WavenetConfig  # noqa
from vqvae_wavenet_torch.ops.conv import set_full_f32  # noqa: E402
from vqvae_wavenet_torch.parallel import Shards, run_ranks  # noqa: E402
from vqvae_wavenet_torch.parallel import comm, mesh  # noqa: E402
from vqvae_wavenet_torch.parallel.timeshard import (  # noqa: E402
    fused_sp_groups, halo_sizes, sp_groups, sp_loss_and_grads)
from vqvae_wavenet_torch.training.optimizer import tree_leaves  # noqa
from vqvae_wavenet_torch.training.train_loop import (  # noqa: E402
    init_train_state, train_step)

DILS = WN["dilation_rates"]


def port_cfg(dils, **kw):
    wn = WavenetConfig(**dict(WN, dilation_rates=list(dils)))
    return ModelConfig(**dict(MODEL, wavenet=wn, **kw))


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def to_t(tree):
    return _tree(tree, lambda v: torch.from_numpy(np.array(v)))


def to_np(tree):
    return _tree(tree, lambda v: v.detach().numpy()
                 if isinstance(v, torch.Tensor) else v)


def _imported_jax():
    return sorted(m for m in sys.modules if m == "jax"
                  or m.startswith(("jax.", "vqvae_wavenet_tpu")))


def sp_case_rank(sh, cases):
    """One rank: for each case (kwargs of port_cfg, dilations, numpy
    params, state, x, y, decoder halo) one SP train_step on this rank's
    rows and time slice; its loss, metrics and new train state, and (rank
    0) the gradients of the global loss."""
    set_full_f32()
    out = {}
    for name, (kw, dils, params, state, x, y, halo) in cases.items():
        cfg = port_cfg(dils, **kw)
        t_l = x.shape[1] // sh.n_time
        cols = slice(sh.time_rank * t_l, (sh.time_rank + 1) * t_l)
        batch = {"x": mesh.rank_rows(torch.from_numpy(x), sh)[:, cols]
                 .contiguous(),
                 "y": mesh.rank_rows(torch.from_numpy(y), sh)}
        got = {}

        def grads_fn(*a):
            got["r"] = sp_loss_and_grads(*a, sh, decoder_halo=halo)
            return got["r"]
        ts, metrics = train_step(init_train_state(*to_t((params, state))),
                                 batch, cfg, grads_fn=grads_fn, sh=sh)
        loss, aux, grads = got["r"]
        out[name] = {
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()
                        if isinstance(v, torch.Tensor)},
            "grads": [g.numpy() for g in grads] if sh.rank == 0 else None,
            "new": to_np({k: ts[k] for k in ("params", "model_state")}),
            "coords": (sh.data_rank, sh.time_rank)}
    out["imported"] = _imported_jax()
    return out


# ----------------------------------------------------------- JAX references

@functools.lru_cache(maxsize=None)
def jax_case(dils, B, T, seed, **kw):
    """numpy (params, state, x, y) from JAX's init with every bias bumped
    by 0.1 (tests/test_timeshard.py::bump_biases)."""
    import jax
    import jax.numpy as jnp
    from vqvae_wavenet_tpu.models.vqvae import init_vqvae
    params, state = init_vqvae(jax.random.PRNGKey(seed),
                               jax_cfg(dils, **kw), num_speakers=4)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 if "bias" in str(p[-1]) else v, params)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (B, T, 1)).astype(np.float32)
    y = np.asarray(jax.nn.one_hot(jnp.arange(B) % 4, 4)[:, None, :])
    return (jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
            jax.tree_util.tree_map(np.asarray, jax.device_get(state)), x, y)


def jax_cfg(dils, **kw):
    from vqvae_wavenet_tpu.config import ModelConfig as JModelConfig
    from vqvae_wavenet_tpu.config import WavenetConfig as JWavenetConfig
    return JModelConfig(**dict(MODEL, wavenet=JWavenetConfig(
        **dict(WN, dilation_rates=list(dils))), **kw))


@functools.lru_cache(maxsize=None)
def jax_reference(dils, B, T, seed, **kw):
    """JAX's single-device (loss, grads, new model state) of the case."""
    import jax
    import jax.numpy as jnp
    from vqvae_wavenet_tpu.models.vqvae import vqvae_forward
    params, state, x, y = jax_case(dils, B, T, seed,
                                   **{k: v for k, v in kw.items()
                                      if k != "train_dtype"})
    cfg = jax_cfg(dils, **kw)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: vqvae_forward(p, state, cfg, jnp.asarray(x),
                                jnp.asarray(y), train=True),
        has_aux=True))(params)
    grads = [np.asarray(g, np.float64)
             for g in jax.tree_util.tree_leaves(jax.device_get(grads))]
    return float(loss), grads, jax.device_get(aux["state"])


def jax_ema_step(dils, B, T, seed):
    """JAX's single-device train_step (vq_mode 'ema') from the case's
    weights and state: the new params and model state."""
    import jax
    import jax.numpy as jnp
    from vqvae_wavenet_tpu.training import train_loop as jloop
    params, state, x, y = jax_case(dils, B, T, seed, vq_mode="ema")
    cfg = jax_cfg(dils, vq_mode="ema")
    ts = jax.jit(lambda k: jloop.init_train_state(k, cfg, 4))(
        jax.random.PRNGKey(seed))
    ts = dict(ts, params=params, model_state=state,
              ema_params=jax.tree_util.tree_map(np.copy, params))
    new, _ = jax.jit(functools.partial(jloop.train_step, cfg=cfg))(
        ts, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, None)
    return jax.device_get(new)


def check_change(new, old, ref, ref_old, what):
    """Each leaf's one-step change within 1e-4 of the reference leaf's
    largest change + 2 ulp of its value + 1e-8 (module docstring)."""
    import jax
    got, got0 = tree_leaves(to_t(new)), tree_leaves(to_t(old))
    want = jax.tree_util.tree_leaves(ref)
    want0 = jax.tree_util.tree_leaves(ref_old)
    assert len(got) == len(want) > 0, what
    for a, a0, r, r0 in zip(got, got0, want, want0):
        dp = a.double().numpy() - a0.double().numpy()
        dj = np.asarray(r, np.float64) - np.asarray(r0, np.float64)
        tol = (1e-4 * np.abs(dj).max()
               + 2 * np.finfo(np.float32).eps * np.abs(r) + 1e-8)
        assert np.abs(dj).max() > 0, what
        assert (np.abs(dp - dj) <= tol).all(), (
            what, a.shape, float(np.abs(dp - dj).max()))


# ------------------------------------------------------- data x time mesh

MESH_CASES = {"st_f32": ({}, "fused"), "st_bf16": ({"train_dtype": "bf16"},
                                                   "fused"),
              "group": ({"encoder_norm": "group"}, "fused"),
              "ema": ({"vq_mode": "ema"}, "fused")}


@pytest.fixture(scope="module")
def mesh_run():
    """4 ranks as data 2 x time 2 at B = 2, T = 256."""
    cases = {}
    for name, (kw, halo) in MESH_CASES.items():
        case = jax_case(tuple(DILS), 2, 256, 0,
                        **{k: v for k, v in kw.items() if k != "train_dtype"})
        cases[name] = (kw, DILS) + case + (halo,)
    return cases, run_ranks(sp_case_rank, 4, "cpu", cases,
                            timeout=RANK_TIMEOUT, n_time=2)


def test_mesh_ranks_agree_and_import_no_jax(mesh_run):
    cases, res = mesh_run
    assert [r["st_f32"]["coords"] for r in res] == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]
    for name in cases:
        assert len({r[name]["loss"] for r in res}) == 1, name
        first = tree_leaves(res[0][name]["new"])
        for r in res[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(
                first, tree_leaves(r[name]["new"]))), name
    assert all(r["imported"] == [] for r in res)


@pytest.mark.parametrize("name,kw", [("st_f32", {}),
                                     ("group", {"encoder_norm": "group"})])
def test_mesh_f32_matches_jax_single_device(mesh_run, name, kw):
    cases, res = mesh_run
    loss, grads, state = jax_reference(tuple(DILS), 2, 256, 0, **kw)
    assert res[0][name]["loss"] == pytest.approx(loss, rel=2e-4)
    check_f32_grads(res[0][name]["grads"], grads)
    if name == "st_f32":        # the batch norms' new running statistics
        check_change(res[0][name]["new"]["model_state"]["encoder"],
                     cases[name][3]["encoder"], state["encoder"],
                     cases[name][3]["encoder"], "batch norm")


def test_mesh_bf16_tracks_jax_single_device(mesh_run):
    _, res = mesh_run
    loss, grads, _ = jax_reference(tuple(DILS), 2, 256, 0,
                                   train_dtype="bf16")
    assert res[0]["st_bf16"]["loss"] == pytest.approx(loss, rel=2e-2)
    check_bf16_grads(res[0]["st_bf16"]["grads"], grads,
                     jax_reference(tuple(DILS), 2, 256, 0)[1])


def test_mesh_ema_codebook_matches_jax_train_step(mesh_run):
    """After one step the codebook and its EMA state (and the batch
    norms') equal JAX's single-device train_step's."""
    cases, res = mesh_run
    _, _, params, state, _, _, _ = cases["ema"]
    ref = jax_ema_step(tuple(DILS), 2, 256, 0)
    new = res[0]["ema"]["new"]
    check_change(new["model_state"], state, ref["model_state"], state,
                 "model state")
    emb, want = new["params"]["vq"]["embedding"], np.asarray(
        ref["params"]["vq"]["embedding"])
    assert not np.allclose(emb, params["vq"]["embedding"])
    assert np.abs(emb - want).max() <= 1e-4 * np.abs(want).max()


# ------------------------------------------------ the 'layer' and 'recompute'
# halos

@pytest.fixture(scope="module")
def halo_runs():
    """'layer' and 'recompute' on a time row of 2 and of 4 with the
    multi-hop dilations (B = 2, T = 256)."""
    out = {}
    for n, dils, T in ((2, DILS, 256), (4, MULTIHOP, 256)):
        case = jax_case(tuple(dils), 2, T, 1)
        cases = {h: ({}, dils) + case + (h,) for h in ("layer", "recompute")}
        out[n] = (dils, T, run_ranks(sp_case_rank, n, "cpu", cases,
                                     timeout=RANK_TIMEOUT, n_time=n))
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("halo", ["layer", "recompute"])
def test_halo_modes_match_jax_single_device(halo_runs, n, halo):
    dils, T, res = halo_runs[n]
    loss, grads, _ = jax_reference(tuple(dils), 2, T, 1)
    for r in res:
        assert r[halo]["loss"] == pytest.approx(loss, rel=2e-4)
    assert all(r["imported"] == [] for r in res)
    check_f32_grads(res[0][halo]["grads"], grads)


def test_halo_plans():
    """'layer': a group a layer with (K-1)*d rows rounded up to whole
    frames; 'recompute': one group with the receptive field's halo;
    'layer' past 64 layers is 'recompute' (timeshard.py:614-619)."""
    wn = WavenetConfig(**dict(WN, dilation_rates=MULTIHOP))
    assert sp_groups(wn, 64, 64, "layer") == [(0, 1, 64), (1, 2, 128),
                                              (2, 3, 64), (3, 4, 128)]
    assert sp_groups(wn, 64, 64, "recompute") == [(0, 4, 320)]
    assert sp_groups(wn, 320, 320, "layer") == [(l, l + 1, 320)
                                                for l in range(4)]
    deep = WavenetConfig(**dict(WN, num_cycles=13, num_cycle_layers=5,
                                dilation_rates=[1, 2, 4, 8, 16] * 13))
    assert deep.num_layers == 65
    assert sp_groups(deep, 64, 512, "layer") == sp_groups(
        deep, 64, 512, "recompute") == [(0, 65, halo_sizes(deep, 64)[0])]
    shallow = WavenetConfig(**dict(WN, num_cycles=16, num_cycle_layers=4,
                                   dilation_rates=[1, 2, 4, 8] * 16))
    assert len(sp_groups(shallow, 64, 512, "layer")) == 64


def test_cycle_plans_match_jax_or_round_to_frames():
    """The 'fused' plan is JAX's _fused_sp_groups wherever JAX has one;
    where JAX has none (Encoder_2019's 320-sample frames), every halo is
    a whole number of frames."""
    from vqvae_wavenet_tpu.config import WavenetConfig as JWavenetConfig
    from vqvae_wavenet_tpu.parallel import timeshard as jts
    shipped = dict(WN, quantization_channels=256, num_cycles=3,
                   num_cycle_layers=10,
                   dilation_rates=[2 ** i for i in range(10)] * 3)
    for wn in (shipped, WN, dict(WN, dilation_rates=MULTIHOP)):
        for ratio, t_l in ((64, 3328), (64, 1664), (64, 256), (64, 64),
                           (320, 3200), (320, 1600), (320, 320)):
            ours = fused_sp_groups(WavenetConfig(**wn), ratio, t_l)
            theirs = jts._fused_sp_groups(JWavenetConfig(**wn), ratio, t_l)
            if theirs is not None:
                assert ours == theirs, (wn["dilation_rates"], ratio, t_l)
            else:
                assert ours[1] == ratio
                assert all(h % ratio == 0 and h >= 2 * sum(
                    wn["dilation_rates"][lo:hi]) for lo, hi, h in ours[0])
    groups, q = fused_sp_groups(WavenetConfig(**shipped), 320, 3200)
    assert q == 320 and [h for _, _, h in groups] == [2240] * 3


# ---------------------------------------------------------- the rank layout

@pytest.mark.parametrize("batch,n_time,hosts,devices", [
    (8, 2, 1, 4), (8, 2, 1, 8), (6, 2, 1, 8), (8, 4, 1, 16), (8, 1, 1, 4),
    (8, 2, 1, 3), (8, 2, 1, 1), (8, 4, 1, 2), (4, 2, 2, 1), (4, 2, 2, 4),
    (1, 2, 3, 2)])
def test_mesh_shape_follows_jax(monkeypatch, batch, n_time, hosts, devices):
    """n_data = gcd(global batch, devices // n_time) as train.py:146-152,
    except with fewer devices than time shards, where JAX's gcd(b, 0) = b
    would ask for b * n_time devices: the port runs data = 1 (its ranks
    share the devices)."""
    monkeypatch.setattr(mesh, "device_count", lambda device_type: devices)
    n_dev = devices * hosts
    jax_data = math.gcd(batch * hosts, n_dev // n_time) or 1
    want = jax_data if n_dev >= n_time else 1
    n_data, local = mesh.mesh_shape(batch, n_time, hosts, "cpu")
    assert n_data == want and local * hosts == n_data * n_time
    if n_dev < n_time:
        assert jax_data == batch * hosts      # JAX's layout would not fit


def test_mesh_shape_refuses_uneven_hosts(monkeypatch):
    monkeypatch.setattr(mesh, "device_count", lambda device_type: 1)
    with pytest.raises(ValueError, match="hosts"):
        mesh.mesh_shape(1, 2, 3, "cpu")       # 2 ranks over 3 hosts


def test_rank_layout_on_the_mesh():
    """Global rank d * n_time + t is JAX's device [d, t] of the (data, time)
    mesh (devices[:n_data * n_time].reshape(n_data, n_time)); rank_rows
    takes part d of the global batch; a time shard's neighbours are those
    of its row, none past the row's ends."""
    grid = np.arange(6).reshape(3, 2)
    x = torch.arange(6)
    for r in range(6):
        sh = Shards(r, 6, torch.device("cpu"), "gloo", n_time=2)
        assert grid[sh.data_rank, sh.time_rank] == r
        assert sh.n_data == 3
        assert torch.equal(mesh.rank_rows(x, sh), x[2 * sh.data_rank:
                                                    2 * sh.data_rank + 2])
        right = r + 1 if sh.time_rank == 0 else None
        left = r - 1 if sh.time_rank == 1 else None
        assert comm._peers(1, sh) == (right, left)
        assert comm._peers(2, sh) == (None, None)
