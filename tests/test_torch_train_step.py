"""The port's training step against the JAX package's, on the tiny config
of tests/test_training.py:19-35 (3 layers, K=2, widths 8, Q=32, B=2,
T=128): the same JAX init carried into the port by
``params.from_jax_train_state``, the same numpy batch.

Tolerances.  Step 1 in f32: the loss, every metric and every gradient leaf
within 1e-4 relative (max|delta| / max|ref|; float32 on both sides,
summation order only), the batch-norm running statistics within 1e-6.
Two leaves have an exact gradient of zero -- encoder/out/bias and
encoder/bn/5/bias add per-channel constants that the training-mode batch
norm after the 1x1 out conv subtracts again -- and hold only rounding
noise on both sides (~1e-9); a leaf whose reference is below 1e-6 of the
largest gradient is held to that absolute bound instead.
Over 3 steps, each from JAX's state before it: the updates of params and
EMA shadows within 1e-3 where the gradient is well above rounding (else
2.5*lr: Adam moves an element by about lr*sign(g), and a gradient within
rounding of zero can take the other sign), and the model state's change
within 1e-4 of each leaf's largest change (reasons in ``check_update``).
bf16: the loss within 2e-2 of the f32 loss (rounding only), and 8 steps on
one batch lower it (tests/test_training.py:129-155).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.config import ModelConfig, WavenetConfig
from vqvae_wavenet_tpu.models.vqvae import vqvae_forward as jforward
from vqvae_wavenet_tpu.training import train_loop as jloop
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import from_jax_train_state
from vqvae_wavenet_torch.training import train_loop as tloop
from vqvae_wavenet_torch.training.optimizer import tree_leaves

set_full_f32()

LR = 8e-5


def tiny_cfg(**kw):
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


def batch_np(seed=1, B=2, T=128, S=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    y = np.zeros((B, 1, S), np.float32)
    y[np.arange(B), 0, np.arange(B) % S] = 1.0
    return {"x": x, "y": y}


@functools.lru_cache(maxsize=None)
def jax_state(vq_mode="st"):
    cfg = tiny_cfg(vq_mode=vq_mode)
    return jax.device_get(jax.jit(lambda k: jloop.init_train_state(
        k, cfg, num_speakers=3))(jax.random.PRNGKey(0)))


def port_state(vq_mode="st"):
    return from_jax_train_state(jax_state(vq_mode))


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def test_first_step_loss_metrics_grads_match_jax():
    cfg = tiny_cfg()
    ts = jax_state()
    b = batch_np()

    def loss_fn(p):
        return jforward(p, ts["model_state"], cfg, jnp.asarray(b["x"]),
                        jnp.asarray(b["y"]), train=True)
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        ts["params"])
    jaux, jgrads = jax.device_get((jaux, jgrads))

    pts = port_state()
    loss, aux, grads = tloop.loss_and_grads(pts["params"], pts["model_state"],
                                            cfg, torch_batch(b))
    assert rel(loss, jl) < 1e-4
    for k in ("reconstruction_loss", "vq_loss", "commitment_loss",
              "perplexity", "distances_mean"):
        assert rel(aux[k], jaux[k]) < 1e-4, k
    np.testing.assert_array_equal(aux["q_z_x"].numpy(), jaux["q_z_x"])
    jl_leaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jl_leaves) == len(grads)
    floor = 1e-6 * max(np.abs(r).max() for r in jl_leaves)
    for i, (g, r) in enumerate(zip(grads, jl_leaves)):
        assert g is not None
        if np.abs(r).max() < floor:
            assert float(g.abs().max()) < floor, i
        else:
            assert rel(g, r) < 1e-4, (i, rel(g, r))
    for s, r in zip(tree_leaves(aux["state"]["encoder"]),
                    jax.tree_util.tree_leaves(jaux["state"]["encoder"])):
        np.testing.assert_allclose(s.numpy(), r, rtol=1e-6, atol=1e-6)


def t64(x):
    """A float64 torch copy of a numpy leaf."""
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def check_update(name, new, old, jnew, jold, jgrads, scale):
    """The port's one-step update of tree ``name`` (new - old) against
    JAX's (jnew - jold), both from the same state, per element in float64.
    Each side rounds the new value to float32 once, so 2 ulp of it are
    allowed on top of:
      - 1e-3 of JAX's update, or of lr * scale where the update is
        smaller (Adam's moments nearly cancel there, and the gradient's
        rounding then weighs more), where the step's gradient is well
        above rounding (above 1e-2 of its leaf's largest, in a leaf whose
        gradient is above 1e-6 of the largest of any leaf);
      - elsewhere 2.5 * lr * scale (Adam moves such an element by about
        lr * sign(g), and a gradient within rounding of zero can take the
        other sign) plus 1e-4 of the leaf's largest update (the VQ EMA
        codebook, which moves without a gradient).
    ``scale`` is the share of the parameter update the tree sees (1 for
    params, 1 - ema_decay for the EMA shadows).  Returns the largest
    |update| of the port's tree."""
    f64 = torch.float64
    gmax = max(float(g.abs().max()) for g in jgrads)
    moved = 0.0
    for k, (a, a0, r, r0) in enumerate(zip(
            tree_leaves(new[name]), tree_leaves(old[name]),
            jax.tree_util.tree_leaves(jnew[name]),
            jax.tree_util.tree_leaves(jold[name]))):
        r, r0 = t64(r), t64(r0)
        dp, dj = a.to(f64) - a0.to(f64), r - r0
        g = jgrads[k].abs()
        sharp = (g > 1e-2 * g.max()) & (g.max() > 1e-6 * gmax)
        ulp = 2 * torch.finfo(torch.float32).eps * torch.maximum(r.abs(),
                                                                 r0.abs())
        tol = ulp + torch.where(
            sharp, 1e-3 * dj.abs().clamp_min(LR * scale),
            2.5 * LR * scale + 1e-4 * dj.abs().max())
        err = (dp - dj).abs()
        bad = err > tol
        assert not bad.any(), (name, k, tuple(a.shape), int(bad.sum()),
                               float(err[bad].max()))
        moved = max(moved, float(dp.abs().max()))
    return moved


def check_state(new, old, jnew, jold):
    """Model state (batch-norm running statistics, VQ EMA state): the
    port's one-step change within 1e-4 of its leaf's largest change plus 2
    ulp of the value (the statistics come from float32 sums in another
    order), plus 1e-8: the input of the last batch norm is a 1x1 conv of a
    batch-normed tensor, so its batch mean is zero up to float32 rounding
    and moves that running mean by noise of ~1e-9 on both sides."""
    for a, a0, r, r0 in zip(
            tree_leaves(new["model_state"]), tree_leaves(old["model_state"]),
            jax.tree_util.tree_leaves(jnew["model_state"]),
            jax.tree_util.tree_leaves(jold["model_state"])):
        a, a0 = a.double().numpy(), a0.double().numpy()
        r, r0 = np.asarray(r, np.float64), np.asarray(r0, np.float64)
        dp, dj = a - a0, r - r0
        assert np.abs(dj).max() > 0 and np.abs(dp).max() > 0
        tol = (1e-4 * np.abs(dj).max()
               + 2 * np.finfo(np.float32).eps * np.abs(r) + 1e-8)
        assert (np.abs(dp - dj) <= tol).all(), (a.shape,
                                                float(np.abs(dp - dj).max()))


@pytest.mark.parametrize("vq_mode", ["st", "ema"])
def test_three_steps_match_jax(vq_mode):
    """Three steps.  Each port step starts from JAX's state before that
    step (carried by from_jax_train_state), so the updates can be compared
    tightly: run free, the two packages drift apart after the first step,
    since the encoder's batch norm over 4 values per channel (B=2 x 2
    frames) amplifies the lr-sized sign differences of near-zero
    gradients.  EMA decay 0.5 (the shipped 0.999 moves a shadow by ~1e-8,
    below float32 rounding) makes the shadows' order visible: they follow
    the updated parameters."""
    cfg = tiny_cfg(vq_mode=vq_mode)
    decay = 0.5
    jts = jax.device_get(jax_state(vq_mode))
    step = jax.jit(functools.partial(jloop.train_step, cfg=cfg,
                                     ema_decay=decay))
    for i in range(3):
        b = batch_np(seed=10 + i)
        pts = from_jax_train_state(jts)
        jnew, jm = step(jts, {k: jnp.asarray(v) for k, v in b.items()}, None)
        jnew = jax.device_get(jnew)
        pnew, pm = tloop.train_step(pts, torch_batch(b), cfg,
                                    ema_decay=decay)
        assert rel(pm["loss"], jm["loss"]) < 1e-4
        assert pm["lr"] == pytest.approx(float(jm["lr"]))
        assert pnew["step"] == int(jnew["step"]) == i + 1
        assert pnew["opt_state"]["count"] == int(jnew["opt_state"][0].count)
        # the step's gradients, from JAX's first moments (mu = 0.9 mu + 0.1 g)
        jgrads = [(t64(m1) - 0.9 * t64(m0)) / 0.1 for m0, m1 in zip(
                      jax.tree_util.tree_leaves(jts["opt_state"][0].mu),
                      jax.tree_util.tree_leaves(jnew["opt_state"][0].mu))]
        moved = check_update("params", pnew, pts, jnew, jts, jgrads, 1.0)
        assert moved > 0.5 * LR                    # the update was applied
        check_update("ema_params", pnew, pts, jnew, jts, jgrads, 1 - decay)
        check_state(pnew, pts, jnew, jts)
        jts = jnew
    if vq_mode == "ema":
        # the codebook moved by its EMA, not by the optimizer (whose
        # gradient for it is zero in this mode)
        start = port_state("ema")
        emb0 = start["params"]["vq"]["embedding"]
        emb3 = pnew["params"]["vq"]["embedding"]
        assert not torch.allclose(emb0, emb3)
        assert float(pnew["model_state"]["vq"]["ema_cluster_size"].sum()) > 0
        np.testing.assert_allclose(
            pnew["opt_state"]["mu"]["vq"]["embedding"].numpy(), 0.0)


def test_bf16_step_tracks_f32_and_learns():
    cfg32, cfg16 = tiny_cfg(), tiny_cfg(train_dtype="bf16")
    b = torch_batch(batch_np(seed=1))
    _, m32 = tloop.train_step(port_state(), b, cfg32)
    ts, m16 = tloop.train_step(port_state(), b, cfg16)
    assert float(m16["loss"]) == pytest.approx(float(m32["loss"]), rel=2e-2)
    losses = [float(m16["loss"])]
    for _ in range(7):
        ts, m = tloop.train_step(ts, b, cfg16)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert ts["params"]["decoder"]["preprocess"]["kernel"].dtype \
        == torch.float32                               # f32 master weights


def test_engines_other_than_auto_are_refused():
    from vqvae_wavenet_torch.config import ModelConfig as PortConfig
    with pytest.raises(ValueError, match="TPU"):
        PortConfig(train_engine="pallas")
    # time_jitter is no engine: it trains (its parity with JAX is in
    # tests/test_torch_jitter.py)
    from vqvae_wavenet_torch.models.vqvae import jitter_moves
    cfg = dataclasses.replace(tiny_cfg(), time_jitter=True)
    batch = dict(torch_batch(batch_np()), jitter=jitter_moves(1, 2, 2))
    _, m = tloop.train_step(port_state(), batch, cfg)
    assert np.isfinite(float(m["loss"]))
