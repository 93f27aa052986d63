"""Time jitter and the upsampled condition in the port's training forward,
against the JAX package (vqvae_wavenet_tpu/models/vqvae.py:87-119).

JAX draws the jitter's moves inside ``time_jitter`` from its key; the port
draws them apart (``jitter_moves``) and applies them (``time_jitter``).
Running JAX's ``time_jitter`` on an index-coded condition (feature = frame
index) with the key recovers the frame each position reads, so the port
can be fed JAX's own moves.  Tolerances: the application bit for bit; the
forward's loss and every gradient leaf in f32 within 1e-4 relative
(max|delta| / max|ref|, summation order only), as
tests/test_torch_train_step.py holds the step without these switches;
the port's own draw within five binomial standard deviations of .06 /
.88 / .06.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.models import vqvae as jvqvae
from vqvae_wavenet_tpu.training import train_loop as jloop
from vqvae_wavenet_torch.models.vqvae import jitter_moves, time_jitter
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import from_jax_train_state
from vqvae_wavenet_torch.training import train_loop as tloop

from test_torch_train_step import batch_np, rel, tiny_cfg, torch_batch

set_full_f32()


def jax_moves(key, b, t):
    """The moves JAX's time_jitter(rng=key) applies to a [b, t, C]
    condition: the frame each position reads, less its own index (edges
    already reflected)."""
    idx = jnp.broadcast_to(jnp.arange(t, dtype=jnp.float32)[None, :, None],
                           (b, t, 1))
    got = np.asarray(jvqvae.time_jitter(idx, key))[..., 0].astype(np.int64)
    return torch.from_numpy(got - np.arange(t)[None, :])


def test_jitter_application_matches_jax_bit_for_bit():
    key = jax.random.PRNGKey(11)
    lc = np.random.default_rng(0).standard_normal((3, 57, 5)).astype(
        np.float32)
    want = np.asarray(jvqvae.time_jitter(jnp.asarray(lc), key))
    moves = jax_moves(key, 3, 57)
    assert set(np.unique(moves.numpy())) <= {-1, 0, 1}
    assert (moves != 0).any()
    np.testing.assert_array_equal(
        time_jitter(torch.from_numpy(lc), moves).numpy(), want)


def test_jitter_reflects_at_the_edges():
    lc = torch.arange(6, dtype=torch.float32)[None, :, None]
    moves = torch.tensor([[-1, 1, 0, 0, -1, 1]])
    # frame 0 moving left reads frame 1; frame 5 moving right reads frame 4
    assert time_jitter(lc, moves)[0, :, 0].tolist() == [1, 2, 2, 3, 3, 4]


def test_jitter_draw_matches_the_probabilities():
    moves = jitter_moves(3, 64, 1000)
    n = moves.numel()
    assert moves.dtype == torch.int64
    for v, p in ((-1, 0.06), (0, 0.88), (1, 0.06)):
        got = float((moves == v).sum()) / n
        assert abs(got - p) < 5 * (p * (1 - p) / n) ** 0.5, (v, got)
    # a seed gives one draw; another seed another
    assert torch.equal(moves, jitter_moves(3, 64, 1000))
    assert not torch.equal(moves, jitter_moves(4, 64, 1000))


@functools.lru_cache(maxsize=None)
def jax_state(jitter, upsample):
    cfg = tiny_cfg(time_jitter=jitter, condition_upsample=upsample)
    return cfg, jax.device_get(jax.jit(lambda k: jloop.init_train_state(
        k, cfg, num_speakers=3))(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("jitter,upsample", [
    (True, True), (True, False), (False, True)])
def test_forward_and_grads_match_jax(jitter, upsample):
    """vqvae_forward with the switches, f32, B=2 x 1,024 (16 frames of
    64): JAX's value_and_grad with rng=key against the port's
    loss_and_grads fed the moves recovered from the same key."""
    cfg, ts = jax_state(jitter, upsample)
    b = batch_np(T=1024)
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        return jvqvae.vqvae_forward(p, ts["model_state"], cfg,
                                    jnp.asarray(b["x"]), jnp.asarray(b["y"]),
                                    train=True, rng=key)
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        ts["params"])
    jgrads = jax.device_get(jgrads)
    pts = from_jax_train_state(ts)
    batch = torch_batch(b)
    if jitter:
        batch["jitter"] = jax_moves(key, 2, 16)
    loss, aux, grads = tloop.loss_and_grads(pts["params"], pts["model_state"],
                                            cfg, batch)
    assert rel(loss, jl) < 1e-4
    assert rel(aux["reconstruction_loss"], jaux["reconstruction_loss"]) < 1e-4
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    floor = 1e-6 * max(np.abs(r).max() for r in jleaves)
    for i, (g, r) in enumerate(zip(grads, jleaves)):
        if np.abs(r).max() < floor:
            assert float(g.abs().max()) < floor, i
        else:
            assert rel(g, r) < 1e-4, (i, rel(g, r))
    if jitter:      # the moves matter: without them the loss differs
        del batch["jitter"]
        plain, _, _ = tloop.loss_and_grads(pts["params"], pts["model_state"],
                                           cfg, batch)
        assert rel(plain, jl) > 1e-6
