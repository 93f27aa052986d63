"""The port's prior over VQ codes (models/prior.py) against the JAX
package's at small widths (k=16, embed 8, filters 16, kernel 3), the same
JAX init carried over by ``params.from_jax_prior``, codes from a numpy
seed: logits, loss and every gradient leaf, with and without a global
condition, in f32 and with the parameters cast to bf16 inside the loss
(the prior CLI's -train_dtype bf16); causality; seeded sampling.

Tolerances.  f32: logits, loss and every gradient leaf within 1e-5 of the
largest |reference| of the leaf (float32 on both sides, summation order
only).  bf16: logits and loss within 2e-2, the repo's bf16 training
tolerance (tests/test_torch_train_epilogue.py).  bf16 gradients are far
from any f32 gradient in both frameworks at these widths (JAX's own bf16
gradient leaf lies up to 17% from its f32 leaf, L2 relative: eight gated
layers of bf16 rounding, and the frameworks round at other points), so a
fixed 2e-2 bound says nothing there.  Each leaf is held on its own: the
port's bf16 leaf must lie as close to JAX's f32 leaf as JAX's bf16 leaf
does, within 1.5x plus 0.03 of the f32 leaf's norm (L2; the [sp-train]
distance-to-f32 rule of chip_smoke.py, per leaf), and a leaf whose f32
gradient is zero must be zero.  Readings at these seeds: without gc the
port's distance is at most 1.03x JAX's; with gc up to 1.96x, at most
0.022 of the leaf's norm above 1.5x (layers 4-7, whose gated units see
the gc term's extra rounding), hence the 0.03.  Scaling one small leaf's
gradient by 0.8 (post1's bias, or the last layer's bias) fails it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.models import prior as jprior
from vqvae_wavenet_torch.models import prior as tprior
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import from_jax_prior
from vqvae_wavenet_torch.training.optimizer import tree_leaves

set_full_f32()

K, E, FILT, GC = 16, 8, 16, 4


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def jax_prior(gc: bool, seed=0):
    p = jprior.init_prior_params(jax.random.PRNGKey(seed), K, embed_dim=E,
                                 filters=FILT,
                                 gc_channels=GC if gc else None)
    # non-zero biases, so that the bias paths are checked too
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, jax.device_get(p))
    for layer in p["layers"]:
        for k in ("bias", "skip_bias", "res_bias"):
            layer[k] = rng.normal(0, 0.1, layer[k].shape).astype(np.float32)
    for k in ("preprocess", "post1", "post2"):
        p[k]["bias"] = rng.normal(0, 0.1, p[k]["bias"].shape).astype(
            np.float32)
    return p


def inputs(gc: bool, B=2, T=24, seed=1):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, K, (B, T)).astype(np.int32)
    h = (rng.standard_normal((B, 1, GC)).astype(np.float32) if gc else None)
    return codes, h


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gc", [False, True])
def test_logits_loss_grads_match_jax(gc, dtype):
    p = jax_prior(gc)
    codes, h = inputs(gc)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tol = 2e-2 if dtype == "bf16" else 1e-5

    def jcast(t):
        return jax.tree_util.tree_map(lambda v: v.astype(jd), t)

    def jloss(params):
        return jprior.prior_loss(jcast(params), jnp.asarray(codes),
                                 None if h is None else jnp.asarray(h, jd))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(p)
    jg32 = jax.jit(jax.grad(lambda params: jprior.prior_loss(
        params, jnp.asarray(codes),
        None if h is None else jnp.asarray(h))))(p)
    jlogits = jax.jit(lambda params: jprior.prior_logits(
        jcast(params), jnp.asarray(codes),
        None if h is None else jnp.asarray(h, jd)))(p)

    tp = from_jax_prior(p)
    assert tree_leaves(tp)[0].dtype == torch.float32
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]

    def tcast(t):
        if isinstance(t, dict):
            return {k: tcast(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tcast(v) for v in t]
        return t.to(td)
    th = None if h is None else torch.from_numpy(h).to(td)
    tc = torch.from_numpy(codes)
    logits = tprior.prior_logits(tcast(tp), tc, th)
    assert logits.shape == (2, 24, K)
    assert rel(logits.float().detach(), np.asarray(jlogits, np.float32)) \
        < tol
    loss = tprior.prior_loss(tcast(tp), tc, th)
    assert loss.dtype == torch.float32
    assert rel(float(loss.detach()), float(jl)) < tol
    # the last layer's residual output reaches nothing (JAX: zeros)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    ref = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(grads) == len(ref) == (8 * (7 if gc else 6) + 7)
    assert all(g.dtype == torch.float32 for g in grads)
    if dtype == "f32":
        for i, (g, r) in enumerate(zip(grads, ref)):
            assert rel(g, r) < tol, (i, rel(g, r))
        return

    ref32 = jax.tree_util.tree_leaves(jax.device_get(jg32))
    for i, (g, j16, j32) in enumerate(zip(grads, ref, ref32)):
        g, j16, j32 = (np.asarray(x, np.float64) for x in (g, j16, j32))
        norm = np.linalg.norm(j32)
        if norm == 0:
            assert not g.any(), i
            continue
        port, jaxd = (np.linalg.norm(g - j32) / norm,
                      np.linalg.norm(j16 - j32) / norm)
        assert port <= 1.5 * jaxd + 0.03, (i, port, jaxd)


def test_prior_is_causal():
    """Position t sees codes[< t] only: changing code t changes no logit
    at positions <= t, and does change a later one."""
    tp = from_jax_prior(jax_prior(True))
    codes, h = inputs(True, seed=2)
    codes = torch.from_numpy(codes)
    h = torch.from_numpy(h)
    base = tprior.prior_logits(tp, codes, h)
    for t in (0, 5, 23):
        c2 = codes.clone()
        c2[:, t] = (c2[:, t] + 3) % K
        other = tprior.prior_logits(tp, c2, h)
        assert torch.equal(other[:, :t + 1], base[:, :t + 1]), t
        if t < 23:
            assert not torch.allclose(other[:, t + 1:], base[:, t + 1:])


def test_init_matches_jax_shapes_and_limits():
    got = tprior.init_prior_params_np(K, embed_dim=E, filters=FILT,
                                      gc_channels=GC, seed=3)
    ref = jax.eval_shape(lambda k: jprior.init_prior_params(
        k, K, embed_dim=E, filters=FILT, gc_channels=GC),
        jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(ref)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert g.shape == r.shape and g.dtype == np.float32
    lim = np.sqrt(3.0 / (3 * FILT))              # kernel [3, F, 2F]
    k = got["layers"][0]["kernel"]
    assert lim * 0.98 < np.abs(k).max() <= lim
    assert tuple(tprior.PRIOR_DILATIONS) == tuple(jprior.PRIOR_DILATIONS)


def test_sample_is_seeded_in_range_and_follows_the_logits():
    """Two draws from one seed are equal and in [0, k); replaying the
    generator's uniforms, each code is the Gumbel-max of prior_logits on
    the drawn sequence (which at step t equals the prefix the sampler saw,
    by causality) at temperature 0.7."""
    tp = from_jax_prior(jax_prior(True, seed=4))
    _, h = inputs(True, B=3)
    h = torch.from_numpy(h)

    def draw():
        return tprior.prior_sample(tp, torch.Generator().manual_seed(11),
                                   batch_size=3, length=20, gc=h,
                                   temperature=0.7)
    codes = draw()
    assert codes.shape == (3, 20) and codes.dtype == torch.int64
    assert torch.equal(codes, draw())
    assert int(codes.min()) >= 0 and int(codes.max()) < K
    assert len(set(codes.reshape(-1).tolist())) > 1
    logits = tprior.prior_logits(tp, codes, h)
    g = torch.Generator().manual_seed(11)
    for t in range(20):
        u = torch.rand((3, K), generator=g).clamp_min(
            torch.finfo(torch.float32).tiny)
        want = torch.argmax(logits[:, t] / 0.7 - torch.log(-torch.log(u)),
                            dim=-1)
        assert torch.equal(codes[:, t], want), t


def test_dropout_is_seeded_and_scales_kept_units():
    tp = from_jax_prior(jax_prior(False))
    codes = torch.from_numpy(inputs(False)[0])
    plain = tprior.prior_logits(tp, codes)

    def run():
        return tprior.prior_logits(tp, codes,
                                   generator=torch.Generator().manual_seed(5),
                                   dropout_rate=0.5)
    a = run()
    assert torch.equal(a, run()) and not torch.allclose(a, plain)
    assert torch.equal(tprior.prior_logits(
        tp, codes, generator=torch.Generator().manual_seed(5),
        dropout_rate=0.0), plain)
