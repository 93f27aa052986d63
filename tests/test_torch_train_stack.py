"""The port's teacher-forced WaveNet (preprocess, skip start, the residual
stack through ``fused_residual_stack``, the heads) against the JAX
package's ``wavenet_logits(engine="xla")`` and ``jax.grad`` of it, on the
tiny config of tests/test_train_pallas.py (B=2, T=128, 16 condition
frames), and on one ragged shape (widths that are multiples of 8 and not
of 64, T = 200 in 8 frames, a tap shifted past T): the shape class at
which chip_smoke.py holds the CUDA kernels to this plain version.  On the
CPU the stack runs its plain version, which rounds where the CUDA kernels
do.

Tolerances.  f32: the loss within 1e-5 and every gradient leaf within
max|delta| / max|ref| < 1e-4 -- both sides are float32 at full precision
and differ only in summation order (JAX's own Pallas-kernel gate, 5e-3,
covers bf16-saved activations; f32 against f32 does far better).  bf16:
the logits within 5e-2 of max|f32 logits|, and no further from the f32
reference than twice JAX's own bf16 XLA error + 1e-3 (as
test_train_pallas.py:342-360 holds the TPU kernel).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.config import WavenetConfig
from vqvae_wavenet_tpu.models.wavenet import (init_wavenet_params,
                                              wavenet_logits as jlogits)
from vqvae_wavenet_torch.models.wavenet import wavenet_logits as tlogits
from vqvae_wavenet_torch.ops import train_kernels
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import to_torch

set_full_f32()

B, T, T_COND, C_LC, C_GC = 2, 128, 16, 128, 16


# per-seed shapes other than the default: (D, S, R), T, condition frames
SHAPES = {9: ((40, 56, 72), 200, 8)}


def tiny_cfg(dils=(1, 2, 4, 8), widths=(64, 128, 128)):
    D, S, R = widths
    return WavenetConfig(
        quantization_channels=256, num_cycles=1, num_cycle_layers=len(dils),
        dilation_rates=list(dils), kernel_size=3, dilation_filters=D,
        skip_filters=S, residual_filters=R, preprocess_kernel_size=8,
        preprocess_filters=R)


@functools.lru_cache(maxsize=None)
def case(dils, with_gc, seed):
    """numpy (params, x, lc, gc, w) from a seed (built once, not mutated)."""
    widths, t_len, frames = SHAPES.get(seed, ((64, 128, 128), T, T_COND))
    cfg = tiny_cfg(dils, widths)
    params = jax.device_get(init_wavenet_params(
        jax.random.PRNGKey(seed), cfg, lc_channels=C_LC,
        gc_channels=C_GC if with_gc else None))
    rng = np.random.default_rng(seed)
    # nonzero biases so every bias gradient path is exercised
    for name in ("bias", "skip_bias", "res_bias"):
        params["layers"][name] = rng.normal(
            0, 0.05, params["layers"][name].shape).astype(np.float32)
    x = rng.uniform(-0.9, 0.9, (B, t_len, 1)).astype(np.float32)
    lc = (rng.standard_normal((B, frames, C_LC)) * 0.3).astype(np.float32)
    gc = rng.standard_normal((B, 1, C_GC)).astype(np.float32) \
        if with_gc else None
    w = (rng.standard_normal(256) * 0.1).astype(np.float32)
    return cfg, params, x, lc, gc, w


CASES = [((1, 2, 4, 8), False, "tanh_first", 5),
         ((1, 2, 4, 8), True, "sigmoid_first", 6),
         ((1, 64, 200, 8), False, "tanh_first", 7),   # 2*200 >= T: o_j >= T
         ((1, 3, 120), False, "tanh_first", 9)]       # SHAPES[9], 2*120 >= T


def _jax_grads(cfg, params, x, lc, gc, w, gate_order):
    def loss(p):
        out = jlogits(p, cfg, jnp.asarray(x), jnp.asarray(lc),
                      None if gc is None else jnp.asarray(gc),
                      gate_order=gate_order, engine="xla")
        return jnp.mean(jnp.tanh(out) * jnp.asarray(w))
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), jax.device_get(grads)


@pytest.mark.parametrize("dils,with_gc,gate_order,seed", CASES)
def test_stack_f32_loss_and_grads_match_jax(dils, with_gc, gate_order, seed):
    cfg, params, x, lc, gc, w = case(dils, with_gc, seed)
    ref_loss, ref_grads = _jax_grads(cfg, params, x, lc, gc, w, gate_order)

    tp = to_torch(params)
    leaves, paths = [], []

    def mark(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                mark(v, path + (k,))
            else:
                v.requires_grad_(True)
                leaves.append(v)
                paths.append(path + (k,))
    mark(tp, ())
    before = train_kernels.fwd_launches, train_kernels.bwd_launches
    out = tlogits(tp, cfg, torch.from_numpy(x), torch.from_numpy(lc),
                  None if gc is None else torch.from_numpy(gc),
                  gate_order=gate_order)
    loss = torch.mean(torch.tanh(out) * torch.from_numpy(w))
    grads = torch.autograd.grad(loss, leaves)
    assert (train_kernels.fwd_launches, train_kernels.bwd_launches) == before
    assert abs(float(loss.detach()) - ref_loss) < 1e-5
    for path, g in zip(paths, grads):
        ref = functools.reduce(lambda t, k: t[k], path, ref_grads)
        ref = np.asarray(ref, np.float64)
        rel = np.abs(g.numpy() - ref).max() / (np.abs(ref).max() + 1e-12)
        assert rel < 1e-4, (path, rel)


def test_stack_bf16_tracks_f32_reference():
    cfg, params, x, lc, _, _ = case((1, 2, 4, 8), False, 8)
    ref = np.asarray(jax.jit(lambda p: jlogits(
        p, cfg, jnp.asarray(x), jnp.asarray(lc), engine="xla"))(params))
    p16 = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.bfloat16),
                                 params)
    xla16 = np.asarray(jax.jit(lambda p: jlogits(
        p, cfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(lc, jnp.bfloat16),
        engine="xla"))(p16), np.float32)
    tp16 = {k: {n: v.to(torch.bfloat16) for n, v in d.items()}
            for k, d in to_torch(params).items()}
    with torch.no_grad():
        got = tlogits(tp16, cfg, torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(lc).to(torch.bfloat16)).numpy()
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err / scale < 0.05
    assert err <= 2 * np.abs(xla16 - ref).max() + 1e-3


def test_kernel_wrappers_refuse_cpu_tensors():
    kernel = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        train_kernels.stack_forward_cuda(
            kernel, torch.zeros((1, 8, 8)), torch.zeros((1, 8, 8)),
            torch.zeros((1, 8)), torch.zeros((1, 1, 1, 16)),
            torch.zeros((1, 8, 8)), (1,))
