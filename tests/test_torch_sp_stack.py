"""The sequence-parallel variants of the port's residual-stack kernels (the
TPU kernels' start offset, stream output and layer range), on their plain
twins, at the widths of JAX's SP tests (tests/test_timeshard.py:587-600:
R = S = 128, 2D = 128, dilations [1, 2, 1, 2], K = 3), B = 2, T = 192, 24
condition frames.

  * against JAX's ``fused_residual_stack(start_rows=64, layer_range=(2, 4),
    with_xout=True, interpret=True)``, forward and VJP (as
    tests/test_train_pallas.py:460-570 hold the TPU kernel): f32 within
    1e-5 of each output's and gradient's max (float32 on both sides, sums
    in another order), bf16 within 2e-2 (one-ulp differences of an f32
    value can round a saved activation to the neighbouring bf16 value);
    the rows before the start, which JAX leaves unwritten and its caller
    slices off, are compared through their zero cotangents;
  * the start twin against the stack on the sliced input: exact in f32,
    except dk and drb (within 1e-6), whose row sums run over the
    zero rows too and so in another blocking;
  * two chained groups (layer_range + the stream output) against the whole
    stack, values and gradients.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.config import WavenetConfig as JWavenetConfig
from vqvae_wavenet_tpu.models.wavenet import init_wavenet_params
from vqvae_wavenet_tpu.ops.train_pallas import (
    fused_residual_stack as jax_stack)
from vqvae_wavenet_torch.config import WavenetConfig
from vqvae_wavenet_torch.ops import train_kernels as tk
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import to_torch

set_full_f32()

B, T, FR, C_LC, START = 2, 192, 8, 16, 64
WN = dict(quantization_channels=64, num_cycles=2, num_cycle_layers=2,
          dilation_rates=[1, 2, 1, 2], kernel_size=3, dilation_filters=64,
          skip_filters=128, residual_filters=128, preprocess_kernel_size=8,
          preprocess_filters=128)
TOL = {"f32": 1e-5, "bf16": 2e-2}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def case(seed=3):
    """numpy (layers, x0, lc, w_skip, w_xout) from a seed; nonzero biases
    so every bias path counts; the cotangent weights are zero on the rows
    before START."""
    layers = jax.device_get(init_wavenet_params(
        jax.random.PRNGKey(seed), JWavenetConfig(**WN),
        lc_channels=C_LC)["layers"])
    rng = np.random.default_rng(seed)
    for name in ("bias", "skip_bias", "res_bias"):
        layers[name] = rng.normal(0, 0.05, layers[name].shape).astype(
            np.float32)
    x0 = (rng.standard_normal((B, T, 128)) * 0.3).astype(np.float32)
    lc = (rng.standard_normal((B, T // FR, C_LC)) * 0.3).astype(np.float32)
    ws = (rng.standard_normal((B, T, 128)) * 0.1).astype(np.float32)
    wx = (rng.standard_normal((B, T, 128)) * 0.1).astype(np.float32)
    ws[:, :START] = wx[:, :START] = 0.0
    return layers, x0, lc, ws, wx


def _jax(dtype):
    layers, x0, lc, ws, wx = case()
    jd = DT[dtype][0]
    cfg = JWavenetConfig(**WN)

    def loss(lp, x0, lc):
        skip, xout = jax_stack(lp, cfg, x0, lc, interpret=True,
                               start_rows=jnp.asarray(float(START)),
                               layer_range=(2, 4), with_xout=True, tt_cap=64)
        return (jnp.sum(skip * ws) + jnp.sum(xout.astype(jnp.float32) * wx),
                (skip, xout))
    args = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jd),
                                  (layers, x0, lc))
    (_, (skip, xout)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return jax.device_get((skip, xout, grads))


def _port(dtype, start=START, layer_range=(2, 4)):
    layers, x0, lc, ws, wx = case()
    td = DT[dtype][1]
    lp = {k: v.to(td).requires_grad_(True) for k, v in
          to_torch(layers).items()}
    x0_t = torch.from_numpy(x0).to(td).requires_grad_(True)
    lc_t = torch.from_numpy(lc).to(td).requires_grad_(True)
    skip, xout = tk.fused_residual_stack(
        lp, WavenetConfig(**WN), x0_t, lc_t, start_rows=start,
        layer_range=layer_range, with_xout=True)
    loss = (torch.sum(skip * torch.from_numpy(ws))
            + torch.sum(xout.float() * torch.from_numpy(wx)))
    names = sorted(lp)
    grads = torch.autograd.grad(loss, [lp[k] for k in names] + [x0_t, lc_t])
    return skip.detach(), xout.detach(), dict(zip(names, grads[:-2])), \
        grads[-2], grads[-1]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sp_stack_twins_match_jax(dtype):
    jskip, jxout, (jlp, jdx0, jdlc) = _jax(dtype)
    before = tk.fwd_sp_launches, tk.bwd_sp_launches
    skip, xout, glp, dx0, dlc = _port(dtype)
    assert (tk.fwd_sp_launches, tk.bwd_sp_launches) == before   # CPU: plain
    tol = TOL[dtype]
    assert _rel(skip[:, START:], np.asarray(jskip, np.float32)[:, START:]) \
        < tol
    assert _rel(xout.float()[:, START:],
                np.asarray(jxout, np.float32)[:, START:]) < tol
    for name, g in glp.items():
        assert _rel(g.float(), np.asarray(jlp[name], np.float32)) < tol, name
    assert _rel(dx0.float(), np.asarray(jdx0, np.float32)) < tol
    assert _rel(dlc.float(), np.asarray(jdlc, np.float32)) < tol
    # the rows before the start get exactly zero cotangent on both sides
    assert (dx0[:, :START] == 0).all()
    assert np.all(np.asarray(jdx0, np.float32)[:, :START] == 0)
    assert (dlc[:, :START // FR] == 0).all()


@pytest.mark.parametrize("start", [64, 128])
def test_start_twin_is_the_stack_on_the_sliced_input(start):
    layers, x0, _, _, _ = case()
    rng = np.random.default_rng(start)
    L = 4
    lp = to_torch(layers)
    w = (lp["kernel"], lp["skip_kernel"], lp["res_kernel"], lp["res_bias"])
    lc = torch.from_numpy(rng.normal(0, 0.1, (L, T // FR, B, 128)).astype(
        np.float32))
    dils = tuple(WN["dilation_rates"])
    x0 = torch.from_numpy(x0)
    dskip = torch.from_numpy(rng.normal(0, 0.01, (B, T, 128)).astype(
        np.float32))
    dxout = torch.from_numpy(rng.normal(0, 0.01, (B, T, 128)).astype(
        np.float32))
    got = tk.stack_forward_plain(*w, lc, x0, dils, start=start,
                                 with_xout=True)
    ref = tk.stack_forward_plain(*w, lc[:, start // FR:], x0[:, start:],
                                 dils, with_xout=True)
    for name, a, b in zip(("skip", "act", "xs", "xout"), got, ref):
        if name in ("act", "xs"):             # [L, B, T, .]; xs[0] = x0
            a, b = a[1:] if name == "xs" else a, b[1:] if name == "xs" else b
            assert torch.equal(a[:, :, start:], b), name
            assert (a[:, :, :start] == 0).all(), name
        else:
            assert torch.equal(a[:, start:], b), name
            assert (a[:, :start] == 0).all(), name
    g = tk.stack_backward_plain(dskip, got[1], got[2], *w[:3], dils,
                                T // FR, start=start, dxout=dxout)
    gr = tk.stack_backward_plain(dskip[:, start:], ref[1], ref[2], *w[:3],
                                 dils, (T - start) // FR,
                                 dxout=dxout[:, start:])
    names = ("dk", "dsk", "drs", "drb", "dlc", "dx0")
    for name, a, b in zip(names, g, gr):
        if name == "dlc":
            assert (a[:, :start // FR] == 0).all()
            a = a[:, start // FR:]
        if name == "dx0":
            assert (a[:, :start] == 0).all()
            a = a[:, start:]
        if name in ("dk", "drb"):
            assert _rel(a, b) < 1e-6, name
        else:
            assert torch.equal(a, b), name


def test_chained_groups_equal_the_whole_stack():
    layers, x0, lc, ws, _ = case()
    lp = {k: v.requires_grad_(True) for k, v in to_torch(layers).items()}
    x0_t = torch.from_numpy(x0).requires_grad_(True)
    lc_t = torch.from_numpy(lc)
    cfg = WavenetConfig(**WN)
    w = torch.from_numpy(ws)
    full = tk.fused_residual_stack(lp, cfg, x0_t, lc_t)
    s1, xo = tk.fused_residual_stack(lp, cfg, x0_t, lc_t, layer_range=(0, 2),
                                     with_xout=True)
    s2 = tk.fused_residual_stack(lp, cfg, xo, lc_t, layer_range=(2, 4))
    assert _rel((s1 + s2).detach(), full.detach()) < 1e-6
    leaves = [lp[k] for k in sorted(lp)] + [x0_t]
    gf = torch.autograd.grad(torch.sum(torch.tanh(full) * w), leaves)
    gg = torch.autograd.grad(torch.sum(torch.tanh(s1 + s2) * w), leaves)
    for name, a, b in zip(sorted(lp) + ["x0"], gg, gf):
        assert _rel(a, b) < 1e-5, name


def test_backward_wrapper_refuses_cpu_tensors():
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        tk.stack_backward_cuda(z((1, 8, 8)), z((1, 1, 8, 16)),
                               z((1, 1, 8, 8)), z((1, 3, 8, 16)),
                               z((1, 8, 8)), z((1, 8, 8)), (1,), 1, start=2,
                               dxout=z((1, 8, 8)))
