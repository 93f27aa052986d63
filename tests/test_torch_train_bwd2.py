"""The two-kernel stack backward of the port (``BWD_FUSED_DK = "off"``: the
chain, then dk for every layer; csrc/train_stack_bwd2.cu on the card)
against the JAX package, on the CPU, where its plain twins run.

The twins are driven through the port's teacher-forced WaveNet
(``fused_residual_stack`` -> ``_Stack``) with the switch set to "off", and
held against ``jax.grad`` of JAX's ``wavenet_logits(engine="xla")`` on
the tiny config of tests/test_train_pallas.py:22-28 (B=2, T=128) and its
ring config (:191-196: a dilation of 384 > T/2, so a tap offset of 768
rows; B=2, T=1,024).

Tolerances.  f32: the loss within 1e-5 and every gradient leaf within
max|delta| / max|ref| < 1e-4 (both sides float32 at full precision, only
the summation order differs).  bf16: every gradient leaf no further from
the f32 reference than twice JAX's own bf16 XLA gradient is, plus 1e-3 of
the leaf's largest |value| (the rule tests/test_torch_train_stack.py
applies to B5's bf16 logits, here on the gradients).  Against the layer
sweep (B5's twin) on the same inputs, each output within 1e-5 of its
largest |value| in f32 (they round at the same points).
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
from vqvae_wavenet_torch.ops import train_kernels as tk
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import to_torch

set_full_f32()


def tiny_cfg():
    return WavenetConfig(
        quantization_channels=256, num_cycles=1, num_cycle_layers=4,
        dilation_rates=[1, 2, 4, 8], kernel_size=3, dilation_filters=64,
        skip_filters=128, residual_filters=128, preprocess_kernel_size=8,
        preprocess_filters=128)


def ring_cfg():
    return WavenetConfig(
        quantization_channels=256, num_cycles=1, num_cycle_layers=4,
        dilation_rates=[1, 2, 4, 384], kernel_size=3, dilation_filters=64,
        skip_filters=128, residual_filters=128, preprocess_kernel_size=8,
        preprocess_filters=128)


CFGS = {"tiny": (tiny_cfg, 128, 16), "ring": (ring_cfg, 1024, 128)}
B, C_LC = 2, 128


@functools.lru_cache(maxsize=None)
def case(name, seed):
    """numpy (cfg, params, x, lc, w) from a seed (built once, not
    mutated): nonzero biases, so every bias gradient path is exercised."""
    make, T, t_cond = CFGS[name]
    cfg = make()
    params = jax.device_get(init_wavenet_params(
        jax.random.PRNGKey(seed), cfg, lc_channels=C_LC))
    rng = np.random.default_rng(seed)
    for n in ("bias", "skip_bias", "res_bias"):
        params["layers"][n] = rng.normal(
            0, 0.05, params["layers"][n].shape).astype(np.float32)
    x = rng.uniform(-0.9, 0.9, (B, T, 1)).astype(np.float32)
    lc = (rng.standard_normal((B, t_cond, C_LC)) * 0.3).astype(np.float32)
    w = (rng.standard_normal(256) * 0.1).astype(np.float32)
    return cfg, params, x, lc, w


@functools.lru_cache(maxsize=None)
def jax_grads(name, seed, dtype):
    cfg, params, x, lc, w = case(name, seed)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32

    def loss(p):
        p = jax.tree_util.tree_map(lambda v: v.astype(jd), p)
        out = jlogits(p, cfg, jnp.asarray(x, jd), jnp.asarray(lc, jd),
                      engine="xla")
        return jnp.mean(jnp.tanh(out.astype(jnp.float32)) * jnp.asarray(w))
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), jax.device_get(grads)


def port_grads(name, seed, dtype):
    """(loss, {path: gradient}) of the port on the same inputs, f32 master
    leaves cast to the compute type inside the graph."""
    cfg, params, x, lc, w = case(name, seed)
    cd = torch.bfloat16 if dtype == "bf16" else torch.float32
    tp = to_torch(params)
    leaves, paths = [], []
    for grp, d in tp.items():
        for k, v in d.items():
            v.requires_grad_(True)
            leaves.append(v)
            paths.append((grp, k))
    p16 = {grp: {k: v.to(cd) for k, v in d.items()} for grp, d in tp.items()}
    out = tlogits(p16, cfg, torch.from_numpy(x).to(cd),
                  torch.from_numpy(lc).to(cd))
    loss = torch.mean(torch.tanh(out.float()) * torch.from_numpy(w))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(paths, grads))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.fixture
def off(monkeypatch):
    monkeypatch.setattr(tk, "BWD_FUSED_DK", "off")
    calls = {"sweep": 0, "chain": 0, "dk": 0}
    for key, name in (("sweep", "stack_backward_plain"),
                      ("chain", "stack_bwd_chain_plain"),
                      ("dk", "stack_dk_plain")):
        fn = getattr(tk, name)

        def spy(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tk, name, spy)
    return calls


@pytest.mark.parametrize("name,seed", [("tiny", 5), ("ring", 21)])
def test_two_kernel_f32_matches_jax(off, name, seed):
    ref_loss, ref = jax_grads(name, seed, "f32")
    loss, grads = port_grads(name, seed, "f32")
    assert off == {"sweep": 0, "chain": 1, "dk": 1}
    assert abs(loss - ref_loss) < 1e-5
    for (grp, k), g in grads.items():
        assert rel(g.numpy(), ref[grp][k]) < 1e-4, (grp, k)


@pytest.mark.parametrize("name,seed", [("tiny", 6), ("ring", 22)])
def test_two_kernel_bf16_tracks_f32_reference(off, name, seed):
    _, ref32 = jax_grads(name, seed, "f32")
    _, ref16 = jax_grads(name, seed, "bf16")
    _, grads = port_grads(name, seed, "bf16")
    assert off == {"sweep": 0, "chain": 1, "dk": 1}
    for (grp, k), g in grads.items():
        r32 = np.asarray(ref32[grp][k], np.float64)
        jerr = np.abs(np.asarray(ref16[grp][k], np.float64) - r32).max()
        err = np.abs(g.double().numpy() - r32).max()
        assert err <= 2 * jerr + 1e-3 * np.abs(r32).max(), (grp, k, err,
                                                            jerr)


def stack_case(seed, dtype=torch.float32, L=4, K=2, R=16, D=8, S=24, T=64,
               F=8, dils=(1, 2, 32, 64)):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=0.3):
        return (torch.randn(shape, generator=g) * s).to(dtype)
    w = (rnd(L, K, R, 2 * D), rnd(L, D, S), rnd(L, D, R), rnd(L, R, s=0.1),
         torch.randn((L, F, B, 2 * D), generator=g))
    x0, dskip = rnd(B, T, R, s=1.0), rnd(B, T, S, s=1.0)
    return w, x0, dskip, dils, F


@pytest.mark.parametrize("gate_order", ["tanh_first", "sigmoid_first"])
def test_twins_equal_the_sweep(gate_order):
    w, x0, dskip, dils, F = stack_case(3)
    _, act, xs = tk.stack_forward_plain(*w, x0, dils, gate_order)
    args = (dskip, act, xs, w[0], w[1], w[2], dils, F, gate_order)
    sweep = tk.stack_backward_plain(*args)
    chain = tk.stack_bwd_chain_plain(*args)
    assert chain[0].shape == act.shape and chain[0].dtype == act.dtype
    dk = tk.stack_dk_plain(chain[0], xs, dils, w[0].shape[1])
    assert dk.dtype == torch.float32
    for name, a, b in zip(("dk", "dsk", "drs", "drb", "dlc", "dx0"),
                          (dk,) + tuple(chain[1:]), sweep):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert rel(a.double().numpy(), b.double().numpy()) <= 1e-5, name


def test_dk_reads_zero_before_each_batch_row():
    """A tap offset o reads zero for t < o of every batch row: a layer
    input that is zero except the last row of batch row 0 gives the tap
    with o > 0 nothing from it, however dpre looks."""
    L, B_, T, R, D2 = 1, 2, 16, 8, 16
    xs = torch.zeros((L, B_, T, R))
    xs[0, 0, -1] = 1.0
    dpre = torch.ones((L, B_, T, D2))
    dk = tk.stack_dk_plain(dpre, xs, (4,), 2)
    assert float(dk[0, 0].abs().max()) == 0.0       # o = 4: no row t - 4
    assert float(dk[0, 1].abs().max()) == 1.0       # o = 0: the row itself


def test_dk_twin_matches_jax_kernel_with_a_tap_past_t():
    """The dk twin against the JAX package's dW kernel
    (train_pallas._make_dk_kernel, interpret mode) at the edge the CUDA
    kernel is held to on the card: dilation 40 at K=3 shifts tap 0 by 80
    rows, more than T = 64, so that tap reads only zeros; three batch
    rows.  f32 on both sides: within 1e-5 of the largest |dk|."""
    from vqvae_wavenet_tpu.ops import train_pallas
    L, K, R, D, B_, T = 2, 3, 8, 8, 3, 64
    dils = (1, 40)
    rng = np.random.default_rng(17)
    dpre = rng.standard_normal((L, B_, T, 2 * D)).astype(np.float32)
    xs = rng.standard_normal((L, B_, T, R)).astype(np.float32)
    ref = np.asarray(train_pallas._make_dk_kernel(
        L, K, R, D, 16, dils, B_, T, "f32", True)(jnp.asarray(dpre),
                                                   jnp.asarray(xs)))
    got = tk.stack_dk_plain(torch.from_numpy(dpre), torch.from_numpy(xs),
                            dils, K).numpy()
    assert got.shape == ref.shape == (L, K, R, 2 * D)
    assert float(np.abs(got[1, 0]).max()) == 0.0
    assert rel(got, ref) <= 1e-5


def test_dk_twin_on_ragged_rows():
    """T = 100 (not a multiple of a 64-row tile), three batch rows, tap
    offsets 0, 37, 74 and 120 (> T): the twin against a float64 sum over
    rows t >= o of each batch row."""
    L, K, R, D2, B_, T = 2, 3, 8, 16, 3, 100
    dils = (37, 60)
    rng = np.random.default_rng(18)
    dpre = rng.standard_normal((L, B_, T, D2))
    xs = rng.standard_normal((L, B_, T, R))
    ref = np.zeros((L, K, R, D2))
    for l, d in enumerate(dils):
        for j in range(K):
            o = (K - 1 - j) * d
            for t in range(o, T):
                ref[l, j] += xs[l, :, t - o].T @ dpre[l, :, t]
    got = tk.stack_dk_plain(torch.from_numpy(dpre).float(),
                            torch.from_numpy(xs).float(), dils, K).numpy()
    assert float(np.abs(got[1, 0]).max()) == 0.0
    assert rel(got, ref) <= 1e-5


@pytest.mark.parametrize("variant", ["start", "xout"])
def test_sp_calls_take_the_sweep_under_off(off, variant):
    """As in JAX (train_pallas.py:1561-1566), a call with start > 0 or a
    stream-output cotangent takes the layer sweep whatever the switch."""
    cfg, params, x, lc, _ = case("tiny", 5)
    lp = {k: v.requires_grad_(True) for k, v in
          to_torch(params["layers"]).items()}
    x0 = torch.randn((B, 128, cfg.residual_filters), generator=torch.
                     Generator().manual_seed(1))
    lcond = torch.from_numpy(lc)
    if variant == "start":
        out = tk.fused_residual_stack(lp, cfg, x0, lcond, start_rows=32)
        loss = out.square().mean()
    else:
        skip, xout = tk.fused_residual_stack(lp, cfg, x0, lcond,
                                             with_xout=True)
        loss = skip.square().mean() + xout.square().mean()
    torch.autograd.grad(loss, list(lp.values()), allow_unused=True)
    assert off == {"sweep": 1, "chain": 0, "dk": 0}


def test_switch_refuses_other_values(monkeypatch):
    monkeypatch.setattr(tk, "BWD_FUSED_DK", "on")
    w, x0, dskip, dils, F = stack_case(4)
    kernel = w[0].clone().requires_grad_(True)
    out = tk._Stack.apply(kernel, w[1], w[2], w[3], w[4], x0, dils,
                          "tanh_first", 0, False)
    with pytest.raises(ValueError, match="BWD_FUSED_DK"):
        torch.autograd.grad(out.sum(), kernel)


def test_kernel_wrappers_refuse_cpu_tensors():
    w, x0, dskip, dils, F = stack_case(5)
    _, act, xs = tk.stack_forward_plain(*w, x0, dils)
    with pytest.raises(ValueError, match="CUDA"):
        tk.stack_bwd_chain_cuda(dskip, act, xs, w[0], w[1], w[2], dils, F)
    with pytest.raises(ValueError, match="CUDA"):
        tk.stack_dk_cuda(act, xs, dils, 2)
