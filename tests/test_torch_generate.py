"""Torch port of whole-clip generation against the JAX package (plain
path; the CUDA kernel is compared with the same plain path on the card by
chip_smoke.py).

Tolerances: float32 logits at rtol/atol 1e-4 (the port sums the taps, the
current and lc in one fused dot, the JAX step in separate dots -- ~1e-6
apart); greedy waveforms at atol 1e-6, far below the smallest mu-law step
(~8.5e-5 around 0), so they assert identical bins; packed weights equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2 as chi2_dist

from vqvae_wavenet_tpu.config import WavenetConfig
from vqvae_wavenet_tpu.generation import fast as jfast
from vqvae_wavenet_tpu.models.wavenet import init_wavenet_params
from vqvae_wavenet_tpu.ops import gen_pallas
from vqvae_wavenet_torch.generation import fast as tfast
from vqvae_wavenet_torch.ops import gen_kernels
from vqvae_wavenet_torch.params import to_torch


def tiny_cfg(**kw):
    base = dict(quantization_channels=32, num_cycles=2, num_cycle_layers=3,
                dilation_rates=[1, 2, 4, 1, 2, 4], kernel_size=3,
                dilation_filters=8, skip_filters=12, residual_filters=10,
                preprocess_kernel_size=4, preprocess_filters=10)
    base.update(kw)
    return WavenetConfig(**base)


def model(cfg, c_lc=5, c_gc=None, seed=0):
    p = jax.device_get(init_wavenet_params(jax.random.PRNGKey(seed), cfg,
                                           c_lc, c_gc))
    # nonzero biases so every bias path is exercised
    rng = np.random.default_rng(seed)
    for k in ("bias", "skip_bias", "res_bias"):
        p["layers"][k] = rng.normal(0, 0.1, p["layers"][k].shape
                                    ).astype(np.float32)
    return p


def conditions(b, t_cond, c_lc=5, c_gc=None, seed=1):
    rng = np.random.default_rng(seed)
    lc = rng.standard_normal((b, t_cond, c_lc)).astype(np.float32)
    gc = (None if c_gc is None
          else rng.standard_normal((b, 1, c_gc)).astype(np.float32))
    return lc, gc


def test_teacher_forced_logits_match_jax():
    cfg = tiny_cfg()
    p = model(cfg)
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.9, 0.9, (2, 40, 1)).astype(np.float32)
    lc, _ = conditions(2, 5)
    ref = np.asarray(jfast.teacher_forced_stepper(
        jax.tree_util.tree_map(jnp.asarray, p), cfg, jnp.asarray(x),
        jnp.asarray(lc)))
    got = tfast.teacher_forced_stepper(to_torch(p), cfg, torch.from_numpy(x),
                                       torch.from_numpy(lc))
    assert got.shape == (2, 40, cfg.quantization_channels)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel_size,gate_order,c_gc,length", [
    (3, "tanh_first", None, 64),      # ring wraps: 64 > (K-1)*4 = 8
    (2, "sigmoid_first", 3, 48),      # the gc path, Magenta gate order
])
def test_greedy_generate_matches_jax(kernel_size, gate_order, c_gc, length):
    cfg = tiny_cfg(kernel_size=kernel_size)
    p = model(cfg, c_gc=c_gc)
    lc, gc = conditions(2, 4, c_gc=c_gc)
    ref = np.asarray(jfast.generate(
        p, cfg, jnp.asarray(lc), length=length, mode="greedy",
        gate_order=gate_order, engine="xla",
        global_condition=None if gc is None else jnp.asarray(gc)))
    before = gen_kernels.launches
    got = tfast.generate(
        to_torch(p), cfg, torch.from_numpy(lc), length=length, mode="greedy",
        gate_order=gate_order,
        global_condition=None if gc is None else torch.from_numpy(gc))
    assert length > (cfg.kernel_size - 1) * cfg.max_dilation
    assert got.shape == (2, length)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    assert gen_kernels.launches == before      # CPU: plain path


def test_sample_mode_follows_softmax():
    """Gumbel-max over the Philox bits draws from softmax(logits):
    chi-square over 20,000 rows sharing one logit vector (the method of
    tests/test_gen_pallas.py:357)."""
    q, n = 32, 20000
    logits = torch.from_numpy(
        np.random.default_rng(4).normal(0, 1.5, q).astype(np.float32))
    bins = gen_kernels.select_bins(logits.expand(n, q).contiguous(),
                                   "sample", seed=99, step=0)
    counts = np.bincount(bins.numpy(), minlength=q)
    p = torch.softmax(logits.double(), 0).numpy()
    exp = p * n
    small = exp < 5           # merge bins with tiny expected counts
    obs_g = np.append(counts[~small], counts[small].sum())
    exp_g = np.append(exp[~small], exp[small].sum())
    keep = exp_g > 0
    obs_g, exp_g = obs_g[keep], exp_g[keep]
    chi2 = float(((obs_g - exp_g) ** 2 / exp_g).sum())
    assert chi2 < chi2_dist.ppf(0.999, len(obs_g) - 1), chi2


def test_sample_generate_is_seeded():
    cfg = tiny_cfg()
    p = to_torch(model(cfg))
    lc = torch.from_numpy(conditions(2, 4)[0])

    def run(seed):
        return tfast.generate(p, cfg, lc, length=32, mode="sample",
                              generator=torch.Generator().manual_seed(seed))

    a, b = run(0), run(0)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(1))
    assert torch.isfinite(a).all() and a.abs().max() <= 1.0


def test_packing_matches_pallas_layout():
    cfg = WavenetConfig(quantization_channels=256, num_cycles=1,
                        num_cycle_layers=4, dilation_rates=[1, 2, 4, 8],
                        kernel_size=3, dilation_filters=64, skip_filters=128,
                        residual_filters=128, preprocess_kernel_size=8,
                        preprocess_filters=128)
    c = 128
    p = model(cfg, c_lc=c)
    a, _, sr, _, small = jax.device_get(gen_pallas._pack_jit(
        p, cfg=cfg, lc_channels=c, dtype=jnp.float32))
    lay = gen_pallas._layout(cfg, c)
    w = gen_kernels.pack_gen_params(to_torch(p), cfg, torch.float32)
    D, S = cfg.dilation_filters, cfg.skip_filters
    # taps + lc as one [K*R + C, 2D] block, stored transposed
    np.testing.assert_array_equal(w.w_a.transpose(1, 2).numpy(),
                                  a[:, :lay["off_skip"], :2 * D])
    np.testing.assert_array_equal(w.b_a.numpy(), a[:, lay["off_bias"], :2 * D])
    # [skip | res] as one [D, S + R] block, stored transposed
    np.testing.assert_array_equal(w.w_sr.transpose(1, 2).numpy(), sr[:, :D])
    np.testing.assert_array_equal(w.b_sr.numpy(), sr[:, lay["off_res_bias"]])
    np.testing.assert_array_equal(w.w_pre.T.numpy(), small["w_pre"])
    np.testing.assert_array_equal(w.w_ss.T.numpy(), small["w_ss"])
    np.testing.assert_array_equal(
        w.w_h1.T.numpy(), np.concatenate([small["w_pp1"], small["w_pp1_lc"]]))
    np.testing.assert_array_equal(w.w_pp2.T.numpy(), small["w_pp2"])
    np.testing.assert_array_equal(w.b_pp2.numpy(), small["b_pp2"][0])
    assert w.dims == (4, 3, 128, 64, S, 256, c, 8)


def test_kernel_wrapper_rejects_cpu_weights():
    cfg = tiny_cfg()
    w = gen_kernels.pack_gen_params(to_torch(model(cfg)), cfg)
    gcon, g_pp1 = gen_kernels.condition_terms({"layers": {},
                                               "postprocess1": {}}, w, 1)
    with pytest.raises(ValueError, match="CUDA"):
        gen_kernels.generate_clip_cuda(w, torch.zeros((1, 4, 5)), gcon,
                                       g_pp1, length=8)
    # the stamped build (a measurement of chip_smoke.py) refuses them too
    with pytest.raises(ValueError, match="CUDA"):
        gen_kernels.generate_clip_stamped(w, torch.zeros((1, 4, 5)), gcon,
                                          g_pp1, length=8, stamp_from=0,
                                          stamp_samples=4)
