"""int8-weight generation of the torch port (the TPU kernel's int8 mode,
vqvae_wavenet_tpu/ops/gen_pallas.py:104-159, 584-588) against the JAX
package, on the plain path (the CUDA kernel is held to the same plain path
on the card by chip_smoke.py).

Tolerances: the quantizer is bit-identical (int8 bytes and float32
scales); the int8 plain path equals the bf16 plain path on the weights
JAX dequantizes, bit for bit; against JAX's float32 step on those weights,
logits within 5e-2 * max(1, max|logit|) (bf16 activations round where the
f32 step does not); greedy samples 0-3 within 0.05 of an f32 clip, the
bound tests/test_gen_pallas.py:378-391 holds the TPU kernel to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.config import WavenetConfig
from vqvae_wavenet_tpu.generation import fast as jfast
from vqvae_wavenet_tpu.models.wavenet import init_wavenet_params
from vqvae_wavenet_tpu.ops import gen_pallas
from vqvae_wavenet_torch.ops import gen_kernels as gk
from vqvae_wavenet_torch.params import to_torch

C_LC = 128


def tiny_cfg():
    """The widths of tests/test_gen_pallas.py::tiny_cfg."""
    return WavenetConfig(
        quantization_channels=256, num_cycles=1, num_cycle_layers=4,
        dilation_rates=[1, 2, 4, 8], kernel_size=3, dilation_filters=64,
        skip_filters=128, residual_filters=128, preprocess_kernel_size=8,
        preprocess_filters=128)


def model(cfg, seed=0):
    """JAX-initialised decoder with random biases and one all-zero lc row
    (its scale must be 1.0)."""
    p = jax.device_get(init_wavenet_params(jax.random.PRNGKey(seed), cfg,
                                           C_LC))
    rng = np.random.default_rng(seed)
    for k in ("bias", "skip_bias", "res_bias"):
        p["layers"][k] = rng.normal(0, 0.1, p["layers"][k].shape
                                    ).astype(np.float32)
    p["layers"]["lc_kernel"] = np.array(p["layers"]["lc_kernel"])
    p["layers"]["lc_kernel"][1, 5] = 0.0
    return p


def jax_int8(p, cfg):
    """JAX's int8 pack: (streamed block a, its row scales, its layout)."""
    a, _, scales, _ = jax.device_get(gen_pallas.pack_gen_params(
        jax.tree_util.tree_map(jnp.asarray, p), cfg, C_LC, dtype=jnp.int8))
    return a, scales[..., 0], gen_pallas._layout(cfg, C_LC)


def dequantized_tree(p, cfg):
    """The decoder tree with the int8-quantized leaves replaced by the
    bf16 weights the TPU kernel computes with (gen_pallas.py:584-588),
    dequantized by JAX, as float32."""
    a, scales, lay = jax_int8(p, cfg)
    deq = np.asarray((jnp.asarray(a).astype(jnp.bfloat16)
                      * jnp.asarray(scales)[..., None].astype(jnp.bfloat16)
                      ).astype(jnp.float32))
    L, K, R = cfg.num_layers, cfg.kernel_size, cfg.residual_filters
    D, S = cfg.dilation_filters, cfg.skip_filters
    lp = dict(p["layers"])
    lp["kernel"] = deq[:, :K * R, :2 * D].reshape(L, K, R, 2 * D)
    lp["lc_kernel"] = deq[:, lay["off_lc"]:lay["off_lc"] + C_LC, :2 * D]
    lp["skip_kernel"] = deq[:, lay["off_skip"]:lay["off_skip"] + D, :S]
    lp["bias"] = deq[:, lay["off_bias"], :2 * D]
    lp["skip_bias"] = deq[:, lay["off_skip_bias"], :S]
    # what stays bf16 (gen_pallas.py:133-158)
    bf = jax.tree_util.tree_map(
        lambda v: np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(
            jnp.float32)), {k: v for k, v in p.items() if k != "layers"})
    for k in ("res_kernel", "res_bias"):
        lp[k] = np.asarray(jnp.asarray(lp[k]).astype(jnp.bfloat16).astype(
            jnp.float32))
    return {**bf, "layers": lp}


def forced_inputs(b, t, seed=2):
    x = np.random.default_rng(seed).uniform(-0.9, 0.9, (b, t, 1)
                                            ).astype(np.float32)
    forced = np.concatenate([np.zeros((b, 1), np.float32), x[:, :-1, 0]], 1)
    return x, torch.from_numpy(forced)


def lc_inputs(b, t_cond, seed=1):
    return (np.random.default_rng(seed).standard_normal((b, t_cond, C_LC))
            * 0.3).astype(np.float32)


def test_quantizer_matches_jax():
    cfg = tiny_cfg()
    p = model(cfg)
    a, scales, lay = jax_int8(p, cfg)
    L, K, R = cfg.num_layers, cfg.kernel_size, cfg.residual_filters
    D, S = cfg.dilation_filters, cfg.skip_filters
    tp = to_torch(p)
    lp = tp["layers"]
    rows = {  # JAX row block -> the port's quantizer input
        "taps": (slice(0, K * R), 2 * D, lp["kernel"].reshape(L, K * R, 2 * D)),
        "lc": (slice(lay["off_lc"], lay["off_lc"] + C_LC), 2 * D,
               lp["lc_kernel"]),
        "skip": (slice(lay["off_skip"], lay["off_skip"] + D), S,
                 lp["skip_kernel"]),
        "bias": (slice(lay["off_bias"], lay["off_bias"] + 1), 2 * D,
                 lp["bias"][:, None]),
        "skip_bias": (slice(lay["off_skip_bias"], lay["off_skip_bias"] + 1),
                      S, lp["skip_bias"][:, None]),
    }
    for name, (sl, cols, w) in rows.items():
        q, s = gk.quantize_rows(w)
        np.testing.assert_array_equal(q.numpy(), a[:, sl, :cols], err_msg=name)
        np.testing.assert_array_equal(s.numpy(), scales[:, sl], err_msg=name)
    assert scales[1, lay["off_lc"] + 5] == 1.0          # the zero row

    # the packed kernel operands carry those bytes and bf16(scale)s
    w = gk.pack_gen_params(tp, cfg, torch.int8)
    assert w.quantized and w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.w_a.transpose(1, 2).numpy(),
                                  a[:, :lay["off_skip"], :2 * D])
    np.testing.assert_array_equal(
        w.w_sr.transpose(1, 2).numpy(),
        a[:, lay["off_skip"]:lay["off_skip"] + D, :S])
    bf = torch.bfloat16
    np.testing.assert_array_equal(
        w.s_a.numpy(), torch.tensor(scales[:, :lay["off_skip"]]
                                    ).to(bf).float().numpy())
    np.testing.assert_array_equal(
        w.s_s.numpy(), torch.tensor(
            scales[:, lay["off_skip"]:lay["off_skip"] + D]).to(bf).float()
        .numpy())
    assert w.w_r.dtype == bf and tuple(w.w_r.shape) == (L, R, D)


def test_int8_plain_equals_bf16_on_dequantized_weights():
    """Bit for bit: the int8 plain path == the bf16 plain path packed from
    the weights JAX dequantizes."""
    cfg = tiny_cfg()
    p = model(cfg)
    x, forced = forced_inputs(2, 24)
    lc = torch.from_numpy(lc_inputs(2, 3))
    kw = dict(length=24, forced=forced, want_logits=True)
    w8 = gk.pack_gen_params(to_torch(p), cfg, torch.int8)
    g8 = gk.condition_terms(to_torch(p), w8, 2)
    _, l8 = gk.generate_clip_plain(w8, lc, *g8, **kw)
    deq = to_torch(dequantized_tree(p, cfg))
    wb = gk.pack_gen_params(deq, cfg, torch.bfloat16)
    gb = gk.condition_terms(deq, wb, 2)
    _, lb = gk.generate_clip_plain(wb, lc, *gb, **kw)
    assert torch.equal(l8, lb)
    assert torch.equal(w8.dequantized().w_a, wb.w_a)
    assert torch.equal(w8.dequantized().w_sr, wb.w_sr)


def test_int8_plain_close_to_jax_f32_step():
    cfg = tiny_cfg()
    p = model(cfg)
    x, forced = forced_inputs(2, 32)
    lc = lc_inputs(2, 4)
    deq = dequantized_tree(p, cfg)
    ref = np.asarray(jfast.teacher_forced_stepper(
        jax.tree_util.tree_map(jnp.asarray, deq), cfg, jnp.asarray(x),
        jnp.asarray(lc)))
    w8 = gk.pack_gen_params(to_torch(p), cfg, torch.int8)
    _, got = gk.generate_clip_plain(
        w8, torch.from_numpy(lc), *gk.condition_terms(to_torch(p), w8, 2),
        length=32, forced=forced, want_logits=True)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got.numpy() - ref).max()) <= 5e-2 * scale


def test_int8_greedy_tracks_f32_early():
    cfg = tiny_cfg()
    p = model(cfg)
    lc = lc_inputs(1, 4)
    ref = np.asarray(jfast.generate(
        jax.tree_util.tree_map(jnp.asarray, p), cfg, jnp.asarray(lc),
        length=16, mode="greedy", engine="xla"))
    before = gk.int8_launches
    from vqvae_wavenet_torch.generation import fast as tfast
    got = tfast.generate(to_torch(p), cfg, torch.from_numpy(lc), length=16,
                         mode="greedy", dtype=torch.int8).numpy()
    assert got.shape == ref.shape == (1, 16)
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0
    assert np.abs(got[:, :4] - ref[:, :4]).max() < 0.05
    assert gk.int8_launches == before          # CPU: the plain twin


def test_pk_padding_leaves_plain_result_unchanged():
    """Magenta's startconv has PK=2: packing pads w_pre with zero columns
    for the oldest window slots up to 8; the unpadded weights give the
    same logits."""
    cfg = dataclasses.replace(tiny_cfg(), kernel_size=2,
                              preprocess_kernel_size=2)
    p = model(cfg)
    w = gk.pack_gen_params(to_torch(p), cfg, torch.float32)
    assert w.dims[-1] == 8 and not w.w_pre[:, :6].any()
    w2 = dataclasses.replace(w, w_pre=w.w_pre[:, 6:].contiguous())
    assert w2.dims[-1] == 2
    _, forced = forced_inputs(2, 20)
    lc = torch.from_numpy(lc_inputs(2, 4))
    g = gk.condition_terms(to_torch(p), w, 2)
    kw = dict(length=20, forced=forced, want_logits=True)
    _, a = gk.generate_clip_plain(w, lc, *g, **kw)
    _, b = gk.generate_clip_plain(w2, lc, *g, **kw)
    assert torch.equal(a, b)


def test_int8_kernel_wrapper_rejects_cpu_weights():
    cfg = tiny_cfg()
    w = gk.pack_gen_params(to_torch(model(cfg)), cfg, torch.int8)
    gcon, g_pp1 = gk.condition_terms({"layers": {}, "postprocess1": {}}, w, 1)
    assert gcon.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="CUDA"):
        gk.generate_clip_cuda(w, torch.zeros((1, 4, C_LC)), gcon, g_pp1,
                              length=8)
