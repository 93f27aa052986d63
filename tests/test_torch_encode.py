"""Torch port of the generation-time encode (Encoder_64 -> VQ -> speaker
concat) against the JAX package's ``vqvae_encode``.

Tolerance: lc at rtol/atol 1e-4 -- seven float32 convs over 768 channels
sum in another order in XLA and in torch (differences ~1e-6 relative);
code indices must be equal (no near ties with these seeded inputs).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.config import ModelConfig, WavenetConfig
from vqvae_wavenet_tpu.models import vqvae as jvqvae
from vqvae_wavenet_torch.models import vqvae as tvqvae
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import from_jax_tree

set_full_f32()

NUM_SPEAKERS = 5


def tiny_cfg(**kw):
    wn = WavenetConfig(quantization_channels=32, num_cycles=1,
                       num_cycle_layers=3, dilation_rates=[1, 2, 4],
                       kernel_size=2, dilation_filters=8, skip_filters=8,
                       residual_filters=8, preprocess_kernel_size=4,
                       preprocess_filters=8)
    return dataclasses.replace(
        ModelConfig(encoder="64", k=16, latent_dim=8, speaker_embedding=6,
                    wavenet=wn), **kw)


@functools.lru_cache(maxsize=None)
def jax_model(seed=0):
    """init_vqvae with randomized batch-norm parameters and statistics, so
    eval-mode normalization is not the identity (built once; callers do
    not mutate it)."""
    cfg = tiny_cfg()
    params, state = jax.device_get(jax.jit(
        lambda k: jvqvae.init_vqvae(k, cfg, NUM_SPEAKERS))(
            jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for p, s in zip(params["encoder"]["bn"], state["encoder"]["bn"]):
        c = p["scale"].shape[0]
        p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        p["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        s["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return params, state


def inputs(batch=3, t=256, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (batch, t, 1)).astype(np.float32)
    y = np.zeros((batch, 1, NUM_SPEAKERS), np.float32)
    y[0, 0, 2] = 1.0
    y[1, 0, 4] = 1.0          # row 2 stays all-zero: the "None" speaker
    return x, y


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_encode_matches_jax(norm):
    cfg = tiny_cfg(encoder_norm=norm)
    params, state = jax_model()
    x, y = inputs()
    lc_ref, codes_ref = jax.jit(
        lambda p, s, x, y: jvqvae.vqvae_encode(p, s, cfg, x, y))(
            params, state, jnp.asarray(x), jnp.asarray(y))
    tp, ts = from_jax_tree(params, state)
    lc, codes = tvqvae.vqvae_encode(tp, ts, cfg, torch.from_numpy(x),
                                    torch.from_numpy(y))
    assert lc.shape == (3, 4, cfg.latent_dim + cfg.speaker_embedding)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_ref))
    np.testing.assert_allclose(lc.numpy(), np.asarray(lc_ref),
                               rtol=1e-4, atol=1e-4)


def test_none_speaker_picks_embedding_zero():
    cfg = tiny_cfg()
    params, _ = jax_model()
    tp, _ = from_jax_tree(params)
    _, y = inputs()
    h = tvqvae.speaker_vector(tp, cfg, torch.from_numpy(y))
    emb = params["speaker_embedding"]
    np.testing.assert_array_equal(h[:, 0].numpy(), emb[[2, 4, 0]])
    ref = jvqvae.speaker_vector(params, cfg, jnp.asarray(y))
    np.testing.assert_array_equal(h.numpy(), np.asarray(ref))


def test_condition_upsample_matches_jax():
    cfg = tiny_cfg(condition_upsample=True)
    rng = np.random.default_rng(3)
    # build_local_condition reads the speaker table and cond_conv only
    params = {"speaker_embedding": jax_model()[0]["speaker_embedding"],
              "cond_conv": {"kernel": rng.standard_normal(
                  (3, cfg.latent_dim + cfg.speaker_embedding, 128)
              ).astype(np.float32) * 0.1,
                  "bias": rng.standard_normal(128).astype(np.float32)}}
    z_q = rng.standard_normal((2, 4, cfg.latent_dim)).astype(np.float32)
    y = np.zeros((2, 1, NUM_SPEAKERS), np.float32)
    y[0, 0, 1] = 1.0
    ref = jvqvae.build_local_condition(params, cfg, jnp.asarray(z_q),
                                       jnp.asarray(y), train=False,
                                       target_len=256)
    tp, _ = from_jax_tree(params)
    got = tvqvae.build_local_condition(tp, cfg, torch.from_numpy(z_q),
                                       torch.from_numpy(y), target_len=256)
    assert got.shape == (2, 256, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
