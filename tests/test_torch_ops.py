"""Torch port ops against the JAX package: mu-law codec, conv1d, the plain
VQ nearest-code search, and the Philox bits the sampling kernel uses.

Tolerances: float32 elementwise math in two libraries differs by a few
ulp, so float outputs compare at atol 1e-6 (values are O(1)); convs sum
in another order, so they compare at rtol/atol 1e-5; integer outputs
(mu-law bins, code indices) must be equal.  JAX runs at 'highest' matmul
precision (tests/conftest.py) and TF32 is off on the torch side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.ops import conv as jconv
from vqvae_wavenet_tpu.ops import mu_law as jmu
from vqvae_wavenet_tpu.ops.vq_pallas import vq_nearest as jvq_nearest
from vqvae_wavenet_torch.ops import conv as tconv
from vqvae_wavenet_torch.ops import gen_kernels, vq_kernels
from vqvae_wavenet_torch.ops import mu_law as tmu

tconv.set_full_f32()


@pytest.mark.parametrize("q", [256, 32])
def test_mu_law_encode_decode(q):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4000),
                        [-1.0, 0.0, 1.0]]).astype(np.float32)
    f_ref = np.asarray(jmu.mu_law_encode(jnp.asarray(x), q))
    f_got = tmu.mu_law_encode(torch.from_numpy(x), q).numpy()
    np.testing.assert_allclose(f_got, f_ref, atol=1e-6)
    b_ref = np.asarray(jmu.mu_law_encode(jnp.asarray(x), q, to_int=True))
    b_got = tmu.mu_law_encode(torch.from_numpy(x), q, to_int=True).numpy()
    np.testing.assert_array_equal(b_got, b_ref)        # +0.5 rounding kept
    assert b_got.min() == 0 and b_got.max() == q - 1
    bins = np.arange(q, dtype=np.int32)
    d_ref = np.asarray(jmu.mu_law_decode(jnp.asarray(bins), q))
    d_got = tmu.mu_law_decode(torch.from_numpy(bins), q).numpy()
    np.testing.assert_allclose(d_got, d_ref, atol=1e-6)
    assert np.abs(d_got).max() <= 1.0                  # [-1, 1] clip kept


def test_same_padding_is_tf_asymmetric():
    assert tconv.same_padding(256, 5, 2) == (1, 2)     # even T, K=5, s=2
    assert tconv.same_padding(255, 5, 2) == (2, 2)
    assert tconv.same_padding(16, 3, 1) == (1, 1)
    assert tconv.same_padding(4, 1, 1) == (0, 0)


@pytest.mark.parametrize("t,k,stride,padding", [
    (64, 5, 2, "SAME"), (63, 5, 2, "SAME"), (32, 3, 1, "SAME"),
    (32, 1, 1, "VALID"), (33, 4, 2, "VALID")])
def test_conv1d_matches_jax(t, k, stride, padding):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, t, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    ref = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), stride=stride,
                                  padding=padding))
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), stride=stride,
                       padding=padding).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,d", [(384, 512, 64), (37, 16, 4), (5, 3, 256)])
def test_vq_plain_matches_jax(n, k, d):
    rng = np.random.default_rng(2)
    z = rng.standard_normal((n, d)).astype(np.float32)
    e = rng.standard_normal((k, d)).astype(np.float32)
    ref = np.asarray(jvq_nearest(jnp.asarray(z), jnp.asarray(e)))
    before = vq_kernels.launches
    got = vq_kernels.vq_nearest(torch.from_numpy(z), torch.from_numpy(e))
    # exact equality: gaussian data has no near ties at these sizes
    np.testing.assert_array_equal(got.numpy(), ref)
    assert vq_kernels.launches == before       # CPU: no kernel


@pytest.mark.parametrize("pairs", [((100, 300),), ((3, 67), (5, 6))])
def test_vq_exact_tie_goes_to_lowest_index(pairs):
    """Equal codes (exact ties): the plain twin and vq_pallas.vq_nearest
    both return the lower index, as the kernel must (chip_smoke [vq])."""
    rng = np.random.default_rng(4)
    e = rng.standard_normal((512, 64)).astype(np.float32)
    for lo, hi in pairs:
        e[hi] = e[lo]
    lows = np.array([lo for lo, _ in pairs] * 16)
    z = (e[lows] + 1e-3 * rng.standard_normal((lows.size, 64))).astype(
        np.float32)
    ref = np.asarray(jvq_nearest(jnp.asarray(z), jnp.asarray(e)))
    got = vq_kernels.vq_nearest(torch.from_numpy(z), torch.from_numpy(e))
    np.testing.assert_array_equal(ref, lows)
    np.testing.assert_array_equal(got.numpy(), lows)


def test_vq_kernel_wrapper_rejects_cpu_tensors():
    z = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        vq_kernels.vq_nearest_cuda(z, torch.zeros((3, 8)))


def test_philox_known_answers():
    """Philox-4x32-10 known-answer vectors (Random123 kat_vectors)."""
    zero = torch.zeros(1, dtype=torch.int64)
    out = gen_kernels.philox4x32(zero, zero, zero, zero, 0, 0)
    assert [int(v) for v in out] == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                     0x9b00dbd8]
    ones = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    out = gen_kernels.philox4x32(ones, ones, ones, ones, 0xFFFFFFFF,
                                 0xFFFFFFFF)
    assert [int(v) for v in out] == [0x408f276d, 0x41c83b0e, 0xa20bc7c6,
                                     0x6d5451fd]


def test_gumbel_noise_is_deterministic_and_gumbel():
    g = gen_kernels.gumbel_noise(1234, 7, 64, 256)
    np.testing.assert_array_equal(g.numpy(),
                                  gen_kernels.gumbel_noise(1234, 7, 64,
                                                           256).numpy())
    assert not torch.equal(g, gen_kernels.gumbel_noise(1234, 8, 64, 256))
    assert torch.isfinite(g).all()
    # Gumbel(0, 1): mean = Euler-Mascheroni 0.5772, var = pi^2/6 = 1.645;
    # 16k draws give standard errors ~0.01 and ~0.02
    assert abs(float(g.mean()) - 0.5772) < 0.05
    assert abs(float(g.var()) - 1.6449) < 0.1
