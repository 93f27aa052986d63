"""The port's host-side sampling (vqvae_wavenet_torch/utils/sampling.py)
against vqvae_wavenet_tpu/utils/sampling.py on seeded pdfs: the same
generator seed gives the same samples, greedy the same argmax, at Q=256
and 512; an unknown mode raises."""
import numpy as np
import pytest

from vqvae_wavenet_torch.ops.mu_law import mu_law_decode_np
from vqvae_wavenet_torch.utils import sampling
from vqvae_wavenet_tpu.ops.mu_law import mu_law_decode_np as jdecode_np
from vqvae_wavenet_tpu.utils import sampling as jsampling


def pdfs(seed, b, q):
    rng = np.random.default_rng(seed)
    p = rng.random((b, q)).astype(np.float32) ** 8   # a few peaked bins
    return p / p.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("q", [256, 512])
@pytest.mark.parametrize("mode", ["sample", "greedy"])
def test_decode_matches_jax(mode, q):
    p = pdfs(q + len(mode), 64, q)
    got = sampling.decode(p, mode, q, rng=np.random.default_rng(5))
    ref = jsampling.decode(p, mode, q, rng=np.random.default_rng(5))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_sample_follows_the_pdf():
    p = np.zeros((4096, 256), np.float32)
    p[:, 10], p[:, 200] = 0.25, 0.75
    got = sampling.sample(p, rng=np.random.default_rng(0))
    assert set(np.unique(got)) == set(mu_law_decode_np([10, 200]))
    assert abs((got < 0).mean() - 0.25) < 0.03


def test_mu_law_decode_np_matches_jax():
    bins = np.arange(512)
    np.testing.assert_array_equal(mu_law_decode_np(bins, 512),
                                  jdecode_np(bins, 512))


def test_unknown_mode_raises():
    with pytest.raises(NotImplementedError):
        sampling.decode(np.ones((1, 256)) / 256, mode="banana")
