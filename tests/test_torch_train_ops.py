"""The port's training ops against the JAX package: shift_right,
causal_conv1d, add_condition, the piecewise learning-rate schedule and the
fused Adam + EMA step.

Tolerances: the convs and the condition projection sum in another order
in torch and XLA, so float32 outputs compare at rtol 1e-6 with an atol of
1e-6 for values near zero; the optimizer's algebra is the same op for op,
so three steps stay within 1e-6 relative (the bias corrections are both
float32 powers, which may differ by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae_wavenet_tpu.ops import conv as jconv
from vqvae_wavenet_tpu.training import optimizer as jopt
from vqvae_wavenet_torch.ops import conv as tconv
from vqvae_wavenet_torch.training import optimizer as topt

tconv.set_full_f32()


def test_shift_right_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 3)).astype(
        np.float32)
    got = tconv.shift_right(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jconv.shift_right(
        jnp.asarray(x))))
    assert (got[:, 0] == 0).all()


@pytest.mark.parametrize("dilation", [1, 4])
def test_causal_conv1d_matches_jax(dilation):
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    w = rng.standard_normal((3, 6, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    ref = np.asarray(jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), dilation=dilation))
    got = tconv.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), dilation=dilation).numpy()
    assert got.shape == ref.shape == (2, 40, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_add_condition_matches_jax():
    rng = np.random.default_rng(3)
    net = rng.standard_normal((2, 32, 7)).astype(np.float32)
    cond = rng.standard_normal((2, 4, 5)).astype(np.float32)
    k = rng.standard_normal((5, 7)).astype(np.float32)
    ref = np.asarray(jconv.add_condition(jnp.asarray(net), jnp.asarray(cond),
                                         jnp.asarray(k)))
    got = tconv.add_condition(torch.from_numpy(net), torch.from_numpy(cond),
                              torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_piecewise_schedule_matches_jax():
    """Unsorted dict, boundaries, before the first and far past the last
    (tests/test_training.py:38-51)."""
    sched = {200: 4e-5, 0: 8e-5, 100: 6e-5}
    ref = jopt.piecewise_constant_schedule(sched)
    got = topt.piecewise_constant_schedule(sched)
    for step in (0, 99, 100, 150, 200, 10_000_000):
        assert got(step) == float(ref(step))
    assert got(99) == pytest.approx(8e-5) and got(200) == pytest.approx(4e-5)
    late = topt.piecewise_constant_schedule({5: 1e-3, 9: 5e-4})
    assert late(0) == pytest.approx(1e-3)            # clipped to the first


def test_fused_adam_ema_matches_jax():
    """Three steps fed the same numpy gradients, crossing a schedule
    boundary: params, ema, m, v and count."""
    rng = np.random.default_rng(4)
    shapes = {"w": (16, 8), "b": {"c": (8,)}}
    params = {"w": rng.standard_normal(shapes["w"]).astype(np.float32),
              "b": {"c": np.full(8, 0.3, np.float32)}}
    sched = {0: 1e-3, 2: 5e-4}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    je = jax.tree_util.tree_map(jnp.asarray, params)
    js = optax.adam(jopt.piecewise_constant_schedule(sched)).init(jp)
    tp = {"w": torch.from_numpy(params["w"]),
          "b": {"c": torch.from_numpy(params["b"]["c"])}}
    te = {"w": tp["w"].clone(), "b": {"c": tp["b"]["c"].clone()}}
    ts = {"mu": {"w": torch.zeros(16, 8), "b": {"c": torch.zeros(8)}},
          "nu": {"w": torch.zeros(16, 8), "b": {"c": torch.zeros(8)}},
          "count": 0}
    tsched = topt.piecewise_constant_schedule(sched)
    for i in range(3):
        g = {"w": rng.standard_normal((16, 8)).astype(np.float32) * 0.1,
             "b": {"c": rng.standard_normal(8).astype(np.float32)}}
        jp, je, js = jopt.fused_adam_ema_step(
            jp, je, js, jax.tree_util.tree_map(jnp.asarray, g),
            jopt.piecewise_constant_schedule(sched), b1=0.9)
        tg = [torch.from_numpy(v) for v in topt.tree_leaves(g)]
        tp, te, ts = topt.fused_adam_ema_step(tp, te, ts, tg, tsched, b1=0.9)
    assert ts["count"] == int(js[0].count) == 3
    pairs = [(tp, jp), (te, je), (ts["mu"], js[0].mu), (ts["nu"], js[0].nu)]
    for t_tree, j_tree in pairs:
        for a, b in zip(topt.tree_leaves(t_tree),
                        topt.tree_leaves(jax.device_get(j_tree))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited csrc header gives the including source a new library name,
    so it is rebuilt (the hash covers '#include "x.cuh"' recursively)."""
    from vqvae_wavenet_torch.ops import _build
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build._library_path("k")
    assert first == _build._library_path("k")
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert _build._library_path("k") != first
