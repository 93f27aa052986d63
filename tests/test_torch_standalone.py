"""The port's standalone WaveNet trainer against JAX's
(vqvae_wavenet_tpu/models/wavenet.py:317-352), on the tiny config of
tests/test_standalone_wavenet.py (3 layers, K=2, widths 8, Q=32).

Tolerances: the loss of each step within 1e-4 relative (f32, summation
order only); each step's parameter update, taken from JAX's state before
it, as tests/test_torch_train_step.py::check_update holds the VQ-VAE's
(1e-3 of the update where the gradient is well above rounding, else 2.5 lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.config import WavenetConfig
from vqvae_wavenet_tpu.models.wavenet import make_standalone_trainer as jtrainer
from vqvae_wavenet_tpu.training.optimizer import (
    WAVENET_STANDALONE_SCHEDULE as J_SCHEDULE)
from vqvae_wavenet_torch.models.wavenet import make_standalone_trainer
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import to_torch
from vqvae_wavenet_torch.training.optimizer import (
    WAVENET_STANDALONE_SCHEDULE, piecewise_constant_schedule)

from test_torch_train_step import LR, check_update

set_full_f32()


def tiny_cfg():
    return WavenetConfig(
        quantization_channels=32, num_cycles=1, num_cycle_layers=3,
        dilation_rates=[1, 2, 4], kernel_size=2, dilation_filters=8,
        skip_filters=8, residual_filters=8, preprocess_kernel_size=2,
        preprocess_filters=8)


def port_state(js):
    """JAX's standalone state (params, optax adam + schedule state, step)
    as the port's."""
    adam = js["opt_state"][0]
    return {"params": to_torch(js["params"]),
            "opt_state": {"mu": to_torch(adam.mu), "nu": to_torch(adam.nu),
                          "count": int(adam.count)},
            "step": int(js["step"])}


@pytest.mark.parametrize("case", ["none", "lc", "lc+gc"])
def test_three_steps_match_jax_leaf_by_leaf(case):
    """Without a condition, with lc [B, 4, 3] (16 samples a frame), and
    with lc plus a gc that varies over the lc's frames [B, 4, 2]."""
    cfg = tiny_cfg()
    B, T = 2, 64
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    lc = rng.standard_normal((B, 4, 3)).astype(np.float32) \
        if case != "none" else None
    gc = rng.standard_normal((B, 4, 2)).astype(np.float32) \
        if case == "lc+gc" else None
    c_lc = None if lc is None else 3
    c_gc = None if gc is None else 2
    jinit, jstep = jtrainer(cfg, c_lc, c_gc, schedule={0: LR})
    _, step = make_standalone_trainer(cfg, c_lc, c_gc, schedule={0: LR})
    js = jinit(jax.random.PRNGKey(0))
    jargs = [None if a is None else jnp.asarray(a) for a in (lc, gc)]
    targs = [None if a is None else torch.from_numpy(a) for a in (lc, gc)]

    def jloss(p):
        from vqvae_wavenet_tpu.models.wavenet import (wavenet_forward,
                                                      wavenet_loss)
        return wavenet_loss(*wavenet_forward(p, cfg, jnp.asarray(x),
                                             *jargs))
    for _ in range(3):
        jgrads = [torch.from_numpy(np.asarray(g, np.float64)) for g in
                  jax.tree_util.tree_leaves(jax.grad(jloss)(js["params"]))]
        old = port_state(jax.device_get(js))
        new, m = step(old, torch.from_numpy(x), *targs)
        jnew, jm = jstep(js, jnp.asarray(x), *jargs)
        jold = jax.device_get(js)
        js = jnew
        jnew = jax.device_get(jnew)
        assert abs(float(m["loss"]) - float(jm["loss"])) \
            <= 1e-4 * abs(float(jm["loss"]))
        assert new["step"] == int(jnew["step"]) and m["step"] == new["step"]
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
        assert new["opt_state"]["count"] == int(jnew["opt_state"][0].count)
        moved = check_update("params", new, old, jnew, jold, jgrads, 1.0)
        assert moved > 0


def test_standalone_trainer_losses_decrease():
    """The port's counterpart of tests/test_standalone_wavenet.py::
    test_standalone_trainer_losses_decrease (80 steps at lr 3e-3 on one
    batch, B=2 x 64, drawn here with numpy)."""
    cfg = tiny_cfg()
    init_fn, step_fn = make_standalone_trainer(cfg, schedule={0: 3e-3})
    state = init_fn(np.random.default_rng(0))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.5, 0.5, (2, 64, 1)).astype(np.float32))
    losses = []
    for _ in range(80):
        state, m = step_fn(state, x)
        losses.append(float(m["loss"]))
    assert state["step"] == 80
    assert losses[-1] < losses[0] * 0.8, losses[::20]
    assert abs(float(m["lr"]) - 3e-3) < 1e-9
    assert "lc_kernel" not in state["params"]["layers"]


def test_standalone_default_schedule():
    assert WAVENET_STANDALONE_SCHEDULE == J_SCHEDULE
    fn = piecewise_constant_schedule(WAVENET_STANDALONE_SCHEDULE)
    for count, lr in ((0, 4e-4), (39999, 4e-4), (40000, 2e-4),
                      (80000, 1e-4), (120000, 8e-5), (160000, 4e-5),
                      (200000, 2e-5), (10 ** 7, 2e-5)):
        assert fn(count) == pytest.approx(lr, rel=1e-7), count


def test_gc_frames_that_do_not_fit_raise():
    cfg = tiny_cfg()
    init_fn, step_fn = make_standalone_trainer(cfg, 3, 2)
    state = init_fn(0)
    x = torch.zeros((1, 64, 1))
    with pytest.raises(ValueError, match="global condition of 8 frames"):
        step_fn(state, x, torch.zeros((1, 4, 3)), torch.zeros((1, 8, 2)))
