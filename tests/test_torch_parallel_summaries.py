"""Data- and sequence-parallel steps (2 gloo ranks) against the single
device: the summaries' set (tolerances in tests/test_torch_summaries.py,
whose single-device set is held to JAX there), and time jitter with the
upsampled condition under DP, where every rank draws the global batch's
moves from one seed and takes its rows (the single device is held to JAX
in tests/test_torch_jitter.py).  The ranks import this module, which
therefore does not import jax."""
import functools
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vqvae_wavenet_torch.ops.conv import set_full_f32  # noqa: E402
from vqvae_wavenet_torch.parallel import run_ranks  # noqa: E402
from vqvae_wavenet_torch.parallel.mesh import rank_rows  # noqa: E402
from vqvae_wavenet_torch.params import random_params_np, to_torch  # noqa
from vqvae_wavenet_torch.training import metrics  # noqa: E402
from vqvae_wavenet_torch.training.train_loop import (  # noqa: E402
    dp_loss_and_grads, init_train_state, train_step)

from test_torch_summaries import _case, check_set  # noqa: E402

RANK_TIMEOUT = 240


def jitter_rank(sh):
    """One rank of a 2-rank DP step with time_jitter and the upsampled
    condition: the global batch's moves from one seed, this rank's rows."""
    from vqvae_wavenet_torch.models.vqvae import jitter_moves
    set_full_f32()
    cfg, _, _, b = _case()
    cfg = type(cfg)(**dict(vars(cfg), time_jitter=True,
                           condition_upsample=True))
    params, state = random_params_np(cfg, 4, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    batch["jitter"] = jitter_moves(7, 2, 16)
    batch = {k: rank_rows(v, sh) for k, v in batch.items()}
    loss, _, grads = dp_loss_and_grads(to_torch(params), to_torch(state),
                                       cfg, batch, sh)
    return float(loss), [g.numpy() for g in grads] if sh.rank == 0 else None


def test_dp_step_with_jitter_and_upsample_equals_single_device():
    """Under DP every rank draws the global batch's moves from the same
    seed and takes its rows, so the 2-rank loss and summed gradients equal
    the single device's (loss within 1e-5 relative, gradients within 5e-3
    of their leaf's largest, or of 1e-4 of the largest gradient for a leaf
    whose exact gradient is zero: tests/test_timeshard.py:654-663)."""
    from vqvae_wavenet_torch.models.vqvae import jitter_moves
    from vqvae_wavenet_torch.training.train_loop import loss_and_grads
    set_full_f32()
    cfg, _, _, b = _case()
    cfg = type(cfg)(**dict(vars(cfg), time_jitter=True,
                           condition_upsample=True))
    params, state = random_params_np(cfg, 4, seed=3)
    batch = dict({k: torch.from_numpy(v) for k, v in b.items()},
                 jitter=jitter_moves(7, 2, 16))
    loss, _, grads = loss_and_grads(to_torch(params), to_torch(state), cfg,
                                    batch)
    res = run_ranks(jitter_rank, 2, "cpu", timeout=RANK_TIMEOUT)
    assert res[0][0] == res[1][0]
    assert abs(res[0][0] - float(loss)) <= 1e-5 * abs(float(loss))
    gmax = max(float(r.abs().max()) for r in grads)
    for g, r in zip(res[0][1], grads):      # JAX's SP rule (as above)
        r = r.numpy()
        assert np.abs(g - r).max() <= 5e-3 * max(np.abs(r).max(),
                                                 1e-4 * gmax)


def summary_rank(sh, mode):
    """One rank of a 2-rank DP or SP step with summaries; rank 0 returns
    its histogram set."""
    set_full_f32()
    cfg, params, state, b = _case()
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    if mode == "dp":
        batch = {k: rank_rows(v, sh) for k, v in batch.items()}
        grads_fn = functools.partial(dp_loss_and_grads, sh=sh)
    else:
        from vqvae_wavenet_torch.parallel.timeshard import sp_loss_and_grads
        t_l = batch["x"].shape[1] // sh.world
        batch["x"] = batch["x"][:, sh.rank * t_l:(sh.rank + 1) * t_l]
        grads_fn = functools.partial(sp_loss_and_grads, sh=sh)
    ts = init_train_state(to_torch(params), to_torch(state))
    new, m = train_step(ts, batch, cfg, sh=sh, grads_fn=grads_fn,
                        with_summaries=True)
    if sh.rank:
        return None
    return metrics.summary_histograms(new["params"], m["summaries"])


@pytest.mark.parametrize("mode", ["dp", "sp"])
def test_parallel_step_writes_the_single_device_set(mode):
    set_full_f32()
    cfg, params, state, b = _case()
    ts = init_train_state(to_torch(params), to_torch(state))
    new, m = train_step(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                        cfg, with_summaries=True)
    ref = metrics.summary_histograms(new["params"], m["summaries"])
    got = run_ranks(summary_rank, 2, "cpu", mode, timeout=RANK_TIMEOUT,
                    n_time=2 if mode == "sp" else 1)[0]
    check_set(got, ref, grad_rel=5e-3, param_abs=2.5 * 1e-3)
    assert got["z_e"].shape == ref["z_e"].shape == (2, 16, 4)

