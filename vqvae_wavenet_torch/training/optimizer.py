"""Piecewise-constant learning rate, and Adam + parameter update + EMA
shadow in one pass (port of vqvae_wavenet_tpu/training/optimizer.py:29-110).

The update is optax.adam's algebra to float round-off, written over the
parameter dict (torch.optim.Adam keeps another state layout and rounds
elsewhere):

    lr   = schedule(count)                      # pre-increment count
    m'   = b1 m + (1 - b1) g;   v' = b2 v + (1 - b2) g^2
    p'   = p - lr (m' / (1 - b1^(count+1))) / (sqrt(v' / (1 - b2^(count+1))) + eps)
    ema' = ema_decay ema + (1 - ema_decay) p'

The bias corrections are float32, as in JAX.  A missing gradient (a
parameter the loss does not reach) counts as zero.  Without EMA shadows
(``ema_params`` None: the standalone WaveNet trainer) the step is plain
Adam.
"""
from __future__ import annotations

import numpy as np
import torch

# the standalone WaveNet trainer's schedule (reference wavenet.py:180-188;
# vqvae_wavenet_tpu/training/optimizer.py:23)
WAVENET_STANDALONE_SCHEDULE = {
    0: 4e-4, 40000: 2e-4, 80000: 1e-4,
    120000: 8e-5, 160000: 4e-5, 200000: 2e-5,
}


def piecewise_constant_schedule(schedule: dict):
    """{step: lr} -> fn(count) -> lr (a Python float holding the float32
    value): the value at the largest boundary <= count, whatever the dict's
    order (searchsorted right - 1, clipped)."""
    boundaries = np.asarray(sorted(int(b) for b in schedule), dtype=np.int64)
    values = np.asarray([schedule[b] for b in sorted(schedule,
                                                     key=int)],
                        dtype=np.float32)

    def fn(count: int) -> float:
        idx = int(np.searchsorted(boundaries, count, side="right")) - 1
        return float(values[min(max(idx, 0), len(values) - 1)])

    return fn


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def tree_leaves(tree):
    """Leaves in a fixed order (dict keys sorted, lists in order)."""
    return _leaves(tree, [])


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (tree_leaves order)."""
    return _rebuild(tree, iter(leaves))


def ema_update(ema_params, params, decay: float = 0.999):
    """shadow <- decay * shadow + (1 - decay) * param."""
    return tree_unflatten(ema_params, [
        decay * e + (1.0 - decay) * p
        for e, p in zip(tree_leaves(ema_params), tree_leaves(params))])


@torch.no_grad()
def fused_adam_ema_step(params, ema_params, opt_state, grads, schedule_fn, *,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                        ema_decay: float = 0.999):
    """One Adam + update + EMA step.  opt_state = {"mu", "nu", "count"}
    (mu/nu shaped like params, count an int).  Returns (params,
    ema_params, opt_state), all new tensors; ema_params None stays None."""
    count = int(opt_state["count"])
    cf = np.float32(count + 1)
    c1 = float(np.float32(1.0) - np.float32(b1) ** cf)
    c2 = float(np.float32(1.0) - np.float32(b2) ** cf)
    lr = schedule_fn(count)
    out_p, out_e, out_m, out_v = [], [], [], []
    emas = (tree_leaves(ema_params) if ema_params is not None
            else [None] * len(grads))
    for p, e, m, v, g in zip(tree_leaves(params), emas,
                             tree_leaves(opt_state["mu"]),
                             tree_leaves(opt_state["nu"]), grads):
        g = torch.zeros_like(m) if g is None else g.to(m.dtype)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * (g * g)
        upd = (lr * (m / c1) / (torch.sqrt(v / c2) + eps)).to(p.dtype)
        p = p - upd
        out_p.append(p)
        if e is not None:
            out_e.append(ema_decay * e + (1.0 - ema_decay) * p)
        out_m.append(m)
        out_v.append(v)
    return (tree_unflatten(params, out_p),
            None if ema_params is None else tree_unflatten(ema_params, out_e),
            {"mu": tree_unflatten(params, out_m),
             "nu": tree_unflatten(params, out_v), "count": count + 1})
