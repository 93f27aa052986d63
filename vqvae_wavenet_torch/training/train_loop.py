"""Training state and one optimizer step (port of
vqvae_wavenet_tpu/training/train_loop.py:26-118), for both model families.

The train state is a dict of torch trees:
  params       the trained parameters (f32 master weights)
  ema_params   the EMA(0.999) shadows, distinct tensors (generation reads
               these)
  model_state  encoder batch-norm running statistics (+ the VQ EMA state
               under vq_mode 'ema')
  opt_state    {"mu", "nu": Adam moments shaped like params, "count": int}
  step         int

``train_step`` takes gradients of ``vqvae_forward`` (the Magenta family:
``magenta_forward``) with autograd (the stack and loss-head kernels'
backwards on the card), applies the fused Adam + EMA step (beta1 0.9;
the Magenta family 0.5, train_loop.py:85), keeps the new BN statistics,
and under vq_mode 'ema' moves the codebook by its EMA after the optimizer
step, with the EMA shadow following the updated codebook
(train_loop.py:89-98).  The Magenta family has no model state.

On a data x model mesh (tensor parallelism, TP; parallel/mesh.py) a rank's
train state holds its shards of the leaves ``param_specs`` splits, in the
params, the EMA shadows and the Adam moments alike (the update is
elementwise, so the shards step as the whole would), and the rest whole;
``mesh_train_step`` is JAX's make_jit_train_step(cfg, mesh).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.profiler import record_function

from vqvae_wavenet_torch.models import vq as vq_mod
from vqvae_wavenet_torch.models.magenta import magenta_forward
from vqvae_wavenet_torch.models.vqvae import vqvae_forward
from vqvae_wavenet_torch.parallel.comm import (all_reduce_, replicated_sum_,
                                              sum_grads)
from vqvae_wavenet_torch.training.optimizer import (
    ema_update, fused_adam_ema_step, piecewise_constant_schedule,
    tree_leaves, tree_unflatten)


def _clone(tree):
    return tree_unflatten(tree, [t.detach().clone() for t in
                                 tree_leaves(tree)])


def init_train_state(params, model_state):
    """A fresh train state around (params, model_state) torch trees: EMA
    shadows as distinct copies, Adam moments at zero, count and step 0."""
    return {
        "params": params,
        "ema_params": _clone(params),
        "model_state": model_state,
        "opt_state": {"mu": tree_unflatten(params, [
                          torch.zeros_like(t) for t in tree_leaves(params)]),
                      "nu": tree_unflatten(params, [
                          torch.zeros_like(t) for t in tree_leaves(params)]),
                      "count": 0},
        "step": 0,
    }


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detach(v) for v in tree]
    return tree.detach()


def _forward(params, model_state, cfg, batch, sh=None):
    if cfg.model_family == "magenta":
        return magenta_forward(params, batch["x"], batch["y"],
                               train_dtype=cfg.train_dtype, sh=sh)
    return vqvae_forward(params, model_state, cfg, batch["x"],
                         batch.get("y"), train=True, sh=sh,
                         jitter=batch.get("jitter"))


def loss_and_grads(params, model_state, cfg, batch):
    """(loss, aux, grads): grads is a list in tree_leaves(params) order,
    None where the loss does not reach a parameter."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        loss, aux = _forward(p, model_state, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), _detach(aux), list(grads)


# the batch means averaged over data-parallel ranks (the rest of the
# metrics are global already, or do not depend on the batch)
_RANK_MEANS = ("loss", "reconstruction_loss", "vq_loss", "commitment_loss")


def _data_sum_(t, sh):
    return all_reduce_(t, sh, sh.data_group)


def dp_loss_and_grads(params, model_state, cfg, batch, sh, specs=None):
    """loss_and_grads under data parallelism (DP): batch is this rank's
    contiguous slice of the global batch (parallel/mesh.py), every slice
    of one size.  Each rank backpropagates its SHARE of the global loss,
    its local loss / N (N the ranks of the data group); the batch norms'
    statistics and the VQ statistics span the data group (``sh``), and the
    gradients are summed over it in float32 in one flat buffer: the
    gradient of the mean of the local losses, which is the single-device
    loss on the global batch (train_loop.py:143-176 with a mesh: one
    program over the 'data' axis).  On a data x model mesh ``params`` are
    the rank's shards and ``specs`` their ``param_specs``: a split leaf's
    gradient is summed over the data group, and a whole leaf's, which
    every rank of a model row computes alike (the split products' partial
    sums are joined in the models), is model rank 0's summed over the data
    group, the same bits on every rank (``comm.replicated_sum_``).
    Returns (the global loss, aux with the batch means averaged over the
    ranks, grads), the same on every rank; ``train_step(..., grads_fn=
    functools.partial(dp_loss_and_grads, sh=sh), sh=sh)`` is the DP step,
    ``mesh_train_step`` the TP one."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        loss, aux = _forward(p, model_state, cfg, batch, sh)
        grads = torch.autograd.grad(loss / sh.data_world, leaves,
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    split = ([a is not None for a in tree_leaves(specs)] if specs is not None
             else [False] * len(grads))
    parts = {s: iter(sum_grads([g for g, t in zip(grads, split) if t == s],
                               sh, _data_sum_ if s else replicated_sum_))
             for s in (False, True)}
    grads = [next(parts[s]) for s in split]
    aux = dict(_detach(aux), loss=loss.detach())
    names = [n for n in _RANK_MEANS if n in aux]
    means = replicated_sum_(torch.stack([aux[n].float() for n in names]),
                            sh) / sh.data_world
    aux.update({n: means[i] for i, n in enumerate(names)})
    return aux["loss"], aux, grads


def train_step(ts, batch, cfg, *, ema_decay: float = 0.999,
               grads_fn=loss_and_grads, sh=None,
               with_summaries: bool = False, specs=None):
    """One optimizer step.  batch = {"x": [B, T, 1], "y": [B, 1, S] or
    None, and under time_jitter "jitter": the moves [B, T_cond]
    (models/vqvae.py::jitter_moves)} on the parameters' device.  Returns (new train state, metrics);
    the metrics are 0-d tensors (no host sync here) except the ints.
    ``grads_fn(params, model_state, cfg, batch)`` gives (loss, aux, grads):
    ``loss_and_grads`` here, ``dp_loss_and_grads`` under data parallelism,
    the sequence-parallel one under -time_shards (parallel/timeshard.py).
    ``sh``: a parallel rank's place (data x time or data x model), over
    whose data group the EMA codebook's statistics are summed.  The gradients and the update run in
    the profiler ranges "loss_and_grads" and "optimizer".
    ``with_summaries``: metrics["summaries"] holds the TensorBoard tensor
    set (train_loop.py:120-139): z_e, the gradient tree and its global
    norm, q_z_x, e_k and the distances of z_e's first 1,024 rows to every
    code; under ``sh`` z_e, q_z_x and e_k are gathered from every rank
    into the global batch's, and on a data x model mesh (``specs``: the
    params' ``param_specs``) the split leaves' gradients are joined over
    the model row (collectives at summary steps only)."""
    schedule = piecewise_constant_schedule(cfg.learning_rate_schedule)
    with record_function("loss_and_grads"):
        loss, aux, grads = grads_fn(ts["params"], ts["model_state"], cfg,
                                    batch)
    with record_function("optimizer"):
        params, ema_params, opt_state = fused_adam_ema_step(
            ts["params"], ts["ema_params"], ts["opt_state"], grads,
            schedule, b1=0.5 if cfg.model_family == "magenta" else 0.9,
            ema_decay=ema_decay)
    model_state = aux.get("state", ts["model_state"])
    if cfg.use_vq and cfg.vq_mode == "ema":
        with torch.no_grad(), record_function("optimizer"):
            new_vq, new_vq_state = vq_mod.ema_codebook_update(
                {"embedding": params["vq"]["embedding"]},
                ts["model_state"]["vq"], aux["z_e"], aux["q_z_x"],
                decay=cfg.ema_decay, sh=sh)
            ema_params = dict(ema_params, vq=ema_update(
                ts["ema_params"]["vq"], new_vq, ema_decay))
        params = dict(params, vq=new_vq)
        model_state = dict(model_state, vq=new_vq_state)
    step = ts["step"] + 1
    new_ts = {"params": params, "ema_params": ema_params,
              "model_state": model_state, "opt_state": opt_state,
              "step": step}
    metrics = {"loss": loss,
               "reconstruction_loss": aux["reconstruction_loss"],
               "lr": schedule(ts["step"]), "step": step}
    for k in ("vq_loss", "commitment_loss", "perplexity", "reg_loss",
              "distances_mean"):
        if k in aux:
            metrics[k] = aux[k]
    if with_summaries:
        metrics["summaries"] = _summaries(ts, aux, grads, cfg, sh, specs)
    return new_ts, metrics


def mesh_train_step(cfg, sh, specs, *, ema_decay: float = 0.999,
                    with_summaries: bool = False):
    """The train step of a rank of a data x model mesh (JAX's
    make_jit_train_step(cfg, mesh), train_loop.py:143-176): step(ts,
    batch) -> (new ts, metrics) on the rank's ``shard_state`` of a train
    state whose params have ``param_specs`` ``specs`` and on its
    ``rank_rows`` of the global batch; any family and encoder.  Also the
    DP step (specs None or n_model 1)."""
    return functools.partial(
        train_step, cfg=cfg, ema_decay=ema_decay,
        grads_fn=functools.partial(dp_loss_and_grads, sh=sh, specs=specs),
        sh=sh, with_summaries=with_summaries, specs=specs)


def _summaries(ts, aux, grads, cfg, sh, specs=None):
    """The summary tensors of a step from the parameters before it."""
    gtree = tree_unflatten(ts["params"], [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(tree_leaves(ts["params"]), grads)])
    if specs is not None and sh.n_model > 1:
        from vqvae_wavenet_torch.parallel.mesh import gather_tree
        gtree = gather_tree(gtree, sh, specs)
    norm = torch.sqrt(sum(g.float().pow(2).sum()
                          for g in tree_leaves(gtree)))
    e_k = aux.get("e_k", aux.get("encoding"))
    if e_k is None and "q_z_x" in aux and "vq" in ts["params"]:
        e_k = ts["params"]["vq"]["embedding"][aux["q_z_x"]]
    out = {"z_e": aux["z_e"], "q_z_x": aux.get("q_z_x"), "e_k": e_k}
    out = {k: v for k, v in out.items() if v is not None}
    if sh is not None:
        from vqvae_wavenet_torch.parallel.comm import gather_global
        out = {k: gather_global(v, sh) for k, v in out.items()}
    summ = dict(out, grads=gtree, grad_norm=norm)
    if cfg.use_vq and "vq" in ts["params"]:
        emb = ts["params"]["vq"]["embedding"].float()
        flat = out["z_e"].reshape(-1, emb.shape[1])[:1024].float()
        summ["distances"] = ((flat ** 2).sum(-1, keepdim=True)
                             - 2.0 * flat @ emb.T
                             + (emb ** 2).sum(-1)[None, :])
    return summ


def to_device(ts, device: Optional[torch.device]):
    """The train state with every tensor moved to ``device``."""
    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [move(v) for v in tree]
        if isinstance(tree, torch.Tensor):
            return tree.to(device)
        return tree
    return move(ts)
