"""The data x time rank layout (port of the 'data' axis of
vqvae_wavenet_tpu/parallel/mesh.py:26-44 and of the (data, time) mesh of
train.py:113-125, :139-152).

JAX shards the global batch (``-batch`` per process x the process count)
over gcd(global batch, device count) devices -- under ``-time_shards N``
over n_data = gcd(global batch, device count // N) rows of N time shards
each -- and lets GSPMD make the batch norms, the VQ statistics and the
loss means global.  The port runs one rank a device (``mesh_shape``):
n_data * N ranks, N = 1 without SP, spread evenly over the hosts.  With
fewer devices than time shards (device count // N = 0) JAX's gcd(b, 0) =
b asks for more devices than exist; the port runs one time row (n_data =
1) whose ranks share the devices.  The global batch is the hosts' batches
in host order: each host's first rank reads its host's batch and
broadcasts it, every rank keeps them all (``global_batch``), and rank
(d, t) takes the contiguous rows d of n_data (``rank_rows``) and, under
SP, their time slice t.  The train state is replicated: the same seed
builds it on every rank, and a restored one is rank 0's, broadcast
(``replicate_``).  The math that makes the step global lives in the
models (``sh`` arguments), in ``training/train_loop.py::dp_loss_and_grads``
and in ``parallel/timeshard.py``.

The 'model' axis (tensor parallelism, TP, mesh.py:27-36, :47-85): n_data
x n_model ranks (``tp_mesh``, JAX's make_mesh), rank d * n_model + m on
data row d and model column m (``parallel.layout``).  ``param_specs`` is
JAX's ``_param_spec`` / ``param_shardings``: WaveNet ``layers/skip_kernel``
split on its output (S) axis, ``postprocess1/kernel`` on its input axis,
an encoder's rank-3 kernels at least 512 wide on their output channel; a
leaf whose axis n_model does not divide, and everything else, whole on
every rank.  ``shard_state`` cuts a single-device train state into a
rank's (params, EMA shadows and the Adam moments split alike; the model
state and the counts whole), and ``gather_state`` joins the shards again
into the single-device state, which rank 0 can save with
``training/checkpoint.py``.  The models run the split products through
the exchanges of ``parallel/comm.py``; ``training/train_loop.py`` holds
the step.  No CLI reaches TP, as none of the JAX package does (its
train.py builds its mesh with num_model=1); ``vqvae_wavenet_torch.dryrun``
and the tests drive it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vqvae_wavenet_torch.parallel import Shards
from vqvae_wavenet_torch.parallel.comm import (all_gather_, broadcast_,
                                              own_slice)
from vqvae_wavenet_torch.training.optimizer import tree_leaves, tree_unflatten


def device_count(device_type: str) -> int:
    """The devices of this host a rank can take: the GPUs, or one CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def mesh_shape(batch: int, n_time: int, hosts: int,
               device_type: str) -> Tuple[int, int]:
    """(n_data, ranks a host) of the data x time mesh for ``-batch``
    ``batch`` on each of ``hosts`` hosts with this host's device count
    (every host alike): n_data = gcd(batch * hosts, devices // n_time), or
    1 when there are fewer devices than time shards (train.py:117-122,
    :146-152; module docstring)."""
    n_dev = device_count(device_type) * hosts
    n_data = math.gcd(batch * hosts, n_dev // n_time) if n_dev >= n_time \
        else 1
    if (n_data * n_time) % hosts:
        raise ValueError(f"a mesh of data={n_data} x time={n_time} does not "
                         f"spread evenly over {hosts} hosts")
    return n_data, n_data * n_time // hosts


def data_ranks(batch: int, device_type: str) -> int:
    """This host's data ranks without SP: gcd(batch, device count)."""
    return mesh_shape(batch, 1, 1, device_type)[0]


def rank_rows(x: torch.Tensor, sh: Shards) -> torch.Tensor:
    """Rank (d, t)'s contiguous part d of n_data of the global batch x
    (the leading axis)."""
    b = x.shape[0] // sh.n_data
    return x[sh.data_rank * b:(sh.data_rank + 1) * b]


def global_batch(read: Callable[[], Dict[str, np.ndarray]],
                 shapes: Dict[str, Tuple[int, ...]], device: torch.device,
                 sh: Optional[Shards]) -> Dict[str, torch.Tensor]:
    """The global batch on ``device``: ``read()`` (a dict of float32 numpy
    arrays shaped as ``shapes``, this host's batch) runs on each host's
    first rank only, which broadcasts what it read to every rank; the
    hosts' batches are concatenated in host order.  A lone rank reads its
    own."""
    if sh is None or sh.world == 1:
        return {k: torch.from_numpy(v).to(device) for k, v in read().items()}
    mine = read() if sh.local_rank == 0 else None
    parts: Dict[str, list] = {k: [] for k in shapes}
    for h in range(sh.hosts):
        src = h * sh.local_world
        for k in sorted(shapes):
            buf = (torch.from_numpy(mine[k]).to(device) if sh.rank == src
                   else torch.empty(shapes[k], device=device))
            parts[k].append(broadcast_(buf, sh, src))
    return {k: v[0] if len(v) == 1 else torch.cat(v)
            for k, v in parts.items()}


def replicate_(ts, sh: Shards):
    """Rank 0's train state on every rank (the other ranks pass a state of
    the same tree, e.g. a fresh one): every tensor in one float32 flat
    buffer, then the step and the Adam count, broadcast from rank 0.
    Returns the state."""
    leaves = tree_leaves({k: v for k, v in ts.items() if k != "step"})
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    size = torch.tensor([sum(t.numel() for t in tensors)],
                        dtype=torch.float64, device=sh.device)
    theirs = broadcast_(size.clone(), sh)
    if int(theirs) != int(size):
        raise ValueError(f"rank {sh.rank}'s train state holds {int(size)} "
                         f"values, rank 0's {int(theirs)}")
    flat = broadcast_(torch.cat([t.reshape(-1).float() for t in tensors]),
                      sh)
    ints = broadcast_(torch.tensor([ts["step"], ts["opt_state"]["count"]],
                                   dtype=torch.float64, device=sh.device), sh)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t).to(t.dtype).clone())
        i += t.numel()
    it = iter(out)
    rest = tree_unflatten({k: v for k, v in ts.items() if k != "step"},
                          [next(it) if isinstance(t, torch.Tensor) else t
                           for t in leaves])
    rest["opt_state"]["count"] = int(ints[1])
    return dict(rest, step=int(ints[0]))


def tp_mesh(n: int, num_data: Optional[int] = None,
            num_model: int = 1) -> Tuple[int, int]:
    """(num_data, num_model) of a data x model mesh of ``n`` ranks:
    num_data defaults to n // num_model, and the product must be n (JAX's
    make_mesh, mesh.py:27-36)."""
    if num_data is None:
        num_data = n // num_model
    if num_data * num_model != n:
        raise ValueError(f"mesh {num_data}x{num_model} != {n} devices")
    return num_data, num_model


def param_spec(path: str, shape: Sequence[int]) -> Optional[int]:
    """The axis the tensor-parallel rules split a leaf on, or None (JAX's
    _param_spec, mesh.py:48-67): ``layers/skip_kernel`` of rank 3 on its
    last axis, ``postprocess1/kernel`` of rank 3 on its input (middle)
    axis, a rank-3 leaf under ``encoder`` on its last axis when that is at
    least 512 wide."""
    if len(shape) == 0 or min(shape) == 0:
        return None
    if "layers/skip_kernel" in path and len(shape) == 3:
        return 2
    if "postprocess1/kernel" in path and len(shape) == 3:
        return 1
    if "encoder" in path and len(shape) == 3 and shape[-1] >= 512:
        return 2
    return None


def _with_paths(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _with_paths(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_paths(v, fn, f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params, n_model: int):
    """The split axis (or None) of every leaf of a single-device parameter
    tree (anything with a ``shape``) on a model axis of ``n_model`` ranks:
    ``param_spec``, with a leaf whose axis ``n_model`` does not divide kept
    whole, and every leaf whole when n_model is 1 (JAX's param_shardings,
    mesh.py:70-85)."""
    def spec(path, leaf):
        axis = param_spec(path, tuple(leaf.shape)) if n_model > 1 else None
        if axis is None or leaf.shape[axis] % n_model:
            return None
        return axis
    return _with_paths(params, spec)


def _zip_specs(tree, specs, fn):
    """fn(leaf, axis) over the leaves of ``tree`` and their ``specs``."""
    if isinstance(tree, dict):
        return {k: _zip_specs(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_specs(v, a, fn) for v, a in zip(tree, specs)]
    return fn(tree, specs)


def _param_trees(ts, fn):
    """ts with fn(tree) applied to its params, EMA shadows and Adam
    moments: the trees shaped like the parameters."""
    opt = dict(ts["opt_state"], mu=fn(ts["opt_state"]["mu"]),
               nu=fn(ts["opt_state"]["nu"]))
    return dict(ts, params=fn(ts["params"]),
                ema_params=fn(ts["ema_params"]), opt_state=opt)


def gather_tree(tree, sh: Shards, specs):
    """The whole tree from the ranks' shards of a tree shaped like the
    parameters: every leaf ``specs`` splits joined over the model row on
    its axis.  A collective."""
    def join(leaf, axis):
        if axis is None:
            return leaf
        return all_gather_(leaf, sh, axis, sh.model_group)
    return _zip_specs(tree, specs, join)


def shard_state(ts, sh: Shards, specs):
    """This rank's train state from a single-device one: in the params,
    the EMA shadows and the Adam moments every leaf ``specs``
    (``param_specs`` of ts["params"]) splits cut to the rank's contiguous
    slice m of n_model on its axis (a copy); the rest, the model state and
    the counts as they are."""
    def cut(leaf, axis):
        return leaf if axis is None else \
            own_slice(leaf, axis, sh).contiguous().clone()
    return _param_trees(ts, lambda t: _zip_specs(t, specs, cut))


def gather_state(ts, sh: Shards, specs):
    """The single-device train state from the ranks' ``shard_state``
    shards (``gather_tree`` of its params, EMA shadows and Adam moments).
    A collective: every rank calls it and gets the whole state."""
    return _param_trees(ts, lambda t: gather_tree(t, sh, specs))
