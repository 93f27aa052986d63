"""Data parallelism's rank layout (port of the 'data' axis of
vqvae_wavenet_tpu/parallel/mesh.py:26-44: ``make_mesh``,
``batch_sharding``, ``replicated``).

JAX shards the global batch (``-batch`` per process x the process count)
over gcd(global batch, device count) devices of one mesh and lets GSPMD
make the batch norms, the VQ statistics and the loss means global.  The
port runs one rank a device: ``data_ranks`` gives each host gcd(batch,
its device count) ranks -- with P hosts of D devices each, P * gcd(batch,
D) = gcd(batch * P, D * P) ranks in all, JAX's rule -- and rank l of a
host takes rows l * B/L .. (l + 1) * B/L - 1 of that host's batch
(``rank_rows``), so the global batch is the hosts' batches in host order.
One reader per host reads the host's batch and broadcasts it
(``host_batch``).  The train state is replicated: the same seed builds it
on every rank, and a restored one is rank 0's, broadcast (``replicate_``).
The math that makes the step global lives in the models (``sh`` arguments)
and in ``training/train_loop.py::dp_loss_and_grads``.

The 'model' axis (tensor parallelism, mesh.py:47-85) is not ported: no CLI
of the JAX package reaches it (ROADMAP.md queue A).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vqvae_wavenet_torch.parallel import Shards
from vqvae_wavenet_torch.parallel.comm import broadcast_
from vqvae_wavenet_torch.training.optimizer import tree_leaves, tree_unflatten


def device_count(device_type: str) -> int:
    """The devices of this host a rank can take: the GPUs, or one CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def data_ranks(batch: int, device_type: str) -> int:
    """This host's data ranks: gcd(batch, device count) (train.py:117-122
    per host)."""
    return math.gcd(batch, device_count(device_type))


def rank_rows(x: torch.Tensor, sh: Shards) -> torch.Tensor:
    """This rank's contiguous slice of its host's batch (the leading axis)."""
    b = x.shape[0] // sh.local_world
    return x[sh.local_rank * b:(sh.local_rank + 1) * b]


def host_batch(read: Callable[[], Dict[str, np.ndarray]],
               shapes: Dict[str, Tuple[int, ...]], device: torch.device,
               sh: Optional[Shards]) -> Dict[str, torch.Tensor]:
    """This host's batch on ``device``: ``read()`` (a dict of float32
    numpy arrays shaped as ``shapes``) runs on the host's first rank only,
    which broadcasts what it read to the others.  Every rank receives every
    host's batch (one broadcast from each host's first rank) and keeps its
    own host's: one rank a host reads its own."""
    if sh is None or sh.local_world == 1:
        return {k: torch.from_numpy(v).to(device) for k, v in read().items()}
    mine = read() if sh.local_rank == 0 else None
    out = {}
    for h in range(sh.hosts):
        src = h * sh.local_world
        for k in sorted(shapes):
            buf = (torch.from_numpy(mine[k]).to(device) if sh.rank == src
                   else torch.empty(shapes[k], device=device))
            broadcast_(buf, sh, src)
            if h == sh.host:
                out[k] = buf
    return out


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
