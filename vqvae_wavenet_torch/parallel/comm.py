"""Exchanges between ranks (port of the lax.ppermute / pmean uses in
vqvae_wavenet_tpu/parallel/timeshard.py:37-57, :121-134, :221-226).

``shift(x, k)`` is the one point-to-point primitive, JAX's ppermute with
the pairs (i, i + k) along the 'time' axis: time shard t of a time row
sends x to shard t + k of its row and receives shard t - k's x, zeros
where that shard does not exist.  Its gradient is the
transposed shift (the cotangent goes back to the rank that sent the
value), so every exchange built from it is differentiable:

  left_halo(x, halo)        the ``halo`` columns before this shard, over
                            several left neighbours when halo > T_l; rank
                            0's are zeros (the causal pad)
  exchange_both(x, l, r)    l columns from the left neighbour, r from the
                            right, zeros at the ends (the SAME pad)
  sharded_shift_right(x)    shift_right over the whole sequence
  pmean(x)                  mean over the ranks (or a group of them: a
                            time row); its gradient is the mean of the
                            cotangents (the sum of the per-rank shares of
                            a loss, see timeshard.py)
  sum_grads(grads)          the gradients summed over the ranks in f32, in
                            one flat buffer (SP and DP steps alike)

Tensor parallelism (TP) exchanges along a model row (``sh.model_group``),
each the transpose of another, so that a split product's gradient comes
out whole (the collectives GSPMD inserts for JAX's 'model' axis):

  gather_split(x, dim)      the row's shards joined on ``dim``, for what
                            feeds a split product: its gradient arrives
                            partial on each rank, so the backward sums it
                            over the row and keeps this rank's slice
  gather_replicated(x, dim) the same join, for what feeds replicated work:
                            the backward keeps this rank's slice
  model_slice(x, dim)       this rank's slice of a replicated x; the
                            backward joins the row's slices
  reduce_model(x)           the sum over the row; the backward passes the
                            cotangent on
  copy_model(x)             x, for a replicated x that feeds a split
                            product; the backward sums the cotangent over
                            the row
  replicated_sum_(t)        model rank 0's t summed over the data group,
                            the same bits on every rank of a row

Tensors are [B, T_l, C] with time on axis 1.  Under gloo a CUDA tensor is
staged through host memory (gloo moves CUDA tensors only for collectives,
and not point to point).  Every rank must make the same calls in the same
order, which running the same program on equal shapes gives.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from vqvae_wavenet_torch.parallel import Shards


def _host(t: torch.Tensor, sh: Shards) -> torch.Tensor:
    return t.cpu() if sh.staged else t


def all_reduce_(t: torch.Tensor, sh: Shards, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks (of ``group``: every rank if None) in place
    (returns it); no gradient."""
    buf = _host(t.detach(), sh)
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def broadcast_(t: torch.Tensor, sh: Shards, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place (returns it)."""
    buf = _host(t, sh)
    dist.broadcast(buf, src)
    if buf is not t:
        t.copy_(buf)
    return t


def _sendrecv(x: torch.Tensor, dst: Optional[int], src: Optional[int],
              sh: Shards) -> torch.Tensor:
    """Send x to rank ``dst`` and receive a tensor shaped like x from rank
    ``src`` (None: no peer); returns what arrived, zeros without a
    source."""
    send = _host(x.detach().contiguous(), sh)
    recv = torch.zeros_like(send)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, send, dst))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, recv, src))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(x.device) if sh.staged else recv


def _peers(k: int, sh: Shards) -> Tuple[Optional[int], Optional[int]]:
    """The global ranks k time shards right and left of this one in its
    time row (None past the row's ends)."""
    t = sh.time_rank
    return (sh.rank + k if 0 <= t + k < sh.n_time else None,
            sh.rank - k if 0 <= t - k < sh.n_time else None)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k: int, sh: Shards):
        ctx.k, ctx.sh = k, sh
        return _sendrecv(x, *_peers(k, sh), sh)

    @staticmethod
    def backward(ctx, g):
        return _sendrecv(g, *_peers(-ctx.k, ctx.sh), ctx.sh), None, None


def shift(x: torch.Tensor, k: int, sh: Shards) -> torch.Tensor:
    """Time shard t gets shard t - k's x (zeros if there is none)."""
    return _Shift.apply(x, k, sh)


def left_halo(x: torch.Tensor, halo: int, sh: Shards) -> torch.Tensor:
    """The ``halo`` columns of left context of each shard ([B, halo, C]);
    positions before the sequence start are zeros.  When halo exceeds the
    shard length T_l, hop h ships the whole shard to rank r + h and the
    tail of the concatenation is kept (timeshard.py:37-57)."""
    if halo == 0:
        return x[:, :0]
    t_l = x.shape[1]
    if halo <= t_l:
        return shift(x[:, -halo:], 1, sh)
    hops = -(-halo // t_l)
    parts: List[torch.Tensor] = [shift(x, h, sh) for h in range(hops, 0, -1)]
    return torch.cat(parts, dim=1)[:, hops * t_l - halo:]


def exchange_both(x: torch.Tensor, left: int, right: int,
                  sh: Shards) -> torch.Tensor:
    """[left neighbour's last ``left`` columns | x | right neighbour's
    first ``right`` columns]; the end shards get zeros (timeshard.py:
    121-134)."""
    parts = [x]
    if left:
        parts.insert(0, shift(x[:, -left:], 1, sh))
    if right:
        parts.append(shift(x[:, :right], -1, sh))
    return torch.cat(parts, dim=1)


def sharded_shift_right(x: torch.Tensor, sh: Shards) -> torch.Tensor:
    """shift_right with the time axis sharded: column 0 of each shard is
    its left neighbour's last column (zero on rank 0)."""
    return torch.cat([left_halo(x, 1, sh), x], dim=1)[:, :-1]


def all_gather_(t: torch.Tensor, sh: Shards, dim: int,
                group=None) -> torch.Tensor:
    """The ranks' ``t`` (of ``group``: every rank if None; one shape on
    every rank) joined on ``dim`` in rank order; no gradient."""
    buf = _host(t.detach().contiguous(), sh)
    parts = [torch.empty_like(buf)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def own_slice(t: torch.Tensor, dim: int, sh: Shards) -> torch.Tensor:
    """This rank's contiguous slice m of n_model of ``t`` along ``dim`` (a
    view; no gradient rule of its own)."""
    n = t.shape[dim] // sh.n_model
    return t.narrow(dim, sh.model_rank * n, n)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, sh: Shards, partial: bool):
        ctx.dim, ctx.sh, ctx.partial = dim, sh, partial
        return all_gather_(x, sh, dim, sh.model_group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce_(g.contiguous().clone(), ctx.sh,
                            ctx.sh.model_group)
        return own_slice(g, ctx.dim, ctx.sh).contiguous(), None, None, None


def gather_split(x: torch.Tensor, dim: int, sh: Shards) -> torch.Tensor:
    """The model row's shards of x joined on ``dim``, feeding a product
    split over the row (backward: summed over the row, this rank's
    slice)."""
    return _GatherModel.apply(x, dim, sh, True)


def gather_replicated(x: torch.Tensor, dim: int, sh: Shards) -> torch.Tensor:
    """The model row's shards of x joined on ``dim``, feeding work every
    rank of the row repeats (backward: this rank's slice)."""
    return _GatherModel.apply(x, dim, sh, False)


class _SliceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, sh: Shards):
        ctx.dim, ctx.sh = dim, sh
        return own_slice(x, dim, sh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (all_gather_(g, ctx.sh, ctx.dim, ctx.sh.model_group), None,
                None)


def model_slice(x: torch.Tensor, dim: int, sh: Shards) -> torch.Tensor:
    """This rank's slice of a replicated x along ``dim`` (backward: the
    row's slices joined, so x's gradient is whole on every rank)."""
    return _SliceModel.apply(x, dim, sh)


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh: Shards):
        return all_reduce_(x.detach().clone(), sh, sh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_model(x: torch.Tensor, sh: Shards) -> torch.Tensor:
    """x summed over the model row (backward: the identity)."""
    return _ReduceModel.apply(x, sh)


class _CopyModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh: Shards):
        ctx.sh = sh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.sh,
                           ctx.sh.model_group), None


def copy_model(x: torch.Tensor, sh: Shards) -> torch.Tensor:
    """x (backward: the cotangent summed over the model row)."""
    return _CopyModel.apply(x, sh)


def replicated_sum_(t: torch.Tensor, sh: Shards) -> torch.Tensor:
    """The sum of ``t`` over the data group, in place, as the same bits on
    every rank of a model row: model rank 0's ``t`` summed over every rank,
    the others adding zeros (for a value each rank of the row computes
    alike; one collective, so no row can drift from another)."""
    if sh.model_rank:
        t.zero_()
    return all_reduce_(t, sh)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh: Shards, group):
        ctx.sh, ctx.group = sh, group
        return all_reduce_(x.detach().clone(), sh, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.sh, ctx.group), None, None


def pmean(x: torch.Tensor, sh: Shards, group=None) -> torch.Tensor:
    """The mean of x over the ranks (of ``group``: every rank if None),
    differentiable."""
    return _AllReduceSum.apply(x, sh, group) / dist.get_world_size(group)


def sum_grads(grads: List[torch.Tensor], sh: Shards,
              reduce=all_reduce_) -> List[torch.Tensor]:
    """Each tensor summed over the ranks: one ``reduce(flat, sh)`` (an
    all-reduce over every rank by default) of a float32 flat buffer
    holding them all; returned in their shapes and types."""
    if not grads:
        return []
    flat = reduce(torch.cat([g.reshape(-1).float() for g in grads]), sh)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
        i += g.numel()
    return out


def gather_global(t: torch.Tensor, sh: Shards) -> torch.Tensor:
    """The global tensor of every rank's ``t`` [b, f, ...] (its rows of
    data row d, its frames of time shard t; every rank's of one shape, the
    same on the ranks of a model row): the time shards joined on axis 1 in
    time order, the data rows on axis 0 in data order.  A collective over
    the data group: every rank calls it; no gradient."""
    buf = _host(t.detach().contiguous(), sh)
    parts = [torch.empty_like(buf) for _ in range(sh.data_world)]
    dist.all_gather(parts, buf, group=sh.data_group)
    n = sh.n_time
    rows = [torch.cat(parts[d * n:(d + 1) * n], dim=1) if n > 1
            else parts[d] for d in range(sh.n_data)]
    return torch.cat(rows, dim=0).to(t.device)
