"""Rank layout and process launch for the port's parallel training: one
process a rank, the ranks laid out on a data x time mesh (JAX's 2-D
('data', 'time') mesh, train.py:139-152) or on a data x model mesh (JAX's
('data', 'model') mesh, parallel/mesh.py:27-36).  On the first, global
rank r = d * n_time + t holds rows d of n_data contiguous parts of the
global batch (data parallelism, DP, ``parallel/mesh.py``) and, of those,
the time slice t of n_time (sequence parallelism, SP,
``parallel/timeshard.py``); n_time = 1 is pure DP, n_data = 1 pure SP.  On
the second, rank r = d * n_model + m holds rows d and shard m of n_model
of the parameters the tensor-parallel rules split (TP,
``parallel/mesh.py::param_specs``).  JAX has no data x time x model mesh,
and neither has the port: ``layout`` refuses n_time > 1 with n_model > 1.

The ranks may span several hosts (processes started on each host, joined
at one ``tcp://HOST:PORT``): host h holds global ranks h * L .. h * L + L - 1
of L * hosts.  A rank with local index l runs on ``cuda:(l %
device_count)`` (or the CPU).  The process group uses NCCL when every rank
of a host has a GPU of its own, and gloo otherwise: when ranks share a GPU
(NCCL refuses two ranks on one device) and on the CPU.  Under gloo a CUDA
tensor goes through host memory for every exchange (``Shards.staged``), so
times taken with ranks sharing one GPU describe that layout, not scaling.

``run_ranks`` spawns this host's ranks with the ``spawn`` start method (no
CUDA state crosses into a child), gives each a ``Shards`` and returns what
each rank's function returned, in rank order; a rank that raises makes it
raise.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Shards:
    """This rank's place: ``rank`` of ``world`` on ``device``, talking over
    ``backend``; the ranks span ``hosts`` hosts, ``world // hosts`` on
    each, host h holding ranks h * local_world .. (h + 1) * local_world - 1.
    ``n_time`` ranks make one time row (rank = data_rank * n_time +
    time_rank); ``time_group`` is the process group of this rank's time
    row (None when the row is the whole world).  Or ``n_model`` ranks make
    one model row (rank = data_rank * n_model + model_rank), the process
    group ``model_group`` (None when the row is the whole world), and the
    ranks of one model column, which hold the same parameter shards, the
    process group ``data_group`` (None when n_model is 1: every rank)."""
    rank: int
    world: int
    device: torch.device
    backend: str
    hosts: int = 1
    n_time: int = 1
    time_group: Any = dataclasses.field(default=None, compare=False)
    n_model: int = 1
    model_group: Any = dataclasses.field(default=None, compare=False)
    data_group: Any = dataclasses.field(default=None, compare=False)

    @property
    def n_data(self) -> int:
        return self.world // (self.n_time * self.n_model)

    @property
    def data_rank(self) -> int:
        return self.rank // (self.n_time * self.n_model)

    @property
    def time_rank(self) -> int:
        return self.rank % self.n_time

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def data_world(self) -> int:
        """The ranks of ``data_group``: those holding different data."""
        return self.world // self.n_model

    @property
    def local_world(self) -> int:
        return self.world // self.hosts

    @property
    def host(self) -> int:
        return self.rank // self.local_world

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_world

    @property
    def staged(self) -> bool:
        """Exchanges of CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def pick_backend(local_world: int, device_type: str) -> str:
    """NCCL when each of a host's ``local_world`` ranks has a GPU of its
    own, else gloo."""
    if device_type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _groups(rows) -> list:
    """A process group for each list of ranks in ``rows``, created in
    order (every rank creates every group, as ``dist.new_group``
    requires)."""
    return [dist.new_group(r) for r in rows]


def layout(sh: Shards, n_time: int = 1, n_model: int = 1) -> Shards:
    """``sh``'s ranks laid out again: time rows of ``n_time`` ranks, or
    model rows of ``n_model`` ranks and their columns (the groups are made
    here, so every rank of the world calls it, with the same arguments)."""
    if n_time > 1 and n_model > 1:
        raise ValueError(f"no mesh has both time={n_time} and model="
                         f"{n_model} axes: sequence and tensor parallelism "
                         f"do not compose (JAX has no data x time x model "
                         f"mesh)")
    n = max(n_time, n_model)
    if sh.world % n:
        raise ValueError(f"{sh.world} ranks do not split into rows of {n}")
    rows = [list(range(d * n, (d + 1) * n)) for d in range(sh.world // n)]
    row = _groups(rows)[sh.rank // n] if 1 < n < sh.world else None
    out = dataclasses.replace(sh, n_time=n_time, n_model=n_model,
                              time_group=None, model_group=None,
                              data_group=None)
    if n_time > 1:
        return dataclasses.replace(out, time_group=row)
    if n_model > 1:
        columns = _groups([r[m] for r in rows] for m in range(n))
        out = dataclasses.replace(out, model_group=row,
                                  data_group=columns[sh.rank % n])
    return out


def init_rank(rank: int, world: int, init_method: str, device_type: str,
              hosts: int = 1, n_time: int = 1, n_model: int = 1) -> Shards:
    """Join the process group at ``init_method`` (tcp://HOST:PORT) as
    global ``rank`` of ``world``, ``world // hosts`` ranks a host, in time
    rows of ``n_time`` ranks or model rows of ``n_model`` (``layout``)."""
    local_world = world // hosts
    device = rank_device(rank % local_world, device_type)
    backend = pick_backend(local_world, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif local_world > 1:   # the ranks share the host's cores
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                                  // local_world))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    sh = layout(Shards(rank, world, device, backend, hosts), n_time,
                n_model)
    # a first collective on every rank sets up the communicator before any
    # point-to-point exchange (NCCL wants all ranks in its first call)
    from vqvae_wavenet_torch.parallel.comm import all_reduce_
    all_reduce_(torch.zeros((1,), device=device), sh)
    return sh


def run_in_group(fn: Callable[..., Any], rank: int, world: int,
                 init_method: str, device_type: str, *args, hosts: int = 1,
                 n_time: int = 1, n_model: int = 1):
    """Join the process group in this process, run ``fn(shards, *args)``
    and leave the group (a host's only rank needs no spawned child)."""
    sh = init_rank(rank, world, init_method, device_type, hosts, n_time,
                   n_model)
    try:
        return fn(sh, *args)
    finally:
        dist.destroy_process_group()


def _rank_entry(local: int, fn, world: int, init_method: str,
                device_type: str, hosts: int, host: int, n_time: int,
                n_model: int, args: tuple, results) -> None:
    rank = host * (world // hosts) + local
    results.put((local, run_in_group(fn, rank, world, init_method,
                                     device_type, *args, hosts=hosts,
                                     n_time=n_time, n_model=n_model)))


def run_ranks(fn: Callable[..., Any], world: int, device_type: str, *args,
              timeout: Optional[float] = None, hosts: int = 1, host: int = 0,
              init_method: Optional[str] = None, n_time: int = 1,
              n_model: int = 1) -> List[Any]:
    """Run ``fn(shards, *args)`` on ``world`` spawned ranks of this host and
    return their results in rank order.  With ``hosts`` > 1 this is host
    ``host`` of a group of ``world * hosts`` ranks that meet at
    ``init_method`` (every host calls run_ranks); alone, the ranks meet on
    a free loopback port; ``n_time`` ranks make a time row, or
    ``n_model`` ranks a model row (``layout``).  ``fn`` must
    be importable by name (a module level function) and return picklable
    values (numbers, numpy arrays, not tensors).  All CUDA use in the caller must come before this call or
    stay in the caller alone: the children start fresh.  After ``timeout``
    seconds the ranks are killed and TimeoutError is raised."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    if init_method is None:
        init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = mp.start_processes(
        _rank_entry, args=(fn, world * hosts, init_method, device_type,
                           hosts, host, n_time, n_model, args, results),
        nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    got = {}
    try:
        # read while the ranks run: a result larger than the pipe's buffer
        # blocks its rank until it is read
        while True:
            try:
                rank, value = results.get(timeout=0.1)
                got[rank] = value
                continue
            except queue.Empty:
                pass
            if procs.join(timeout=0) and len(got) == world:  # raises if a
                break                                        # rank failed
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
