"""Rank layout and process launch for the port's sequence parallelism (SP,
``parallel/timeshard.py``): N ranks, one process each, the time axis of
every batch split into N contiguous shards.

Rank r runs on ``cuda:(r % device_count)`` (or the CPU).  The process
group uses NCCL when every rank has a GPU of its own, and gloo otherwise:
when ranks share a GPU (NCCL refuses two ranks on one device) and on the
CPU.  Under gloo a CUDA tensor goes through host memory for every exchange
(``Shards.staged``), so times taken with ranks sharing one GPU describe
that layout, not SP scaling.

``run_ranks`` spawns the ranks with the ``spawn`` start method (no CUDA
state crosses into a child), gives each a ``Shards`` and returns what each
rank's function returned, in rank order; a rank that raises makes it raise.
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
    """This rank's place: ``rank`` of ``world`` time shards on ``device``,
    talking over ``backend``."""
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def staged(self) -> bool:
        """Exchanges of CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def pick_backend(world: int, device_type: str) -> str:
    """NCCL when each of the ``world`` ranks has a GPU of its own, else
    gloo."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world: int, port: int, device_type: str) -> Shards:
    """Join the process group at tcp://127.0.0.1:<port> as ``rank``."""
    device = rank_device(rank, device_type)
    backend = pick_backend(world, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:       # the ranks share the host's cores: no oversubscription
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    sh = Shards(rank, world, device, backend)
    # a first collective on every rank sets up the communicator before any
    # point-to-point exchange (NCCL wants all ranks in its first call)
    from vqvae_wavenet_torch.parallel.comm import all_reduce_
    all_reduce_(torch.zeros((1,), device=device), sh)
    return sh


def _rank_entry(rank: int, fn, world: int, port: int, device_type: str,
                args: tuple, results) -> None:
    sh = init_rank(rank, world, port, device_type)
    try:
        results.put((rank, fn(sh, *args)))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, device_type: str, *args,
              timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(shards, *args)`` on ``world`` spawned ranks and return their
    results in rank order.  ``fn`` must be importable by name (a module
    level function) and return picklable values (numbers, numpy arrays, not
    tensors).  All CUDA use in the caller must come before this call or
    stay in the caller alone: the children start fresh.  After ``timeout``
    seconds the ranks are killed and TimeoutError is raised."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = mp.start_processes(
        _rank_entry, args=(fn, world, free_port(), device_type, args,
                           results),
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
