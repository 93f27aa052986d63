"""Batch-sharded generation (port of vqvae_wavenet_tpu/parallel/genshard.py:
93-174, ``generate_sharded``).

Every stream evolves on its own, so scaling generation out is pure data
parallelism: the stream batch is split into n contiguous shards, each
shard runs the same whole-clip generation (generation/fast.py: the
generation kernel, or its int8 variant, on a CUDA device) at B/n on its
device, and the outputs are concatenated in order.  No process group and
no collective: the shards run in this process, each on its device's
current stream, so shards on different GPUs run at once and shards that
share a GPU run one after another (the kernel's cooperative grid holds one
block on every SM).

RNG (genshard.py:16-21): in sample mode shard i draws from its own
``torch.Generator``, seeded from (a seed drawn from the caller's generator,
i) by ``shard_generators``: valid samples, not the single-device draw
order.  Greedy decoding is deterministic per stream, so the sharded output
is the single-device output.  Sample i reads condition frame i // ratio
with the floor ratio of generation/fast.py (where JAX asserts length %
frames == 0, genshard.py:147-149, which Encoder_2019's frames fail).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from vqvae_wavenet_torch.generation.fast import draw_seed, generate


def shard_generators(generator: Optional[torch.Generator],
                     n: int) -> List[torch.Generator]:
    """n generators, shard i's seeded from (draw_seed(generator), i)."""
    base = draw_seed(generator)
    return [torch.Generator().manual_seed(int(
        np.random.SeedSequence([base, i]).generate_state(1, np.uint64)[0]
        >> np.uint64(1))) for i in range(n)]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def generate_sharded(params, cfg, local_condition: torch.Tensor, *,
                     length: int, devices: Sequence[torch.device],
                     generator: Optional[torch.Generator] = None,
                     mode: str = "sample", gate_order: str = "tanh_first",
                     dtype: torch.dtype = torch.float32,
                     global_condition: Optional[torch.Tensor] = None,
                     verbose: bool = False,
                     ratio: Optional[int] = None) -> torch.Tensor:
    """``generation.fast.generate`` with the stream batch of the local
    condition [B, T_cond, C_lc] (and the global condition [B, 1, C_gc])
    split over ``devices``, one shard each (a device may appear more than
    once).  Returns the float waveform [B, length] on the local
    condition's device.  One device: ``generate`` itself, with the
    caller's generator.  B must divide by the number of shards."""
    if mode not in ("sample", "greedy"):
        raise NotImplementedError(f"decode mode {mode} not implemented")
    n = len(devices)
    home = local_condition.device
    if n == 1:
        return generate(_to(params, devices[0]), cfg,
                        local_condition.to(devices[0]), length=length,
                        generator=generator, mode=mode, gate_order=gate_order,
                        dtype=dtype, verbose=verbose, ratio=ratio,
                        global_condition=None if global_condition is None
                        else global_condition.to(devices[0])).to(home)
    b = local_condition.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not divide over {n} shards; pad "
                         f"the speaker batch or use a shard count that "
                         f"divides it")
    per = b // n
    if verbose:
        print(f"[generate_sharded] shards={n} ({per} streams each) on "
              f"{', '.join(str(d) for d in devices)}")
    # every copy out of the home device is queued before any launch: a
    # copy waits for the work queued on its source device, so one issued
    # after shard 0's launch would hold the other shards back until it ends
    shards = []
    for i, dev in enumerate(devices):
        rows = slice(i * per, (i + 1) * per)
        shards.append((_to(params, dev), local_condition[rows].to(dev),
                       None if global_condition is None
                       else global_condition[rows].to(dev)))
    outs = [generate(p, cfg, lc, length=length, generator=g, mode=mode,
                     gate_order=gate_order, dtype=dtype, verbose=verbose,
                     ratio=ratio, global_condition=gc)
            for (p, lc, gc), g in zip(shards, shard_generators(generator, n))]
    return torch.cat([o.to(home) for o in outs])
