"""The multichip dryrun and the flagship forward (port of
__graft_entry__.py:13-247).

    python -m vqvae_wavenet_torch.dryrun [N] [-device cuda|cpu]

``entry(device)`` returns (fn, example_args): the flagship model's forward
(the shipped defaults: Encoder_64, k=512, the 30-layer WaveNet; random
weights from seed 0, 109 speakers) in evaluation mode, and its arguments
x [2, 2048, 1] and y [2, 1, 109].

``dryrun_multichip(n, device)`` spawns n ranks (``parallel.run_ranks``;
with fewer cards than ranks the ranks share them, over gloo) and runs the
JAX dryrun's six rows with its tiny configs, batches and lengths:
  1. one training step on a data n/2 x model 2 mesh (tensor parallelism
     with the 'model' axis, 512-wide skip channels so that the rules split
     them; model 1 for odd n), batch 2 a data row, T=256;
  2. one sequence-parallel step on a data x time mesh (time 4 when 4
     divides n, else 2, else 1: then the step is the DP step);
  3. sharded greedy generation of 2n streams, one shard a rank's device;
  4. one data-parallel step of the Magenta family at batch 2n;
  5. one sequence-parallel step of the Magenta family on the mesh of 2;
  6. the Magenta family's sharded greedy conversion of n clips.
The Magenta family runs shrunk (6 layers of 3 stages, widths 16, an
8-wide bottleneck, 16 codes): JAX patches its module constants in place,
which a spawned rank would not see, so every rank and this process set
them from ``MAGENTA_DRYRUN`` themselves and put them back after.  Each
training row's loss is held against the single-device step on the same
batch and weights (within 1e-5 relative), and rows 3 and 6 against the
single-device call (identical waveforms).  It prints the six lines in
JAX's wording (``mesh={'data': 4, 'model': 2}`` at n = 8) and returns
the rows' numbers and the modules of JAX each rank had imported.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

from vqvae_wavenet_torch.config import ModelConfig, WavenetConfig
from vqvae_wavenet_torch.parallel.mesh import tp_mesh

NUM_SPEAKERS = 4
LOSS_RTOL = 1e-5
# __graft_entry__.py:180-187
MAGENTA_DRYRUN = {"NUM_LAYERS": 6, "NUM_STAGES": 3, "WIDTH": 16,
                  "SKIP_WIDTH": 16, "AE_WIDTH": 16,
                  "AE_BOTTLENECK_WIDTH": 8, "K_CODES": 16}


def entry(device: str = "cuda"):
    """(fn, (params, x, y)): fn(params, x, y) -> (loss, reconstruction
    loss) of the flagship model in evaluation mode on ``device``
    (__graft_entry__.py:13-30)."""
    from vqvae_wavenet_torch.models.vqvae import vqvae_forward
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    set_full_f32()
    dev = torch.device(device)
    cfg = ModelConfig()
    num_speakers = 109
    params, state = random_params_np(cfg, num_speakers, seed=0)
    params, state = to_torch(params, dev), to_torch(state, dev)

    def fn(params, x, y):
        loss, aux = vqvae_forward(params, state, cfg, x, y, train=False)
        return loss, aux["reconstruction_loss"]

    b, t = 2, 2048
    x = torch.zeros((b, t, 1), device=dev)
    y = _one_hot(b, num_speakers, dev)
    return fn, (params, x, y)


def _one_hot(b: int, n: int, device) -> torch.Tensor:
    """one_hot(arange(b) % n, n)[:, None, :]."""
    y = torch.zeros((b, 1, n), device=device)
    y[torch.arange(b), 0, torch.arange(b) % n] = 1.0
    return y


def _tiny_cfg(skip_filters: int) -> ModelConfig:
    """__graft_entry__.py:68-76 (and :127-134 at skip_filters 16)."""
    return ModelConfig(
        encoder="64", use_vq=True, speaker_embedding=8, k=32, latent_dim=8,
        beta=0.25, learning_rate_schedule={0: 1e-4},
        wavenet=WavenetConfig(
            quantization_channels=64, num_cycles=1, num_cycle_layers=4,
            dilation_rates=[1, 2, 4, 8], kernel_size=2, dilation_filters=16,
            skip_filters=skip_filters, residual_filters=16,
            preprocess_kernel_size=4, preprocess_filters=16))


@contextlib.contextmanager
def shrunk_magenta():
    """The Magenta family's module constants at MAGENTA_DRYRUN inside the
    block, put back after it."""
    from vqvae_wavenet_torch.models import magenta as mg
    saved = {k: getattr(mg, k) for k in MAGENTA_DRYRUN}
    try:
        for k, v in MAGENTA_DRYRUN.items():
            setattr(mg, k, v)
        yield mg
    finally:
        for k, v in saved.items():
            setattr(mg, k, v)


def _magenta_cfg(mg) -> ModelConfig:
    """__graft_entry__.py:188-192 with the shrunk constants."""
    return ModelConfig(
        model_family="magenta", encoder="Magenta", k=mg.K_CODES,
        latent_dim=mg.AE_BOTTLENECK_WIDTH, speaker_embedding=64, beta=0.25,
        use_vq=True, wavenet=mg.magenta_wavenet_config(),
        learning_rate_schedule={0: 1e-4})


def mesh_axes(n: int):
    """((n_data, n_model) of row 1, n_time of rows 2 and 5) for n ranks
    (__graft_entry__.py:63-65, :123)."""
    mesh = tp_mesh(n, num_model=2 if n % 2 == 0 and n > 1 else 1)
    return mesh, 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


def _state(cfg, seed: int, device):
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    from vqvae_wavenet_torch.training.train_loop import init_train_state
    params, state = random_params_np(cfg, NUM_SPEAKERS, seed=seed)
    return init_train_state(to_torch(params, device), to_torch(state, device))


def _single_loss(ts, cfg, batch) -> float:
    """The loss of the single-device step on the whole batch."""
    from vqvae_wavenet_torch.training.train_loop import train_step
    return float(train_step(ts, batch, cfg)[1]["loss"])


def _train_row(sh, cfg, seed: int, batch, mesh: str, n_time: int = 1,
               n_model: int = 1):
    """One step of ``cfg`` from the init of ``seed`` on the whole
    ``batch`` laid out on ``mesh`` ("tp": data x model, "sp": data x
    time, "dp"); (loss, the single-device step's loss on rank 0)."""
    import functools
    from vqvae_wavenet_torch.parallel import layout
    from vqvae_wavenet_torch.parallel.mesh import (param_specs, rank_rows,
                                                   shard_state)
    from vqvae_wavenet_torch.parallel.timeshard import sp_loss_and_grads
    from vqvae_wavenet_torch.training.train_loop import (mesh_train_step,
                                                         train_step)
    ts = _state(cfg, seed, sh.device)
    rows = layout(sh, n_time=n_time if mesh == "sp" else 1,
                  n_model=n_model if mesh == "tp" else 1)
    part = {k: rank_rows(v, rows) for k, v in batch.items()}
    if mesh == "sp" and n_time > 1:
        t_l = part["x"].shape[1] // n_time
        part["x"] = part["x"][:, rows.time_rank * t_l:
                              (rows.time_rank + 1) * t_l].contiguous()
        _, metrics = train_step(
            ts, part, cfg, sh=rows,
            grads_fn=functools.partial(sp_loss_and_grads, sh=rows))
    else:
        specs = param_specs(ts["params"], rows.n_model)
        _, metrics = mesh_train_step(cfg, rows, specs)(
            shard_state(ts, rows, specs), part)
    loss = float(metrics["loss"])
    return loss, _single_loss(ts, cfg, batch) if sh.rank == 0 else None


def _dryrun_rank(sh, n_model: int, n_time: int) -> dict:
    """Rows 1, 2, 4 and 5 on this rank (module docstring)."""
    from vqvae_wavenet_torch.ops.conv import set_full_f32
    from vqvae_wavenet_torch.train import _launch_counts
    set_full_f32()
    n, dev = sh.world, sh.device
    out = {}
    batch = 2 * (n // n_model)
    out["tp"] = _train_row(
        sh, _tiny_cfg(512), 0, {"x": torch.zeros((batch, 256, 1), device=dev),
                                "y": _one_hot(batch, NUM_SPEAKERS, dev)},
        "tp", n_model=n_model)
    n_dp, t_total = n // n_time, 64 * n_time * 2
    sp_batch = {"x": torch.zeros((n_dp, t_total, 1), device=dev),
                "y": _one_hot(n_dp, NUM_SPEAKERS, dev)}
    out["sp"] = _train_row(sh, _tiny_cfg(16), 2, sp_batch, "sp",
                           n_time=n_time)
    with shrunk_magenta() as mg:
        mcfg = _magenta_cfg(mg)
        out["magenta_dp"] = _train_row(
            sh, mcfg, 5, {"x": torch.zeros((2 * n, 256, 1), device=dev),
                          "y": _one_hot(2 * n, NUM_SPEAKERS, dev)}, "dp")
        out["magenta_sp"] = _train_row(sh, mcfg, 7, sp_batch, "sp",
                                       n_time=n_time)
    out["imported"] = sorted(m for m in sys.modules if m == "jax" or
                             m.startswith(("jax.", "vqvae_wavenet_tpu")))
    out["launches"] = _launch_counts()
    return out


def _devices(n: int, device: str):
    """The device of each of n shards: the ranks' devices."""
    from vqvae_wavenet_torch.parallel import rank_device
    return [rank_device(r, device) for r in range(n)]


def _gen_row(n: int, device: str) -> None:
    """Row 3: sharded greedy generation of 2n streams, identical to the
    single-device call."""
    from vqvae_wavenet_torch.generation.fast import generate
    from vqvae_wavenet_torch.params import random_wavenet_np, to_torch
    from vqvae_wavenet_torch.parallel.genshard import generate_sharded
    devices = _devices(n, device)
    gcfg = WavenetConfig(
        quantization_channels=64, num_cycles=1, num_cycle_layers=3,
        dilation_rates=[1, 2, 4], kernel_size=2, dilation_filters=16,
        skip_filters=16, residual_filters=16,
        preprocess_kernel_size=4, preprocess_filters=16)
    gp = to_torch(random_wavenet_np(gcfg, lc_channels=8, seed=3), devices[0])
    g = torch.Generator().manual_seed(4)
    lc = (torch.randn((2 * n, 4, 8), generator=g) * 0.3).to(devices[0])
    ref = generate(gp, gcfg, lc, length=32, mode="greedy")
    got = generate_sharded(gp, gcfg, lc, length=32, mode="greedy",
                           devices=devices)
    if not torch.equal(got, ref):
        raise AssertionError("sharded generation != single-device")
    print(f"dryrun_multichip: GEN data={n} batch={2 * n} greedy parity OK",
          flush=True)


def _magenta_gen_row(n: int, device: str) -> None:
    """Row 6: the Magenta family's sharded greedy conversion of n clips,
    identical to the single-device call."""
    from vqvae_wavenet_torch.params import random_params_np, to_torch
    devices = _devices(n, device)
    with shrunk_magenta() as mg:
        params, _ = random_params_np(_magenta_cfg(mg), NUM_SPEAKERS, seed=8)
        params = to_torch(params, devices[0])
        rng = np.random.default_rng(9)
        x = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 128, 1)).astype(
            np.float32)).to(devices[0])
        y = _one_hot(n, NUM_SPEAKERS, devices[0])
        ref = mg.magenta_generate(params, x, y, mode="greedy")
        got = mg.magenta_generate(params, x, y, mode="greedy",
                                  devices=devices)
    if not torch.equal(got, ref):
        raise AssertionError("Magenta sharded gen != single-device")
    print(f"dryrun_multichip: MAGENTA GEN data={n} batch={n} greedy "
          f"parity OK", flush=True)


def _check(name: str, row) -> float:
    loss, ref = row
    if not np.isfinite(loss):
        raise AssertionError(f"NaN loss in {name} dryrun")
    if abs(loss - ref) > LOSS_RTOL * abs(ref):
        raise AssertionError(f"{name} dryrun: loss {loss!r} against the "
                             f"single device's {ref!r}")
    return loss


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 900.0) -> dict:
    """The six rows of __graft_entry__.py::dryrun_multichip on
    ``n_devices`` ranks on ``device`` (module docstring).  Raises if a row
    fails; returns {"losses": {row: (loss, single-device loss)},
    "imported": [each rank's imported JAX modules]}."""
    from vqvae_wavenet_torch.parallel import run_ranks
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (pass "
                           "device='cpu' for the CPU)")
    n = n_devices
    (n_data, n_model), n_time = mesh_axes(n)
    res = run_ranks(_dryrun_rank, n, device, n_model, n_time,
                    timeout=timeout)
    rows = {k: res[0][k] for k in ("tp", "sp", "magenta_dp", "magenta_sp")}
    n_dp = n // n_time
    print(f"dryrun_multichip: mesh={{'data': {n_data}, 'model': {n_model}}} "
          f"batch={2 * n_data} loss={_check('TP', rows['tp']):.4f} OK",
          flush=True)
    print(f"dryrun_multichip: SP data={n_dp} x time={n_time} "
          f"T={64 * n_time * 2} loss={_check('SP', rows['sp']):.4f} OK",
          flush=True)
    _gen_row(n, device)
    print(f"dryrun_multichip: MAGENTA DP data={n} batch={2 * n} "
          f"loss={_check('Magenta DP', rows['magenta_dp']):.4f} OK",
          flush=True)
    print(f"dryrun_multichip: MAGENTA SP data={n_dp} x time={n_time} "
          f"T={64 * n_time * 2} "
          f"loss={_check('Magenta SP', rows['magenta_sp']):.4f} OK",
          flush=True)
    _magenta_gen_row(n, device)
    return {"losses": rows, "imported": [r["imported"] for r in res],
            "launches": [r["launches"] for r in res]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=8,
                        help="ranks (default 8)")
    parser.add_argument("-device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
