"""Checkpoints of the port's train state: ``<save_dir>/weights-<step>.npz``
in the flat layout of ``params.save_npz`` (keys ``a/b/c``, list entries by
index), so the port's generate.py restores one as it is:

  params/...   the EMA parameters (what generation of the main family
               reads, as the JAX generate.py restores the EMA shadows;
               the Magenta family generates from train/params)
  state/...    the model state (BN running statistics, VQ EMA state)
  train/...    what -restore needs besides: the trained parameters
               (train/params), the Adam moments (train/mu, train/nu),
               train/count and train/step

Writes go to a temporary file that is renamed into place; the newest
``keep`` checkpoints are kept.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from vqvae_wavenet_torch import params as P

_NAME = re.compile(r"weights-(\d+)\.npz")


def save_checkpoint(save_dir: str, ts, *, keep: int = 5) -> str:
    """Write weights-<step>.npz; returns its path (without .npz, as the
    JAX package names checkpoints)."""
    path = os.path.join(os.path.abspath(save_dir), f"weights-{int(ts['step'])}")
    write_checkpoint(path + ".npz", ts)
    _prune(save_dir, keep)
    return path


def write_checkpoint(path: str, ts) -> None:
    """Write the train state to the .npz ``path`` (temporary file, then
    rename)."""
    step = int(ts["step"])
    flat: dict = {}
    P.flatten(ts["ema_params"], "params", flat)
    P.flatten(ts["model_state"], "state", flat)
    P.flatten(ts["params"], "train/params", flat)
    P.flatten(ts["opt_state"]["mu"], "train/mu", flat)
    P.flatten(ts["opt_state"]["nu"], "train/nu", flat)
    flat["train/count"] = np.asarray(int(ts["opt_state"]["count"]), np.int64)
    flat["train/step"] = np.asarray(step, np.int64)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _steps(save_dir: str):
    if not os.path.isdir(save_dir):
        return []
    found = []
    for name in os.listdir(save_dir):
        m = _NAME.fullmatch(name)
        if m:
            found.append((int(m.group(1)), os.path.join(save_dir, name)))
    return sorted(found)


def _prune(save_dir: str, keep: int) -> None:
    for _, path in _steps(save_dir)[:-keep] if keep else []:
        os.remove(path)


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The newest weights-<step> in save_dir (path without .npz), or None."""
    found = _steps(save_dir)
    return found[-1][1][:-len(".npz")] if found else None


def restore_checkpoint(path: str, device=None):
    """The train state saved at ``path`` (weights-<step>, with or without
    .npz, or a directory: its newest checkpoint)."""
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no weights-<step>.npz in {path}")
        path = latest
    if not path.endswith(".npz"):
        path += ".npz"
    tree = P.load_tree(path, device)
    train = tree.get("train")
    if train is None:
        raise ValueError(f"{path} holds no training state (an inference "
                         f"export); it cannot be resumed")
    return {"params": train["params"], "ema_params": tree["params"],
            "model_state": tree.get("state", {}),
            "opt_state": {"mu": train["mu"], "nu": train["nu"],
                          "count": int(train["count"])},
            "step": int(train["step"])}
