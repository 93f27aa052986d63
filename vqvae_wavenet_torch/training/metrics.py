"""Training metrics: scalars appended to ``<save_dir>/metrics.jsonl`` (one
JSON object per write: step plus the scalar values), and the reference's
``\\r`` progress line (utils.py:49-67).  Histograms (the JAX package's
tensorboardX summaries) are not ported.
"""
from __future__ import annotations

import json
import os

import torch


class MetricWriter:
    def __init__(self, logdir: str):
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: dict) -> None:
        row = {"step": int(step)}
        for k, v in values.items():
            if k != "step":
                row[k] = float(v.item() if isinstance(v, torch.Tensor)
                               else v)
        self._f.write(json.dumps(row) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def display_time(t: float, second: float) -> str:
    """Reference utils.py:49-67 progress formatting."""
    minute = hour = None
    if second > 60:
        minute = second // 60
        second %= 60
        if minute > 60:
            hour = minute // 60
            minute %= 60
    if hour is not None:
        return " [BATCH %.3fs / ETA %dh %dm %.3fs]     " % (t, hour, minute,
                                                          second)
    if minute is not None:
        return " [BATCH %.3fs / ETA %dm %.3fs]     " % (t, minute, second)
    return " [BATCH %.3fs / ETA %.3fs]     " % (t, second)
