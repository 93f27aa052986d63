"""Training metrics: TensorBoard event files written without tensorboardX
(which the card's machine lacks), ``<save_dir>/metrics.jsonl`` (one JSON
object per scalar write: step plus the values), the reference's
histogram set (port of vqvae_wavenet_tpu/training/metrics.py), and the
``\\r`` progress line (utils.py:49-67).

The event file is what tensorboardX's SummaryWriter writes
(``events.out.tfevents.<time>.<host>``): TFRecord framing (a little-endian
uint64 length, its masked CRC32C, the record, its masked CRC32C) around
hand-encoded ``Event`` protobuf messages, the first holding the file
version, then one event per scalar (``Summary.Value.simple_value``) or
histogram (``HistogramProto``).  Histograms use tensorboardX's default
("tensorflow") buckets -- +-1e-12 growing by 1.1 up to 1e20, and 0 --
trimmed to the support as its ``make_histogram`` trims them, so one array
gives the same histogram in both packages.  Tags are cleaned as
tensorboardX cleans them (characters outside ``[-/\\w.]`` become ``_``).
"""
from __future__ import annotations

import json
import os
import re
import socket
import struct
import time

import numpy as np
import torch

# ------------------------------------------------------------ event files


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotated right by 15, plus 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc32c(head)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def _f_bytes(field: int, b: bytes) -> bytes:
    return _key(field, 2) + _varint(len(b)) + b


def _f_doubles(field: int, vs) -> bytes:
    """A packed repeated double field."""
    return _f_bytes(field, np.asarray(vs, "<f8").tobytes())


def event_bytes(wall_time: float, step: int = None, *,
                file_version: str = None, values=()) -> bytes:
    """A serialized Event: wall_time (1), step (2), file_version (3) and a
    Summary (5) of ``values``, each an encoded Summary.Value."""
    out = _f_double(1, wall_time)
    if step is not None:
        out += _f_int(2, step)
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if values:
        out += _f_bytes(5, b"".join(_f_bytes(1, v) for v in values))
    return out


def scalar_value(tag: str, value: float) -> bytes:
    """Summary.Value: tag (1), simple_value (2, a float32)."""
    return _f_bytes(1, tag.encode()) + _f_float(2, value)


def histogram_value(tag: str, h: dict) -> bytes:
    """Summary.Value: tag (1), histo (5): HistogramProto min (1), max (2),
    num (3), sum (4), sum_squares (5), bucket_limit (6), bucket (7)."""
    histo = (_f_double(1, h["min"]) + _f_double(2, h["max"])
             + _f_double(3, h["num"]) + _f_double(4, h["sum"])
             + _f_double(5, h["sum_squares"])
             + _f_doubles(6, h["bucket_limit"]) + _f_doubles(7, h["bucket"]))
    return _f_bytes(1, tag.encode()) + _f_bytes(5, histo)


def default_bins() -> list:
    """tensorboardX's default ("tensorflow") bucket edges."""
    v, pos = 1e-12, []
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    return [-b for b in pos[::-1]] + [0] + pos


_BINS = default_bins()
_INVALID_TAG = re.compile(r"[^-/\w\.]")


def clean_tag(name: str) -> str:
    """tensorboardX's tag cleaning: invalid characters to '_', leading
    slashes dropped."""
    return _INVALID_TAG.sub("_", name).lstrip("/")


def make_histogram(values) -> dict:
    """The histogram of ``values`` (any shape, finite) over the default
    buckets, trimmed to the buckets holding values with one empty bucket on
    the left (tensorboardX summary.py::make_histogram)."""
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    if values.size == 0:
        raise ValueError("the histogram of no values")
    counts, limits = np.histogram(values, bins=_BINS)
    cum = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    counts = (counts[start - 1:end] if start > 0
              else np.concatenate([[0], counts[:end]]))
    limits = limits[start:end + 1]
    return {"min": float(values.min()), "max": float(values.max()),
            "num": float(values.size), "sum": float(values.sum()),
            "sum_squares": float(values.dot(values)),
            "bucket_limit": [float(v) for v in limits],
            "bucket": [float(v) for v in counts]}


class MetricWriter:
    """Scalars and histograms into a TensorBoard event file in ``logdir``,
    scalars also into ``logdir/metrics.jsonl``."""

    def __init__(self, logdir: str):
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self.path = os.path.join(
            logdir, "events.out.tfevents." + str(time.time())[:10] + "."
            + socket.gethostname())
        self._ev = open(self.path, "ab")
        self._ev.write(tfrecord(event_bytes(time.time(),
                                            file_version="brain.Event:2")))

    def scalars(self, step: int, values: dict) -> None:
        row = {"step": int(step)}
        for k, v in values.items():
            if k == "step":
                continue
            row[k] = float(v.item() if isinstance(v, torch.Tensor) else v)
            self._ev.write(tfrecord(event_bytes(
                time.time(), int(step),
                values=[scalar_value(clean_tag(k), row[k])])))
        self._f.write(json.dumps(row) + "\n")

    def histograms(self, step: int, values: dict) -> None:
        for k, v in values.items():
            arr = np.asarray(v)
            if arr.size:
                self._ev.write(tfrecord(event_bytes(
                    time.time(), int(step), values=[histogram_value(
                        clean_tag(k), make_histogram(arr))])))

    def flush(self) -> None:
        self._f.flush()
        self._ev.flush()

    def close(self) -> None:
        self._f.close()
        self._ev.close()


# ---------------------------------------------------------- histogram set


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(
        t, torch.Tensor) and t.is_floating_point() else (
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t))


def _moments(name: str, arr: np.ndarray, out: dict) -> None:
    """tf.nn.moments(x, [-1]): <name>_u (mean), <name>_v (variance)
    (model.py:29-30, 40-41, 50-52)."""
    out[name] = arr
    out[name + "_u"] = arr.mean(axis=-1)
    out[name + "_v"] = arr.var(axis=-1)


def tree_paths(tree, prefix=()):
    """(path, leaf) pairs, dict keys sorted, list entries as "[i]" (the
    names jax.tree_util.tree_flatten_with_path gives)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (f"[{i}]",))
    else:
        yield "/".join(prefix), tree


def summary_histograms(params, summaries: dict) -> dict:
    """The reference's histogram dict (JAX training/metrics.py:41-89) from
    the post-step params and ``train_step(..., with_summaries=True)``'s
    tensors: z_e, the codebook and the speaker embedding with their
    moments, distances, q(z|x), e_k, a kernel per layer
    (wavenet/layer_{i}/kernel) and of the heads, and gradients/<path> for
    every leaf.  Values are numpy arrays."""
    h = {}
    _moments("z_e", _np(summaries["z_e"]), h)
    if "vq" in params:
        _moments("embedding", _np(params["vq"]["embedding"]), h)
    spk = params.get("speaker_embedding", params.get("speaker_emb"))
    if spk is not None:
        _moments("speaker_embedding", _np(spk), h)
    if "distances" in summaries:
        h["distances"] = _np(summaries["distances"])
    if "q_z_x" in summaries:
        h["q(z|x)"] = _np(summaries["q_z_x"])
    if "e_k" in summaries:
        h["e_k"] = _np(summaries["e_k"])
    dec = params.get("decoder", {})
    layers = dec.get("layers", {})
    if "kernel" in layers:
        kern = _np(layers["kernel"])
        for i in range(kern.shape[0]):
            h[f"wavenet/layer_{i}/kernel"] = kern[i]
    for name in ("preprocess", "skip_start", "postprocess1", "postprocess2"):
        if name in dec and "kernel" in dec[name]:
            h[f"wavenet/{name}/kernel"] = _np(dec[name]["kernel"])
    if "grads" in summaries:
        for name, leaf in tree_paths(summaries["grads"]):
            h[f"gradients/{name}"] = _np(leaf)
    return h


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
