"""The port's ctypes binding of the repo's native C++ data loader
(cpp/dataloader.cpp; the counterpart of
vqvae_wavenet_tpu/data/native_loader.py).

The library is built from the source with g++ at first use into
``build/native_loader/`` (gitignored; the file name carries a hash of the
source, and a build lands by an atomic rename, so concurrent processes
never load a half-written file); nothing is written into ``cpp/``.
``NativeLoader.next()`` returns the python Dataset's host batch
({'x': [B, max_len, 1] float32, 'y': one-hot [B, 1, S]}) from a pool of
worker threads, each with its own mt19937_64 stream seeded from the seed
(one thread gives one reproducible order).  The loader reads 16 kHz PCM16
wavs only; ``data.make_input_pipeline`` decides when it is eligible.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "cpp", "dataloader.cpp")
BUILD_DIR = os.path.join(REPO, "build", "native_loader")
QUEUE_BATCHES = 8      # batches the workers may read ahead


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libvqwavenet_dataloader-{digest}.so")


@functools.lru_cache(maxsize=None)
def _load_lib():
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-Wall",
                            "-pthread", "-shared", "-o", tmp, SOURCE],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(path)
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64]
    lib.dl_next.restype = ctypes.c_int
    lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int32)]
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    lib.dl_read_wav.restype = ctypes.c_int64
    lib.dl_read_wav.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64]
    return lib


def build_error() -> Optional[str]:
    """None when the library builds and loads, else the reason."""
    try:
        _load_lib()
        return None
    except (OSError, subprocess.CalledProcessError) as e:
        err = getattr(e, "stderr", None)
        return f"{e}" + (f": {err.decode(errors='replace')[-400:]}"
                         if err else "")


def read_wav_native(path: str) -> Optional[np.ndarray]:
    """A 16-bit PCM wav through the native parser, (int16 + 0.5) /
    32767.5 as float32; None if the file is not one."""
    lib = _load_lib()
    n = lib.dl_read_wav(path.encode(), None, 0)
    if n < 0:
        return None
    out = np.empty(n, np.float32)
    lib.dl_read_wav(path.encode(),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    return out


class NativeLoader:
    """Batches of random crops of ``files`` (absolute wav paths, speaker
    index ``speaker_ids[i]`` each) from ``num_threads`` C++ workers."""

    def __init__(self, files, speaker_ids, num_speakers: int,
                 batch_size: int, max_len: int, num_threads: int = 4,
                 seed: int = 0):
        self._lib = _load_lib()
        self.batch_size = batch_size
        self.max_len = max_len
        self.num_speakers = num_speakers
        self.num_threads = num_threads
        spk = np.asarray(speaker_ids, np.int32)
        self._handle = self._lib.dl_create(
            "\n".join(files).encode(),
            spk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(files),
            batch_size, max_len, num_threads, QUEUE_BATCHES,
            ctypes.c_uint64(seed))
        if not self._handle:
            raise RuntimeError("dl_create failed (files and speakers do not "
                               "match)")

    def next(self):
        x = np.empty((self.batch_size, self.max_len), np.float32)
        s = np.empty((self.batch_size,), np.int32)
        if not self._lib.dl_next(
                ctypes.c_void_p(self._handle),
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))):
            raise RuntimeError("the native loader stopped")
        y = np.zeros((self.batch_size, 1, self.num_speakers), np.float32)
        y[np.arange(self.batch_size), 0, s] = 1.0
        return {"x": x[..., None], "y": y}

    def stop(self):
        if getattr(self, "_handle", None):
            self._lib.dl_destroy(ctypes.c_void_p(self._handle))
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
