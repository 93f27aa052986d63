"""Build the hand-written CUDA kernels (``vqvae_wavenet_torch/csrc/*.cu``)
at first use and load them with ctypes.

Each source is compiled on its own by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of the ``csrc``
headers it includes (``#include "x.cuh"``), so an edited source or header
is rebuilt.  The build directory, ``build/torch_kernels`` at the
repository root, is listed in .gitignore.  ``build`` compiles several
sources at once (one nvcc process each); ptxas's report of each kernel's
registers, shared memory and spills is kept in ``ptxas_info``.  Processes
that build at once (the ranks of a sequence-parallel run) take an
exclusive lock on ``build/torch_kernels/.lock`` around the check and the
build, so each library is compiled once and the others load it.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` as an int; ``check`` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds spent in nvcc per source, and ptxas's report (read by chip_smoke.py)
build_seconds: Dict[str, float] = {}
ptxas_info: Dict[str, str] = {}
_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (CUDA toolkit required)")


def _library_path(name: str) -> str:
    """build/torch_kernels/<name>-<hash of the source and its headers>.so"""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    seen, todo = set(), [src]
    while todo:                     # the source, then the headers it includes
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(text)
        todo += [os.path.join(os.path.dirname(path), inc.decode())
                 for inc in _INCLUDE.findall(text)]
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> None:
    """Compile every named source whose library is missing, all nvcc
    processes at once; raise if any fails.  Holds the build directory's
    lock meanwhile (another process's build of the same sources waits)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_locked(names)


def _build_locked(names: Iterable[str]) -> None:
    procs = []
    for name in names:
        so = _library_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, f"{name}.cu")
        procs.append((name, so, tmp, time.perf_counter(), subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, t0, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
            continue
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
        ptxas_info[name] = out + err
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, compiling it if no
    library for the current source and headers exists."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        build([name])
        lib = ctypes.CDLL(_library_path(name))
        _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error (every source
    exports ``const char* vqw_error_string(int)``)."""
    if err != 0:
        lib.vqw_error_string.restype = ctypes.c_char_p
        lib.vqw_error_string.argtypes = [ctypes.c_int]
        msg = lib.vqw_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
