"""Build the hand-written CUDA kernels (``vqvae_wavenet_torch/csrc/*.cu``)
at first use and load them with ctypes.

Each source is compiled on its own by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, so an edited source is
rebuilt.  The build directory, ``build/torch_kernels`` at the repository
root, is listed in .gitignore.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` as an int; ``check`` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds spent in nvcc per source (read by chip_smoke.py)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (CUDA toolkit required)")


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, compiling it if no
    library for the current source hash exists."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
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
