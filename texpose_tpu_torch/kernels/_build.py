"""Build-at-first-use for the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/texpose_tpu_torch/<name>-<hash>.so`` at
the root of the checkout, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, then loaded with ``ctypes``.  Nothing is compiled or loaded at import time; a
missing ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..ops.consts import device_const

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "texpose_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the texpose_tpu_torch CUDA kernels are compiled "
        "from csrc/ at first use and need the CUDA toolkit (set CUDA_HOME)")


def build(name):
    """Compile csrc/<name>.cu unless a build with the same hash exists;
    returns the shared library's path."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    so = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(name, functions):
    """The loaded library for csrc/<name>.cu.  functions: {symbol:
    argtypes}; every symbol returns a cudaError_t as int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for sym, argtypes in functions.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(err, what):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {err})")


def stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def device_ints(values, device):
    """A tuple of ints as an int32 tensor on ``device``, copied once
    (ops/consts.py ``device_const``): the host tables the kernels read on
    every step.  Read-only."""
    return device_const(values, torch.int32, device)
