"""ctypes loader for the native C++ rasterizer (``csrc/raster.cpp``, a copy of
the JAX package's).

The shared library is built with g++ at first use into
``build/texpose_tpu_torch/raster-<digest>.so`` at the root of the checkout,
keyed by a digest of the source, the flags and the host CPU g++ targets
with ``-march=native`` (a build copied to another machine is rebuilt
there).  Nothing is built at import time.  A build or load that fails
raises: there is no quiet swap to another backend.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "raster.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "texpose_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _cxx():
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found: the native rasterizer is compiled from "
            f"{SRC.name} at first use (pass backend='torch' to rasterize "
            "with PyTorch instead)")
    return cxx


def build():
    """Compile csrc/raster.cpp unless a build with the same digest exists;
    returns the shared library's path."""
    cxx = _cxx()
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True)
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode() + target.stdout.encode())
    so = BUILD_DIR / f"raster-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_library():
    """Build (if needed) and load the rasterizer library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.rasterize_mesh.argtypes = [
                f32p, i32p, ctypes.c_int32, ctypes.c_int32, f32p,
                ctypes.c_int32, ctypes.c_int32, f32p, i32p, f32p]
            lib.rasterize_mesh.restype = None
            lib.interpolate_attributes.argtypes = [
                i32p, i32p, f32p, f32p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, f32p]
            lib.interpolate_attributes.restype = None
            _lib = lib
    return _lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def rasterize(verts_cam, faces, K, H, W):
    """verts_cam [V,3] f32 camera-frame, faces [F,3] i32, K [3,3] →
    (zbuf [H,W], face_id [H,W] (-1 = bg), bary [H,W,3]), numpy."""
    lib = load_library()
    verts_cam = np.ascontiguousarray(verts_cam, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    K = np.ascontiguousarray(K, np.float32).reshape(9)
    zbuf = np.zeros((H, W), np.float32)
    face_id = np.full((H, W), -1, np.int32)
    bary = np.zeros((H, W, 3), np.float32)
    lib.rasterize_mesh(_f32p(verts_cam), _i32p(faces), len(verts_cam),
                       len(faces), _f32p(K), H, W, _f32p(zbuf),
                       _i32p(face_id), _f32p(bary))
    return zbuf, face_id, bary


def interpolate(faces, face_id, bary, attrs):
    """Per-vertex attrs [V,C] interpolated at rasterized pixels →
    [H,W,C] (0 at background), numpy."""
    lib = load_library()
    faces = np.ascontiguousarray(faces, np.int32)
    face_id = np.ascontiguousarray(face_id, np.int32)
    bary = np.ascontiguousarray(bary, np.float32)
    attrs = np.ascontiguousarray(attrs, np.float32)
    H, W = face_id.shape
    C = attrs.shape[1]
    out = np.zeros((H, W, C), np.float32)
    lib.interpolate_attributes(_i32p(faces), _i32p(face_id), _f32p(bary),
                               _f32p(attrs), len(faces), C, H, W,
                               _f32p(out))
    return out
