"""The port's own ctypes bridge to ``native/dge_native.cpp``: the KNN scale
initialisation and the COLMAP ``points3D.bin`` parser.

JAX counterpart: ``dge_tpu/native.py`` (``knn_mean_sq_dist``,
``colmap_points3d``; its PLY block reader has no caller there either). The
library is built with ``g++`` at first use into ``build/`` at the repository
root, keyed by a hash of the source (``native/`` holds the JAX package's own
library and is left alone). Both routes are host code: the native grid-hash
KNN when a toolchain is present, scipy's ``cKDTree`` otherwise, as in the
reference; the points parser falls back to the Python record loop of
``scene/colmap.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "dge_native.cpp")
BUILD_DIR = os.path.join(_REPO, "build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    """build/libdge_native_<hash>.so, compiled unless already there; None
    when the source or the compiler is missing or the build fails."""
    try:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(BUILD_DIR, f"libdge_native_{digest}.so")
        if os.path.exists(lib_path):
            return lib_path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        res = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            capture_output=True, timeout=120)
        if res.returncode != 0:
            os.unlink(tmp)
            return None
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        return lib_path
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.dge_knn_mean_sq_dist.restype = ctypes.c_int
        lib.dge_knn_mean_sq_dist.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.dge_colmap_points3d_count.restype = ctypes.c_int64
        lib.dge_colmap_points3d_count.argtypes = [ctypes.c_char_p]
        lib.dge_colmap_points3d_read.restype = ctypes.c_int
        lib.dge_colmap_points3d_read.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def knn_native(points: np.ndarray, k: int = 3) -> Optional[np.ndarray]:
    """The native grid-hash route; None when the library is unavailable or
    refuses the input."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(len(pts), np.float32)
    rc = lib.dge_knn_mean_sq_dist(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts), k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def knn_scipy(points: np.ndarray, k: int = 3) -> np.ndarray:
    """The scipy cKDTree route."""
    from scipy.spatial import cKDTree

    pts = np.ascontiguousarray(points, dtype=np.float32)
    d, _ = cKDTree(pts).query(pts, k=k + 1)
    return np.mean(d[:, 1:] ** 2, axis=1).astype(np.float32)


def knn_mean_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance to the k nearest neighbours (distCUDA2 analog,
    simple_knn.cu:185-218). Native grid-hash when available, scipy KDTree
    otherwise."""
    out = knn_native(points, k)
    return out if out is not None else knn_scipy(points, k)


def colmap_points3d(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The native ``points3D.bin`` parse → (xyz [N, 3] float64, rgb [N, 3]
    float32 in [0, 1]); None when the library is unavailable or refuses the
    file."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.dge_colmap_points3d_count(path.encode())
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    rc = lib.dge_colmap_points3d_read(
        path.encode(), n,
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return xyz, rgb.astype(np.float32) / 255.0
