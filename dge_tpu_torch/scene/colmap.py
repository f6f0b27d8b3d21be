"""COLMAP sparse-reconstruction parsing (binary and text).

JAX counterpart: ``dge_tpu/scene/colmap.py`` (numpy only; a copy).
``read_points3d_binary`` takes the port's native parser
(``dge_tpu_torch/native.py``, built from ``native/dge_native.cpp``) and falls
back to the Python record loop on a machine without a compiler;
``points_parser_counts`` counts which of the two read each file.

Reference analog: gaussiansplatting/scene/colmap_loader.py (282 LoC). The
formats are COLMAP's public on-disk layout; parsing is re-implemented with
numpy + struct.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * num_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (num_points,) = _read(f, "<Q")
            f.read(24 * num_points)  # skip 2D points (x, y, point3D_id)
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8")
            )
    return images


# files read by each points3D.bin parser since the process started
points_parser_counts = {"native": 0, "python": 0}


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz [N,3] float64, rgb [N,3] float32 in [0,1]) through the
    native parser, or the Python record loop where it cannot load."""
    from dge_tpu_torch.native import colmap_points3d

    native = colmap_points3d(path)
    if native is not None:
        points_parser_counts["native"] += 1
        return native
    points_parser_counts["python"] += 1
    return read_points3d_binary_python(path)


def read_points3d_binary_python(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """``read_points3d_binary`` through the pure-Python record loop."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.zeros((n, 3))
        rgb = np.zeros((n, 3), np.float32)
        for i in range(n):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = np.array(vals[4:7], np.float32) / 255.0
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    for ln in open(path):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        parts = ln.split()
        cams[int(parts[0])] = ColmapCamera(
            int(parts[0]),
            parts[1],
            int(parts[2]),
            int(parts[3]),
            np.array([float(p) for p in parts[4:]]),
        )
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    lines = [
        ln.strip()
        for ln in open(path)
        if ln.strip() and not ln.strip().startswith("#")
    ]
    for ln in lines[::2]:  # every other line is the 2D point list
        p = ln.split()
        images[int(p[0])] = ColmapImage(
            int(p[0]),
            np.array([float(x) for x in p[1:5]]),
            np.array([float(x) for x in p[5:8]]),
            int(p[8]),
            p[9],
        )
    return images


def read_points3d_text(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    for ln in open(path):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        p = ln.split()
        xyz.append([float(x) for x in p[1:4]])
        rgb.append([float(x) / 255.0 for x in p[4:7]])
    return np.array(xyz), np.array(rgb, np.float32)


def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            f.write(
                struct.pack(
                    "<iiQQ", cam.id, MODEL_NAME_TO_ID[cam.model], cam.width, cam.height
                )
            )
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(
    xyz: np.ndarray, rgb: np.ndarray, path: str
) -> None:
    """rgb in [0,1] floats or uint8."""
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(
                struct.pack(
                    "<QdddBBBd", i, *xyz[i].astype(float), *rgb[i], 0.0
                )
            )
            f.write(struct.pack("<Q", 0))


def load_sparse(sparse_dir: str):
    """Load (cameras, images) from a COLMAP sparse dir, preferring binary
    (reference readColmapSceneInfo, dataset_readers.py:163-189)."""
    cb = os.path.join(sparse_dir, "cameras.bin")
    ib = os.path.join(sparse_dir, "images.bin")
    if os.path.exists(cb) and os.path.exists(ib):
        return read_cameras_binary(cb), read_images_binary(ib)
    return (
        read_cameras_text(os.path.join(sparse_dir, "cameras.txt")),
        read_images_text(os.path.join(sparse_dir, "images.txt")),
    )
