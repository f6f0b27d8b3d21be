"""Scene dataset: COLMAP capture -> camera list + scene extent.

JAX counterpart: ``dge_tpu/scene/dataset.py`` (numpy only). Ported:
``ColmapScene``, ``nerfpp_norm``, ``_fovs_for_target`` and
``subsample_views``; the Blender loader, ``load_scene`` and
``sort_cameras_ring`` have no caller on the ported paths.

Reference analogs: CamScene (gaussiansplatting/scene/camera_scene.py:17-42),
readColmapCameras_hw with its aspect-preserving FoV rescale
(dataset_readers.py:69-122) and getNerfppNorm (dataset_readers.py:46-67).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from dge_tpu_torch.scene import colmap
from dge_tpu_torch.scene.cameras import Camera, focal2fov, qvec2rotmat


def nerfpp_norm(cameras: Sequence[Camera]) -> dict:
    """Camera-extent estimate (getNerfppNorm, dataset_readers.py:46-67):
    radius = 1.1 * max distance from the mean camera center."""
    centers = np.stack([c.camera_center for c in cameras], axis=0)
    center = centers.mean(axis=0)
    diag = np.linalg.norm(centers - center, axis=1).max()
    return {"translate": -center, "radius": float(diag * 1.1)}


def _fovs_for_target(intr: colmap.ColmapCamera, height: int, width: int):
    """Aspect-preserving FoV rescale (readColmapCameras_hw,
    dataset_readers.py:88-112)."""
    oh, ow = intr.height, intr.width
    origin_aspect = oh / ow
    aspect = height / width
    if intr.model == "SIMPLE_PINHOLE":
        f = intr.params[0]
        return focal2fov(f, width), focal2fov(f, height)
    if intr.model == "PINHOLE":
        fx, fy = intr.params[0], intr.params[1]
    elif intr.model in ("SIMPLE_RADIAL", "RADIAL"):
        fx = fy = intr.params[0]
    else:
        raise ValueError(
            f"COLMAP camera model {intr.model} not supported (undistort first)"
        )
    if origin_aspect > aspect:  # shrink height
        fovy = focal2fov(fy, ow * aspect)
        fovx = focal2fov(fx, ow)
    else:  # shrink width
        fovy = focal2fov(fy, oh)
        fovx = focal2fov(fx, oh / aspect)
    return fovx, fovy


def _sparse_dir(source_path: str) -> str:
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    return sparse


class ColmapScene:
    """Cameras + extent from a COLMAP capture directory (CamScene analog)."""

    def __init__(
        self,
        source_path: str,
        height: int = 512,
        width: int = 512,
        images_dir: str = "images",
    ):
        sparse = _sparse_dir(source_path)
        if not os.path.isdir(sparse):
            raise FileNotFoundError(f"no COLMAP sparse dir under {source_path}")
        cams, images = colmap.load_sparse(sparse)

        cameras: List[Camera] = []
        for uid, key in enumerate(sorted(images, key=lambda k: images[k].name)):
            im = images[key]
            intr = cams[im.camera_id]
            fovx, fovy = _fovs_for_target(intr, height, width)
            cameras.append(
                Camera(
                    R=qvec2rotmat(im.qvec).T,
                    T=im.tvec,
                    fovx=fovx,
                    fovy=fovy,
                    height=height,
                    width=width,
                    uid=uid,
                    colmap_id=im.id,
                    image_name=os.path.splitext(os.path.basename(im.name))[0],
                )
            )
        self.cameras = cameras
        self.cameras_extent = nerfpp_norm(cameras)["radius"]
        self.source_path = source_path
        self.images_dir = os.path.join(source_path, images_dir)

    def point_cloud(self) -> Tuple[np.ndarray, np.ndarray]:
        sparse = _sparse_dir(self.source_path)
        pb = os.path.join(sparse, "points3D.bin")
        if os.path.exists(pb):
            return colmap.read_points3d_binary(pb)
        return colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))


def subsample_views(cameras: Sequence[Camera], max_views: int,
                    seed: int = 0) -> List[Camera]:
    """An evenly spread subset of at most ``max_views`` cameras
    (gs_load.py max_view_num=20 semantics); ``seed`` is unused, as in the
    JAX function."""
    n = len(cameras)
    if n <= max_views:
        return list(cameras)
    idx = np.linspace(0, n - 1, max_views).round().astype(int)
    return [cameras[i] for i in idx]
