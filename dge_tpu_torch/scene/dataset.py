"""Scene dataset: COLMAP capture -> camera list + scene extent.

JAX counterpart: ``dge_tpu/scene/dataset.py`` (numpy only; a copy of its
arithmetic): ``ColmapScene``, ``BlenderScene``, ``load_scene``,
``nerfpp_norm``, ``_fovs_for_target``, ``subsample_views`` and
``sort_cameras_ring``. ``--render`` / ``--test`` read their capture through
``load_scene``; the modes that need a point cloud or an images directory
(``--fit``, ``--validate``, ``--train``) read COLMAP only.

Reference analogs: CamScene (gaussiansplatting/scene/camera_scene.py:17-42),
readColmapCameras_hw with its aspect-preserving FoV rescale
(dataset_readers.py:69-122), getNerfppNorm (dataset_readers.py:46-67),
readCamerasFromTransforms (dataset_readers.py:199-359) and
DGE.sort_the_cameras_idx (threestudio/systems/DGE.py:588-600).
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

from dge_tpu_torch.scene import colmap
from dge_tpu_torch.scene.cameras import (Camera, focal2fov, fov2focal,
                                         qvec2rotmat)


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


class BlenderScene:
    """NeRF-synthetic (Blender) loader: ``transforms_{split}.json`` with
    ``camera_angle_x`` and camera-to-world ``transform_matrix`` frames in
    OpenGL axes (y up, z back), turned into the COLMAP convention. It holds
    no point cloud and no images directory: ``image_paths`` lists each
    frame's ``file_path`` under the capture (as written, no extension
    added)."""

    def __init__(self, source_path: str, split: str = "train",
                 height: int = 800, width: int = 800):
        path = os.path.join(source_path, f"transforms_{split}.json")
        with open(path) as f:
            meta = json.load(f)
        fovx = float(meta["camera_angle_x"])
        cameras: List[Camera] = []
        self.image_paths: List[str] = []
        for uid, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"], dtype=np.float64)
            # OpenGL -> COLMAP: flip the camera frame's y and z axes
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            fovy = focal2fov(fov2focal(fovx, width), height)
            cameras.append(Camera(
                R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fovx, fovy=fovy,
                height=height, width=width, uid=uid,
                image_name=os.path.basename(frame["file_path"])))
            self.image_paths.append(
                os.path.join(source_path, frame["file_path"]))
        self.cameras = cameras
        self.cameras_extent = nerfpp_norm(cameras)["radius"]
        self.source_path = source_path


def write_transforms(cameras: Sequence[Camera], source_path: str,
                     file_paths: Sequence[str], split: str = "train") -> str:
    """Write ``cameras`` as a Blender ``transforms_{split}.json`` under
    ``source_path`` (``camera_angle_x`` from the first camera, one frame a
    camera with its camera-to-world matrix in OpenGL axes and its
    ``file_path``), the inverse of ``BlenderScene``; returns the path."""
    frames = []
    for cam, fp in zip(cameras, file_paths):
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL, BlenderScene's flip undone
        frames.append({"file_path": fp, "transform_matrix": c2w.tolist()})
    os.makedirs(source_path, exist_ok=True)
    path = os.path.join(source_path, f"transforms_{split}.json")
    with open(path, "w") as f:
        json.dump({"camera_angle_x": float(cameras[0].fovx),
                   "frames": frames}, f, indent=1)
    return path


def load_scene(source_path: str, height: int = 512, width: int = 512):
    """The capture's scene by its layout (sceneLoadTypeCallbacks,
    dataset_readers.py:361-365): COLMAP ``sparse/`` first, else Blender
    ``transforms_train.json``."""
    if os.path.isdir(os.path.join(source_path, "sparse")):
        return ColmapScene(source_path, height=height, width=width)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return BlenderScene(source_path, height=height, width=width)
    raise FileNotFoundError(f"unrecognized scene type at {source_path}")


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


def sort_cameras_ring(cameras: Sequence[Camera]) -> List[int]:
    """Camera indices in order of their angle around the ring: the centres
    projected onto the two principal directions of their spread, sorted by
    ``arctan2`` (DGE's ring order for multi-view editing)."""
    centers = np.stack([c.camera_center for c in cameras], axis=0)
    rel = centers - centers.mean(axis=0)
    _, _, vt = np.linalg.svd(rel - rel.mean(0, keepdims=True),
                             full_matrices=False)
    uv = rel @ vt[:2].T
    return list(np.argsort(np.arctan2(uv[:, 1], uv[:, 0])))
