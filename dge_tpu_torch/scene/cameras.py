"""Cameras for the 3DGS scene layer.

JAX counterpart: ``dge_tpu/scene/cameras.py`` (numpy only; a copy, so that
this package imports nothing of ``dge_tpu``).

Math conventions follow the reference scene layer so that pretrained scenes and
COLMAP captures load bit-identically:

- ``getWorld2View2`` (reference gaussiansplatting/utils/graphics_utils.py:40-51):
  ``w2c[:3,:3] = R.T``, ``w2c[:3,3] = t`` where ``R`` is the camera-to-world
  rotation and ``t`` the world-to-camera translation (COLMAP tvec), with an
  optional recentring translate/scale applied to the camera center.
- ``getProjectionMatrix`` (graphics_utils.py:67-87): OpenGL-style perspective
  with z mapped to [0, zfar/(zfar-znear)] and w = z_view.
- The reference stores *transposed* (row-vector) matrices on its cameras
  (scene/cameras.py:92-95); we store standard column-vector math matrices.
- NDC to pixel: ``ndc2pix(v, S) = ((v + 1) * S - 1) / 2``
  (cuda_rasterizer/auxiliary.h:40-43).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion to rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def world_to_view(
    R: np.ndarray,
    t: np.ndarray,
    translate: Optional[np.ndarray] = None,
    scale: float = 1.0,
) -> np.ndarray:
    """World-to-camera 4x4 (column-vector convention: x_cam = w2c @ x_world).

    Mirrors getWorld2View2 (graphics_utils.py:40-51) including the recentring
    translate/scale of the camera center.
    """
    w2c = np.zeros((4, 4), dtype=np.float64)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = t
    w2c[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        c2w = np.linalg.inv(w2c)
        c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
        w2c = np.linalg.inv(c2w)
    return w2c.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, identical to getProjectionMatrix
    (graphics_utils.py:67-87)."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_half_fovx
    P[1, 1] = 1.0 / tan_half_fovy
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera with precomputed rasterization matrices.

    Reference analog: Simple_Camera (gaussiansplatting/scene/cameras.py:59-99).
    All matrices use the standard column-vector convention.
    """

    R: np.ndarray  # (3,3) camera-to-world rotation
    T: np.ndarray  # (3,) world-to-camera translation (COLMAP tvec)
    fovx: float
    fovy: float
    height: int
    width: int
    znear: float = 0.01
    zfar: float = 100.0
    uid: int = 0
    colmap_id: int = 0
    image_name: str = ""
    trans: Optional[np.ndarray] = None
    scale: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "R", np.asarray(self.R, dtype=np.float64))
        object.__setattr__(self, "T", np.asarray(self.T, dtype=np.float64))

    # --- matrices (standard math convention) ---
    @property
    def w2c(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale)

    @property
    def c2w(self) -> np.ndarray:
        return np.linalg.inv(self.w2c.astype(np.float64)).astype(np.float32)

    @property
    def proj(self) -> np.ndarray:
        return projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)

    @property
    def full_proj(self) -> np.ndarray:
        return (self.proj.astype(np.float64) @ self.w2c.astype(np.float64)).astype(
            np.float32
        )

    @property
    def camera_center(self) -> np.ndarray:
        return self.c2w[:3, 3]

    # --- the reference's transposed (row-vector) forms, cameras.py:92-95 ---
    @property
    def world_view_transform_t(self) -> np.ndarray:
        return self.w2c.T

    @property
    def full_proj_transform_t(self) -> np.ndarray:
        return self.full_proj.T

    # --- intrinsics ---
    @property
    def tan_half_fovx(self) -> float:
        return math.tan(self.fovx / 2.0)

    @property
    def tan_half_fovy(self) -> float:
        return math.tan(self.fovy / 2.0)

    @property
    def focal_x(self) -> float:
        return fov2focal(self.fovx, self.width)

    @property
    def focal_y(self) -> float:
        return fov2focal(self.fovy, self.height)

    @classmethod
    def from_c2w(cls, c2w: np.ndarray, fovy: float, height: int, width: int,
                 **kw) -> "Camera":
        """From a camera-to-world matrix (C2W_Camera / MiniCam analog,
        scene/cameras.py:102-154); ``fovx`` follows from ``fovy`` and the
        aspect."""
        w2c = np.linalg.inv(np.asarray(c2w, np.float64))
        fovx = focal2fov(fov2focal(fovy, height), width)
        return cls(R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fovx, fovy=fovy,
                   height=height, width=width, **kw)

    def resized(self, height: int, width: int) -> "Camera":
        """The same pose and FoV at another resolution (HW_scale,
        cameras.py:97-99)."""
        return dataclasses.replace(self, height=height, width=width)


def camera_arrays(cam: Camera, device="cuda"):
    """``cam`` as the rasterizer's ``CameraArrays`` on ``device``."""
    from dge_tpu_torch.scene.camera_arrays import CameraArrays

    return CameraArrays.from_camera(cam, device=device)


def look_at_camera(
    eye: np.ndarray,
    target: np.ndarray,
    up: np.ndarray = np.array([0.0, 1.0, 0.0]),
    fovx: float = math.radians(60.0),
    fovy: Optional[float] = None,
    height: int = 512,
    width: int = 512,
    **kw,
) -> Camera:
    """Construct a camera looking from ``eye`` to ``target`` (+z forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    # rows of w2c rotation = camera axes in world frame
    Rw2c = np.stack([right, down, fwd], axis=0)
    R = Rw2c.T  # camera-to-world rotation, reference convention
    T = -Rw2c @ eye
    if fovy is None:
        fovy = focal2fov(fov2focal(fovx, width), height)
    return Camera(R=R, T=T, fovx=fovx, fovy=fovy, height=height, width=width, **kw)
