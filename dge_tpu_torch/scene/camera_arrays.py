"""Device-side camera used by the rasterizer.

JAX counterpart: ``dge_tpu/scene/camera_arrays.py`` (a flax pytree there; a
frozen dataclass of torch tensors here). Matrices use the standard
column-vector convention (see scene/cameras.py).
"""

from __future__ import annotations

import dataclasses

import torch

from dge_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class CameraArrays:
    w2c: torch.Tensor  # [4,4] world-to-camera
    full_proj: torch.Tensor  # [4,4] proj @ w2c
    campos: torch.Tensor  # [3] camera center in world
    tan_half_fovx: torch.Tensor  # f32 scalar
    tan_half_fovy: torch.Tensor  # f32 scalar
    height: int = 512
    width: int = 512

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tan_half_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tan_half_fovy)

    @classmethod
    def from_camera(cls, cam, device="cuda") -> "CameraArrays":
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32).to(dev)

        return cls(
            w2c=f32(cam.w2c),
            full_proj=f32(cam.full_proj),
            campos=f32(cam.camera_center),
            tan_half_fovx=f32(cam.tan_half_fovx),
            tan_half_fovy=f32(cam.tan_half_fovy),
            height=int(cam.height),
            width=int(cam.width),
        )
