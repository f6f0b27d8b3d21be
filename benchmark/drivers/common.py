"""What the drivers share: the scene and cameras handed to the program and
to the reference, and the comparison arithmetic."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.yardstick import scene as S


def scene_arrays(cell) -> Dict[str, np.ndarray]:
    """The seed's ground-truth scene (``scene_scale`` < 1 only in tests)."""
    return S.gt_scene(cell.seed % (1 << 63),
                      sh_degree=int(cell.config["sh_degree"]),
                      sh_rest_std=float(cell.config["assumed"]["sh_rest_std"]),
                      scale=float(cell.config.get("scene_scale", 1.0)))


def program_scene(arrays: Dict[str, np.ndarray], sh_degree: int, device):
    """The arrays as the program's ``GaussianScene`` (all bands active)."""
    from dge_tpu_torch.scene import gaussians as G

    return G.from_arrays(arrays["xyz"], arrays["features_dc"],
                         arrays["features_rest"], arrays["opacity"],
                         arrays["scaling"], arrays["rotation"],
                         max_sh_degree=sh_degree, active_sh_degree=sh_degree,
                         device=device)


def program_camera(cam: dict, device):
    from dge_tpu_torch.scene.camera_arrays import CameraArrays

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(device)

    return CameraArrays(w2c=f32(cam["w2c"]), full_proj=f32(cam["full_proj"]),
                        campos=f32(cam["campos"]),
                        tan_half_fovx=f32(cam["tan_half_fovx"]),
                        tan_half_fovy=f32(cam["tan_half_fovy"]),
                        height=cam["height"], width=cam["width"])


def reference_camera(cam: dict, device) -> dict:
    out = dict(cam)
    for k in ("w2c", "full_proj", "campos"):
        out[k] = torch.as_tensor(np.asarray(cam[k], np.float32)).to(device)
    return out


def reference_params(arrays: Dict[str, np.ndarray], device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """Round to 8-bit levels, as an image file would hold it."""
    return torch.floor(torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5) / 255.0


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}
