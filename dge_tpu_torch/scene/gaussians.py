"""GaussianScene — the 3DGS parameter buffers as torch tensors.

JAX counterpart: ``dge_tpu/scene/gaussians.py`` (a flax pytree there; a
dataclass of tensors on one explicit device here). Parameters live in
fixed-capacity padded buffers with an ``alive`` mask; dead slots carry
``opacity=-10`` and ``scaling=-20`` so that every activation stays finite.

Parameterization matches the reference (gaussian_model.py:42-57): scaling
stored as log (activation exp), opacity as logit (sigmoid), rotation as an
unnormalized wxyz quaternion (normalize), SH features split into DC + rest.
In this system the Gaussian buffers are the weights; ``from_numpy_params``
carries a JAX scene's buffers across as numpy arrays. ``create_from_pcd``
initialises a scene for fitting from a coloured point cloud.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from dge_tpu_torch import resolve_device
from dge_tpu_torch.scene import ply as ply_io

# Trainable leaf names, in reference optimizer-group order
# (gaussian_model.py:346-357: xyz, f_dc, f_rest, opacity, scaling, rotation).
PARAM_NAMES = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
               "rotation")


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass
class GaussianScene:
    """Padded 3DGS parameter buffers. ``capacity`` rows; rows with
    ``alive == False`` are ignored by every kernel."""

    xyz: torch.Tensor  # [Np, 3]
    features_dc: torch.Tensor  # [Np, 1, 3] SH DC coefficients
    features_rest: torch.Tensor  # [Np, K-1, 3] higher-order SH
    opacity: torch.Tensor  # [Np, 1] logit
    scaling: torch.Tensor  # [Np, 3] log-scale
    rotation: torch.Tensor  # [Np, 4] wxyz quaternion (unnormalized)
    alive: torch.Tensor  # [Np] bool
    grad_mask: torch.Tensor  # [Np] f32; 1 = editable
    generation: torch.Tensor  # [Np] int32 densify generation tag
    active_sh_degree: int  # bands above it are zeroed
    max_sh_degree: int = 3

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    # ---- activations (gaussian_model.py:42-57, 206-268) ----
    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        q = self.rotation
        return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        """[Np, K, 3] full SH coefficient stack."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    # ---- trainable parameters ----
    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def replace(self, **changes) -> "GaussianScene":
        return dataclasses.replace(self, **changes)

    def with_params(self, params: Dict[str, torch.Tensor]) -> "GaussianScene":
        return self.replace(**params)

    def one_up_sh_degree(self) -> "GaussianScene":
        """Reference oneupSHdegree (gaussian_model.py:270-272)."""
        return self.replace(
            active_sh_degree=min(self.active_sh_degree + 1, self.max_sh_degree))


def _pad(arr: np.ndarray, capacity: int, fill=0.0) -> np.ndarray:
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < {n} points")
    pad = np.full((capacity - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def round_capacity(n: int, multiple: int = 4096) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def from_numpy_params(
    xyz: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    opacity: np.ndarray,
    scaling: np.ndarray,
    rotation: np.ndarray,
    alive: np.ndarray,
    active_sh_degree: int,
    max_sh_degree: int,
    device="cuda",
) -> GaussianScene:
    """A scene from already padded buffers (e.g. ``np.asarray`` of each leaf
    of a ``dge_tpu`` GaussianScene), copied as they are onto ``device``."""
    dev = resolve_device(device)
    alive = np.asarray(alive, dtype=bool)

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return GaussianScene(
        xyz=f32(xyz),
        features_dc=f32(features_dc),
        features_rest=f32(features_rest),
        opacity=f32(opacity),
        scaling=f32(scaling),
        rotation=f32(rotation),
        alive=torch.from_numpy(alive.copy()).to(dev),
        grad_mask=f32(alive.astype(np.float32)),
        generation=torch.zeros(alive.shape[0], dtype=torch.int32, device=dev),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree),
    )


def from_arrays(
    xyz: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    opacity: np.ndarray,
    scaling: np.ndarray,
    rotation: np.ndarray,
    max_sh_degree: int,
    capacity: Optional[int] = None,
    active_sh_degree: Optional[int] = None,
    device="cuda",
) -> GaussianScene:
    n = xyz.shape[0]
    cap = capacity or round_capacity(n)
    alive = np.zeros(cap, dtype=bool)
    alive[:n] = True
    k_rest = (max_sh_degree + 1) ** 2 - 1
    if features_rest.shape[1] != k_rest:
        fr = np.zeros((n, k_rest, 3), dtype=np.float32)
        fr[:, : features_rest.shape[1]] = features_rest
        features_rest = fr
    # Dead-slot safe defaults: identity quat so activations stay finite.
    rot_pad = np.zeros((cap, 4), dtype=np.float32)
    rot_pad[:, 0] = 1.0
    rot_pad[:n] = rotation
    return from_numpy_params(
        xyz=_pad(xyz.astype(np.float32), cap),
        features_dc=_pad(features_dc.astype(np.float32), cap),
        features_rest=_pad(features_rest.astype(np.float32), cap),
        opacity=_pad(opacity.astype(np.float32), cap, fill=-10.0),
        scaling=_pad(scaling.astype(np.float32), cap, fill=-20.0),
        rotation=rot_pad,
        alive=alive,
        active_sh_degree=(
            max_sh_degree if active_sh_degree is None else active_sh_degree
        ),
        max_sh_degree=max_sh_degree,
        device=device,
    )


def load_ply(
    path: str,
    capacity: Optional[int] = None,
    sh_degree: Optional[int] = None,
    device="cuda",
) -> GaussianScene:
    """Load a pretrained 3DGS PLY (reference load_ply,
    gaussian_model.py:455-551; active_sh_degree = max on load)."""
    raw = ply_io.load_gaussian_ply(path)
    deg = raw["max_sh_degree"] if sh_degree is None else sh_degree
    return from_arrays(
        raw["xyz"],
        raw["features_dc"],
        raw["features_rest"][:, : (deg + 1) ** 2 - 1],
        raw["opacity"],
        raw["scaling"],
        raw["rotation"],
        max_sh_degree=deg,
        capacity=capacity,
        active_sh_degree=deg,
        device=device,
    )


def save_ply(scene: GaussianScene, path: str) -> None:
    """Save alive Gaussians in the reference byte layout
    (gaussian_model.py:410-445)."""
    alive = scene.alive.cpu().numpy()

    def host(t):
        return t.detach().cpu().numpy()[alive]

    ply_io.save_gaussian_ply(
        path,
        host(scene.xyz),
        host(scene.features_dc),
        host(scene.features_rest),
        host(scene.opacity),
        host(scene.scaling),
        host(scene.rotation),
    )


def rgb_to_sh(rgb: np.ndarray) -> np.ndarray:
    """RGB2SH (utils/sh_utils.py:112-113): C0-normalized DC coefficient."""
    return (rgb - 0.5) / 0.28209479177387814


def sh_to_rgb(sh: np.ndarray) -> np.ndarray:
    return sh * 0.28209479177387814 + 0.5


def mean_sq_dist_to_3nn(points: np.ndarray) -> np.ndarray:
    """Mean squared distance to the 3 nearest neighbours per point
    (simple-knn distCUDA2, simple_knn.cu:185-218), used to initialise the
    Gaussian scales: the native grid-hash KNN (dge_tpu_torch/native.py) with
    a scipy KDTree fallback. Host code."""
    from dge_tpu_torch.native import knn_mean_sq_dist

    return knn_mean_sq_dist(np.asarray(points, np.float32), k=3)


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    max_sh_degree: int = 3,
    capacity: Optional[int] = None,
    device="cuda",
) -> GaussianScene:
    """Initialise from a coloured point cloud (reference create_from_pcd,
    gaussian_model.py:274-334): scales from the 3-NN mean squared distance,
    opacity 0.1, identity rotation, DC-only colour."""
    n = points.shape[0]
    dist2 = np.maximum(mean_sq_dist_to_3nn(points.astype(np.float64)), 1e-7)
    scaling = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1).astype(np.float32)
    rotation = np.zeros((n, 4), dtype=np.float32)
    rotation[:, 0] = 1.0
    opacity = np.full((n, 1), np.log(0.1 / 0.9), dtype=np.float32)
    features_dc = rgb_to_sh(colors.astype(np.float32)).reshape(n, 1, 3)
    features_rest = np.zeros((n, (max_sh_degree + 1) ** 2 - 1, 3),
                             dtype=np.float32)
    return from_arrays(
        points.astype(np.float32),
        features_dc,
        features_rest,
        opacity,
        scaling,
        rotation,
        max_sh_degree=max_sh_degree,
        capacity=capacity,
        active_sh_degree=0,
        device=device,
    )
