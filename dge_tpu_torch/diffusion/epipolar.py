"""Epipolar geometry for the cross-view attention constraints (float32, as
in the JAX package).

JAX counterpart: ``dge_tpu/diffusion/epipolar.py``. Reference analogs:
fundamental_from_projections (gaussiansplatting/utils/graphics_utils.py:
134-182, Hartley & Zisserman eq. 17.3), get_fundamental_matrix_with_H
(:353-369), compute_epipolar_constrains / point_to_line_dist
(threestudio/utils/dge_utils.py:61-71, 154-187).

F satisfies x2^T F x1 = 0 for pixel coords x1 in cam1 and x2 in cam2.
``violation_mask[i, j]`` is True when cam1 pixel j is farther than
``threshold`` px from the epipolar line of cam2 pixel i. Every function
takes batched matrices (leading axes) as well.
"""

from __future__ import annotations

import torch


def fundamental_from_projections(P1: torch.Tensor,
                                 P2: torch.Tensor) -> torch.Tensor:
    """F [..., 3, 3] from pixel-space projections [..., 3, 4] such that
    x2^T F x1 = 0."""

    def rows(P):
        return [P[..., 1:3, :],
                torch.cat([P[..., 2:3, :], P[..., 0:1, :]], dim=-2),
                P[..., 0:2, :]]

    x, y = rows(P1), rows(P2)
    dets = [torch.linalg.det(torch.cat([xi, yj], dim=-2))
            for yj in y for xi in x]
    return torch.stack(dets, dim=-1).reshape(P1.shape[:-2] + (3, 3))


def pixel_projection(full_proj: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """[..., 3, 4] pixel-space projection: the full projection without its
    z row, composed with NDC -> pixel (graphics_utils.py:353-369)."""
    ndc2pix = torch.tensor([[width / 2.0, 0.0, width / 2.0],
                            [0.0, height / 2.0, height / 2.0],
                            [0.0, 0.0, 1.0]], dtype=torch.float32,
                           device=full_proj.device)
    return ndc2pix @ full_proj[..., [0, 1, 3], :]


def fundamental_between(cam1, cam2, height: int, width: int) -> torch.Tensor:
    """get_fundamental_matrix_with_H analog; height/width are the current
    (latent) resolution."""
    return fundamental_from_projections(
        pixel_projection(cam1.full_proj, height, width),
        pixel_projection(cam2.full_proj, height, width))


def pixel_grid(height: int, width: int, device=None) -> torch.Tensor:
    """Homogeneous pixel coords in raster order (y*W + x), [S, 3]."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(height * width, device=device)], dim=1)


def epipolar_lines(F: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[..., S2, 3] normalised epipolar lines in cam1's pixel space, one per
    cam2 pixel: violation(s2, s1) = |lines[s2] . pts[s1]| > threshold."""
    lines = pixel_grid(height, width, F.device) @ F
    den = torch.linalg.vector_norm(lines[..., :2], dim=-1, keepdim=True)
    return lines / torch.clamp(den, min=1e-12)


def epipolar_distances(F: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """[..., S2, S1] distances from every cam1 pixel to the epipolar line of
    every cam2 pixel, as |normalised line . pt| (the operation order of the
    banded path, so that the dense oracle and the banded test round alike)."""
    pts = pixel_grid(height, width, F.device)
    return (epipolar_lines(F, height, width) @ pts.T).abs()


def violation_mask(cam1, cam2, height: int, width: int,
                   threshold: float = 1.0) -> torch.Tensor:
    """Dense bool [S, S] violation mask (compute_epipolar_constrains)."""
    F = fundamental_between(cam1, cam2, height, width)
    return epipolar_distances(F, height, width) > threshold


def camera_distances(cams_a, cams_b) -> torch.Tensor:
    """Pairwise camera-centre distances [Na, Nb] (compute_camera_distance,
    dge_utils.py:359-367); takes centres [N, 3] or stacked cameras."""
    a = cams_a if isinstance(cams_a, torch.Tensor) else cams_a.campos
    b = cams_b if isinstance(cams_b, torch.Tensor) else cams_b.campos
    return torch.linalg.vector_norm(a[:, None, :] - b[None, :, :], dim=-1)
