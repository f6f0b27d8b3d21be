"""Spherical-harmonics color evaluation.

JAX counterpart: ``dge_tpu/ops/sh.py``. Constants and band structure match
the reference (cuda_rasterizer/auxiliary.h:21-38, utils/sh_utils.py:57-110).
All bands up to ``max_degree`` are evaluated and bands above
``active_degree`` are masked to zero. The band sum is an elementwise
multiply and sum, not a matmul, so it is full f32 on every device.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

# band index of each SH coefficient, for degree masking
_BAND = (0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3)


def sh_basis(dirs: torch.Tensor, max_degree: int) -> torch.Tensor:
    """SH basis values for unit directions. dirs [..., 3] -> [..., K]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if max_degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if max_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if max_degree >= 3:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if max_degree >= 4:
        raise NotImplementedError("SH degree > 3 (rasterizer parity is deg<=3)")
    return torch.stack(out, dim=-1)


def eval_sh_color(sh: torch.Tensor, dirs: torch.Tensor, active_degree: int,
                  max_degree: int):
    """SH -> clamped RGB, as computeColorFromSH (forward.cu:20-71).

    sh: [N, K, 3] coefficients; dirs: [N, 3] unit view directions.
    Returns ([N, 3] rgb, [N, 3] clamped mask)."""
    k = (max_degree + 1) ** 2
    basis = sh_basis(dirs, max_degree)  # [N, K]
    band = torch.tensor(_BAND[:k], device=sh.device)
    basis = basis * (band <= active_degree).to(sh.dtype)
    rgb = (basis[:, :, None] * sh[:, :k]).sum(dim=1) + 0.5
    clamped = rgb < 0.0
    return torch.clamp(rgb, min=0.0), clamped
