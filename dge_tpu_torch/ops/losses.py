"""Image metrics for the render slice: PSNR.

JAX counterpart: ``dge_tpu/ops/losses.py`` (psnr, utils/image_utils.py:17
in the reference). ``l1_loss``, ``ssim`` and the LR schedule belong to the
training slice. Images are [H, W, C] float in [0, 1].
"""

from __future__ import annotations

import torch


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
