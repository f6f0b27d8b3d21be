"""Image losses: L1, windowed SSIM, PSNR, and the log-linear LR schedule.

JAX counterpart: ``dge_tpu/ops/losses.py``. Reference analogs: l1_loss / ssim
(gaussiansplatting/utils/loss_utils.py:17-63, 11x11 Gaussian window, sigma
1.5, C1=0.01^2, C2=0.03^2), psnr (utils/image_utils.py:17) and
get_expon_lr_func (utils/general_utils.py:29-62). Images are [H, W, C] float
in [0, 1].

The separable blur is two products with a banded [L, L] matrix of the window
taps (zero "same" padding falls out of the band), not a convolution: a float32
matmul runs in full float32 on the card by default, while a cuDNN convolution
would run in TF32.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@lru_cache(maxsize=16)
def _band_matrix(length: int, window_size: int, device: str) -> torch.Tensor:
    """[L, L] matrix B with B[i, j] = window[j - i + k//2]: B @ x is the
    zero-padded "same" correlation of x with the window along its rows."""
    w = _gaussian_window(window_size)
    half = window_size // 2
    i = np.arange(length)
    off = i[None, :] - i[:, None] + half
    band = np.where((off >= 0) & (off < window_size),
                    w[np.clip(off, 0, window_size - 1)], 0.0)
    return torch.from_numpy(band.astype(np.float32)).to(device)


def _blur(img: torch.Tensor, window_size: int) -> torch.Tensor:
    """Separable same-padded Gaussian blur over H, W of [..., H, W, C]."""
    h, w = img.shape[-3], img.shape[-2]
    bh = _band_matrix(h, window_size, str(img.device))
    bw = _band_matrix(w, window_size, str(img.device))
    out = torch.einsum("ij,...jwc->...iwc", bh, img)
    return torch.einsum("ij,...hjc->...hic", bw, out)


def ssim_map(a: torch.Tensor, b: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map with zero 'same' padding (loss_utils.py:38-63).
    Shape-preserving over [H, W, C]."""
    c1, c2 = 0.01**2, 0.03**2
    blurred = _blur(torch.stack([a, b, a * a, b * b, a * b]), window_size)
    mu1, mu2 = blurred[0], blurred[1]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = blurred[2] - mu1_sq
    sigma2 = blurred[3] - mu2_sq
    sigma12 = blurred[4] - mu12
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2)
    )


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM (loss_utils.py:38-63)."""
    return torch.mean(ssim_map(a, b, window_size))


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    max_steps: int,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
):
    """Log-linear LR interpolation with optional delayed warmup
    (get_expon_lr_func, utils/general_utils.py:29-62). Returns a host
    function step -> lr (a Python float)."""

    def schedule(step) -> float:
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0  # lr 0.0 disables the group
        step = float(step)
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(max(lr_init, 1e-30)) * (1 - t)
                            + math.log(max(lr_final, 1e-30)) * t)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        return delay_rate * log_lerp

    return schedule
