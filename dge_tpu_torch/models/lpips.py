"""LPIPS-style VGG16 perceptual distance.

JAX counterpart: ``dge_tpu/models/lpips.py``; reference analog
threestudio/utils/perceptual/perceptual.py. VGG16 features at relu{1_2,
2_2, 3_3, 4_3, 5_3}, unit-normalised along channels, squared differences
weighted by the ``|lin_i|`` heads (one weight a channel), averaged over
space and summed over the five stages.

- ``VGG16Features`` names its layers as torchvision's ``vgg16().features``
  (``features.N``: 13 convs with ReLU, 2x2 max-pool between the stages), so
  a local torchvision ``state_dict`` loads as it is
  (``load_torchvision``); no pool follows the last stage, as in JAX.
- ``LPIPS`` normalises the input (``_SHIFT`` / ``_SCALE`` after mapping
  [0, 1] to [-1, 1]) and starts each head at the constant 1/C, as the JAX
  module does.
- ``lpips_params_from_jax`` carries the JAX module's parameters across
  (``conv_i.kernel [3, 3, in, out]`` → ``[out, in, 3, 3]``);
  ``params_from_torchvision`` takes a torchvision VGG16 state dict.
- ``make_perceptual_fn`` returns ``(fn, params)``: ``fn(a, b)`` takes images
  ``[H, W, 3]`` or ``[B, H, W, 3]`` in [0, 1], as the JAX function does.

The convolutions are ``torch.nn.functional.conv2d``, as JAX leaves them to
XLA. On a card cuDNN runs them in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; the evaluation tool turns it
off around its LPIPS calls.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dge_tpu_torch import resolve_device

# VGG16 conv plan: (out_channels, n_convs) per stage; features tapped at the
# last ReLU of each stage
VGG16_STAGES: Tuple[Tuple[int, int], ...] = (
    (64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# ImageNet normalisation of the reference's ScalingLayer
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _torchvision_layout() -> Tuple[List[int], List[int]]:
    """Indices of the convs in torchvision's ``features`` and of the ReLU
    that ends each stage (conv, ReLU per conv, then a pool per stage)."""
    convs, taps, i = [], [], 0
    for ch, n in VGG16_STAGES:
        for _ in range(n):
            convs.append(i)
            i += 2
        taps.append(i - 1)
        i += 1  # the pool
    return convs, taps


class VGG16Features(nn.Module):
    """The 13 convs of VGG16 in torchvision's ``features.N`` layout → the
    five stage features, each [B, C, H, W]."""

    def __init__(self):
        super().__init__()
        self.taps = _torchvision_layout()[1]
        layers: List[nn.Module] = []
        c_in = 3
        for ch, n in VGG16_STAGES:
            for _ in range(n):
                layers += [nn.Conv2d(c_in, ch, 3, padding=1),
                           nn.ReLU(inplace=True)]
                c_in = ch
            layers.append(nn.MaxPool2d(2, 2))
        # the last pool follows the last tap and is never run
        self.features = nn.Sequential(*layers[:-1])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                feats.append(x)
        return feats

    def load_torchvision(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load the ``features.N`` convs of a torchvision VGG16 state dict
        (its ``classifier.*`` entries are not used)."""
        own = {k: v for k, v in state_dict.items()
               if re.match(r"features\.\d+\.(weight|bias)$", k)}
        self.load_state_dict(own, strict=True)


class LPIPS(nn.Module):
    """Perceptual distance of two batches [B, 3, H, W] in [0, 1] → scalar."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(VGG16_STAGES):
            self.register_parameter(
                f"lin_{i}", nn.Parameter(torch.full((ch,), 1.0 / ch)))
        for name, v in (("shift", _SHIFT), ("scale", _SCALE)):
            self.register_buffer(name, torch.from_numpy(v)[None, :, None, None],
                                 persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        def norm_input(x):
            return (x * 2.0 - 1.0 - self.shift) / self.scale

        fa = self.vgg(norm_input(a))
        fb = self.vgg(norm_input(b))
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True)
                       + 1e-10)
            nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True)
                       + 1e-10)
            w = getattr(self, f"lin_{i}").abs()[None, :, None, None]
            total = total + ((na - nb) ** 2 * w).sum(dim=1).mean()
        return total


def lpips_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX ``LPIPS`` parameters (``{"vgg": {"conv_i": {"kernel",
    "bias"}}, "lin_i": ...}``, as numpy) → this module's ``state_dict``
    entries: kernels ``[3, 3, in, out]`` become ``[out, in, 3, 3]``, the
    heads carry over as they are."""
    convs, _ = _torchvision_layout()
    sd = {}
    for i, tv in enumerate(convs):
        conv = params["vgg"][f"conv_{i}"]
        sd[f"vgg.features.{tv}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1)))
        sd[f"vgg.features.{tv}.bias"] = torch.from_numpy(
            np.asarray(conv["bias"], np.float32).copy())
    for i in range(len(VGG16_STAGES)):
        sd[f"lin_{i}"] = torch.from_numpy(
            np.asarray(params[f"lin_{i}"], np.float32).copy())
    return sd


def params_from_torchvision(state_dict: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """A torchvision VGG16 state dict → an ``LPIPS`` state dict: its
    ``features.N`` convs, heads at 1/C (as the JAX tool pairs converted VGG
    weights with the default heads)."""
    model = LPIPS()
    model.vgg.load_torchvision(state_dict)
    return model.state_dict()


def _init_random(model: LPIPS, generator: torch.Generator) -> None:
    """The JAX module's default init: truncated-normal kernels of variance
    1/fan_in (flax ``lecun_normal``), zero biases."""
    for m in model.vgg.features:
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * 9
            # the std of a normal truncated at +-2 std is 0.8796 of it
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)


def make_perceptual_fn(params: Optional[Dict[str, torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None,
                       device="cuda"):
    """Returns ``(fn(a, b) -> scalar, params)``. ``params`` is an ``LPIPS``
    state dict (``lpips_params_from_jax`` gives one); without it the convs
    are drawn from ``generator`` (a CPU ``torch.Generator``; seed 0 when
    none is given) and the heads are 1/C. The network lives on ``device``:
    the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    model = LPIPS()
    if params is None:
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        with torch.no_grad():
            _init_random(model, gen)
    else:
        model.load_state_dict(params)
    model = model.to(dev).eval()
    for p in model.parameters():
        p.requires_grad_(False)

    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.dim() == 3:
            a, b = a[None], b[None]
        return model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))

    return fn, model.state_dict()
