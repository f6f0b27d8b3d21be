"""SD AutoencoderKL (NCHW, diffusers parameter names).

JAX counterpart: ``dge_tpu/models/vae.py``. diffusers' AutoencoderKL with
the SD-1.5 config: 4 down blocks (128/256/512/512), 2 resnets per block, an
attention mid block, latent channels 4, scaling factor 0.18215. The
reference uses it through the InstructPix2Pix pipeline's ``vae.encode`` /
``vae.decode`` (dge_guidance.py:219-244).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dge_tpu_torch.models.layers import (Conv2d, Downsample2D, GroupNorm,
                                         Linear, ResnetBlock2D, Upsample2D,
                                         attend, from_tokens, to_tokens)

SD_VAE_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = SD_VAE_SCALE

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1,
                   norm_groups=8)


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the mid block (diffusers
    Attention with heads=1 on [B, H*W, C])."""

    def __init__(self, channels: int, groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6, dtype)
        self.to_q = Linear(channels, channels, dtype=dtype)
        self.to_k = Linear(channels, channels, dtype=dtype)
        self.to_v = Linear(channels, channels, dtype=dtype)
        self.to_out = nn.ModuleList([Linear(channels, channels, dtype=dtype),
                                     nn.Identity()])

    def forward(self, x):
        h, w = x.shape[2:]
        y = to_tokens(self.group_norm(x))
        y = attend(self.to_q(y), self.to_k(y), self.to_v(y), heads=1)
        return from_tokens(self.to_out[0](y), h, w) + x


class _Block(nn.Module):
    """A diffusers down / up / mid block: only holds its named children."""


def _mid(c, groups, dtype):
    blk = _Block()
    blk.resnets = nn.ModuleList([
        ResnetBlock2D(c, c, None, groups, 1e-6, dtype),
        ResnetBlock2D(c, c, None, groups, 1e-6, dtype)])
    blk.attentions = nn.ModuleList([VAEAttention(c, groups, dtype)])
    return blk


def _run_mid(blk, h):
    h = blk.resnets[0](h)
    h = blk.attentions[0](h)
    return blk.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1,
                              dtype=dtype)
        self.down_blocks = nn.ModuleList()
        c = ch[0]
        for i in range(len(ch)):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(c, ch[i], None, g, 1e-6,
                                                 dtype))
                c = ch[i]
            if i != len(ch) - 1:
                # the VAE pads its downsamplers (0, 1, 0, 1)
                blk.downsamplers = nn.ModuleList([Downsample2D(c, 0, dtype)])
            self.down_blocks.append(blk)
        self.mid_block = _mid(c, g, dtype)
        self.conv_norm_out = GroupNorm(g, c, 1e-6, dtype)
        self.conv_out = Conv2d(c, 2 * cfg.latent_channels, 3, padding=1,
                               dtype=dtype)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_groups
        n = len(ch)
        self.conv_in = Conv2d(cfg.latent_channels, ch[-1], 3, padding=1,
                              dtype=dtype)
        self.mid_block = _mid(ch[-1], g, dtype)
        self.up_blocks = nn.ModuleList()
        c = ch[-1]
        for i in range(n):
            ch_i = ch[n - 1 - i]
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(c, ch_i, None, g, 1e-6,
                                                 dtype))
                c = ch_i
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(c, dtype)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(g, c, 1e-6, dtype)
        self.conv_out = Conv2d(c, cfg.in_channels, 3, padding=1,
                               dtype=dtype)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """``dtype``: the computation dtype (models/layers.py's rules; the JAX
    module's ``dtype``)."""

    def __init__(self, config: VAEConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        c2 = 2 * config.latent_channels
        self.encoder = Encoder(config, dtype)
        self.decoder = Decoder(config, dtype)
        self.quant_conv = Conv2d(c2, c2, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(config.latent_channels,
                                      config.latent_channels, 1, dtype=dtype)

    @property
    def downscale(self) -> int:
        """Image pixels per latent pixel along each axis."""
        return 2 ** (len(self.config.block_out_channels) - 1)

    def encode_moments(self, x):
        """[B, 3, H, W] in [-1, 1] -> (mean, logvar) [B, 4, h, w]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, noise: Optional[torch.Tensor] = None):
        """The scaled latent: a sample of the posterior with the standard
        normal draw ``noise`` ([B, 4, h, w], taken in the mean's dtype as
        the JAX module draws it, vae.py:163), or its mode when ``noise`` is
        None."""
        mean, logvar = self.encode_moments(x)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return mean * self.config.scaling_factor

    def decode(self, z):
        return self.decoder(
            self.post_quant_conv(z / self.config.scaling_factor))
