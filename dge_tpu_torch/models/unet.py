"""SD-1.5-family conditional UNet (NCHW, diffusers parameter names).

JAX counterpart: ``dge_tpu/models/unet.py``. Architecture = diffusers
UNet2DConditionModel with the SD-1.5 config (block_out 320/640/1280/1280,
3x CrossAttnDownBlock2D + DownBlock2D, cross-attention mid block, mirrored
up path, 8 heads, context dim 768). For InstructPix2Pix ``in_channels=8``
(noisy latent 4 + conditioning image latent 4).

The cross-view ``mode`` and ``cross_view`` pass through to every
transformer block; the pivot record is a dict the caller owns:

    record = {}
    unet(x_keys, t, ctx_keys, mode="pivot_record", pivot=record)
    unet(x_batch, t, ctx_batch, mode="pivot_reuse", cross_view=cv,
         pivot=record)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dge_tpu_torch.models.layers import (BasicTransformerBlock, Conv2d,
                                         CrossViewState, Downsample2D,
                                         GroupNorm, ResnetBlock2D,
                                         TimestepEmbedding, Transformer2DModel,
                                         Upsample2D, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8  # IP2P; vanilla SD = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8
    norm_groups: int = 32

    @classmethod
    def tiny(cls, context_dim: int = 32) -> "UNetConfig":
        """Small config for unit tests."""
        return cls(in_channels=8, out_channels=4, block_out_channels=(32, 64),
                   layers_per_block=1, cross_attention_dim=context_dim,
                   attention_heads=2, norm_groups=8)


class _Block(nn.Module):
    """A diffusers down / up / mid block: only holds its named children."""


class UNet2DConditionModel(nn.Module):
    """``dtype``: the computation dtype (models/layers.py's rules; the JAX
    module's ``dtype``)."""

    def __init__(self, config: UNetConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg = config
        self.dtype = dtype
        ch = cfg.block_out_channels
        n = len(ch)
        heads, groups = cfg.attention_heads, cfg.norm_groups
        temb = ch[0] * 4

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, temb, groups, dtype=dtype)

        def transformer(c):
            return Transformer2DModel(c, heads, c // heads,
                                      cfg.cross_attention_dim, groups, dtype)

        self.time_embedding = TimestepEmbedding(ch[0], temb, dtype)
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1,
                              dtype=dtype)
        skips = [ch[0]]
        self.down_blocks = nn.ModuleList()
        c = ch[0]
        for i in range(n):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for j in range(cfg.layers_per_block):
                blk.resnets.append(resnet(c, ch[i]))
                c = ch[i]
                skips.append(c)
            if i != n - 1:
                blk.attentions = nn.ModuleList(
                    [transformer(ch[i]) for _ in range(cfg.layers_per_block)])
                # the SD UNet pads its downsamplers symmetrically
                blk.downsamplers = nn.ModuleList([
                    Downsample2D(ch[i], 1, dtype)])
                skips.append(c)
            self.down_blocks.append(blk)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([resnet(c, c), resnet(c, c)])
        self.mid_block.attentions = nn.ModuleList([transformer(c)])
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            ch_i = ch[n - 1 - i]
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for j in range(cfg.layers_per_block + 1):
                blk.resnets.append(resnet(c + skips.pop(), ch_i))
                c = ch_i
            if i != 0:
                blk.attentions = nn.ModuleList(
                    [transformer(ch_i)
                     for _ in range(cfg.layers_per_block + 1)])
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch_i, dtype)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(groups, ch[0], 1e-5, dtype)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1,
                               dtype=dtype)
        for name, m in self.named_modules():
            if isinstance(m, BasicTransformerBlock):
                m.pivot_key = name

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, *, mode: str = "plain",
                cross_view: Optional[CrossViewState] = None,
                pivot: Optional[dict] = None) -> torch.Tensor:
        """sample [B, C_in, H, W], timesteps [B] or scalar, context
        [B, S_ctx, D_ctx] -> [B, C_out, H, W]."""
        cfg = self.config
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(
            timestep_embedding(timesteps, cfg.block_out_channels[0]))
        kw = dict(mode=mode, cross_view=cross_view, pivot=pivot)

        h = self.conv_in(sample)
        skips = [h]
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if attns is not None:
                    h = attns[j](h, context, **kw)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, context, **kw)
        h = mid.resnets[1](h, temb)
        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if attns is not None:
                    h = attns[j](h, context, **kw)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
