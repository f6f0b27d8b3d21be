"""SD-1.5- and SDXL-family conditional UNet (NCHW, diffusers parameter
names).

JAX counterpart: ``dge_tpu/models/unet.py`` (SD-1.5 only). Architecture =
diffusers UNet2DConditionModel. The defaults of ``UNetConfig`` are the
SD-1.5 config (block_out 320/640/1280/1280, 3x CrossAttnDownBlock2D +
DownBlock2D, cross-attention mid block, mirrored up path, 8 heads, context
dim 768, one transformer block per attention, 1x1-conv projections). For
InstructPix2Pix ``in_channels=8`` (noisy latent 4 + conditioning image
latent 4). ``UNetConfig.sdxl_ip2p_768()`` is the SDXL 1.0 UNet of
``diffusers/sdxl-instructpix2pix-768``: DownBlock2D + 2x CrossAttnDownBlock2D
(320/640/1280), transformer depths 1 / 2 / 10 (10 in the mid block, the up
path mirrored), heads 64 wide, Linear projections, context 2048, and the
``text_time`` added embedding: six time ids as 256-wide sinusoids after the
pooled text embedding (2,816 values) through ``add_embedding`` into the
timestep embedding.

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
    # heads at every level (SD-1.5); ``head_dim`` overrides it
    attention_heads: int = 8
    norm_groups: int = 32
    # which levels hold transformers; None: every level but the lowest
    # (SD-1.5). The mid block always does.
    attention_levels: Optional[Tuple[bool, ...]] = None
    # transformer blocks per attention at each level; None: 1. The mid
    # block takes the lowest level's, the up path mirrors the down path.
    transformer_depth: Optional[Tuple[int, ...]] = None
    # the width of a head (SDXL: 64, so channels // 64 heads)
    head_dim: Optional[int] = None
    # Linear projections on the tokens instead of 1x1 convolutions
    use_linear_projection: bool = False
    # "text_time" (SDXL): pooled text embedding and time ids added to the
    # timestep embedding through ``add_embedding``
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    @classmethod
    def tiny(cls, context_dim: int = 32) -> "UNetConfig":
        """Small config for unit tests."""
        return cls(in_channels=8, out_channels=4, block_out_channels=(32, 64),
                   layers_per_block=1, cross_attention_dim=context_dim,
                   attention_heads=2, norm_groups=8)

    @classmethod
    def sdxl_ip2p_768(cls) -> "UNetConfig":
        """diffusers/sdxl-instructpix2pix-768's UNet: the SDXL 1.0
        ``unet/config.json`` with ``in_channels`` 8."""
        return cls(in_channels=8, out_channels=4,
                   block_out_channels=(320, 640, 1280), layers_per_block=2,
                   cross_attention_dim=2048, norm_groups=32,
                   attention_levels=(False, True, True),
                   transformer_depth=(1, 2, 10), head_dim=64,
                   use_linear_projection=True, addition_embed_type="text_time",
                   addition_time_embed_dim=256,
                   projection_class_embeddings_input_dim=2816)

    @classmethod
    def tiny_xl(cls, context_dim: int = 32,
                pooled_dim: int = 24) -> "UNetConfig":
        """The SDXL layout at test size: no attention at the first of
        three levels, depths 1 / 2 / 3, heads 8 wide, Linear projections,
        the text-time embedding (8-wide sinusoids after a ``pooled_dim``
        embedding)."""
        return cls(in_channels=8, out_channels=4,
                   block_out_channels=(16, 32, 64), layers_per_block=1,
                   cross_attention_dim=context_dim, norm_groups=8,
                   attention_levels=(False, True, True),
                   transformer_depth=(1, 2, 3), head_dim=8,
                   use_linear_projection=True, addition_embed_type="text_time",
                   addition_time_embed_dim=8,
                   projection_class_embeddings_input_dim=pooled_dim + 6 * 8)

    def attends(self, level: int) -> bool:
        if self.attention_levels is None:
            return level != len(self.block_out_channels) - 1
        return bool(self.attention_levels[level])

    def depth(self, level: int) -> int:
        return (1 if self.transformer_depth is None
                else int(self.transformer_depth[level]))

    def heads(self, channels: int) -> int:
        return (self.attention_heads if self.head_dim is None
                else channels // self.head_dim)

    def attention_downscales(self) -> Tuple[int, ...]:
        """The latent downscales at which a transformer attends: the
        attended levels' and the mid block's. SD-1.5's default layout
        keeps the reference's set, (1, 2, 4, 8), whatever its depth."""
        if self.attention_levels is None:
            return (1, 2, 4, 8)
        n = len(self.block_out_channels)
        return tuple(sorted({2 ** i for i in range(n) if self.attends(i)}
                            | {2 ** (n - 1)}))


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
        groups = cfg.norm_groups
        temb = ch[0] * 4

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, temb, groups, dtype=dtype)

        def transformer(c, level):
            heads = cfg.heads(c)
            return Transformer2DModel(
                c, heads, c // heads, cfg.cross_attention_dim, groups, dtype,
                depth=cfg.depth(level),
                linear_projection=cfg.use_linear_projection)

        self.time_embedding = TimestepEmbedding(ch[0], temb, dtype)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb, dtype)
        elif cfg.addition_embed_type is not None:
            raise ValueError(
                f"unknown addition_embed_type {cfg.addition_embed_type!r}")
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
            if cfg.attends(i):
                blk.attentions = nn.ModuleList(
                    [transformer(ch[i], i)
                     for _ in range(cfg.layers_per_block)])
            if i != n - 1:
                # the SD UNet pads its downsamplers symmetrically
                blk.downsamplers = nn.ModuleList([
                    Downsample2D(ch[i], 1, dtype)])
                skips.append(c)
            self.down_blocks.append(blk)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([resnet(c, c), resnet(c, c)])
        self.mid_block.attentions = nn.ModuleList([transformer(c, n - 1)])
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            ch_i = ch[n - 1 - i]
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for j in range(cfg.layers_per_block + 1):
                blk.resnets.append(resnet(c + skips.pop(), ch_i))
                c = ch_i
            if cfg.attends(n - 1 - i):
                blk.attentions = nn.ModuleList(
                    [transformer(ch_i, n - 1 - i)
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
                pivot: Optional[dict] = None,
                text_embeds: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample [B, C_in, H, W], timesteps [B] or scalar, context
        [B, S_ctx, D_ctx] -> [B, C_out, H, W]. With the ``text_time``
        embedding also the pooled text embedding ``text_embeds`` [B, P]
        and ``time_ids`` [B, 6] (original size, crop corner, target
        size)."""
        cfg = self.config
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(
            timestep_embedding(timesteps, cfg.block_out_channels[0]))
        if cfg.addition_embed_type == "text_time":
            if text_embeds is None or time_ids is None:
                raise ValueError("the text_time embedding needs text_embeds "
                                 "and time_ids")
            # diffusers: the pooled embedding, then the time ids' sinusoids
            t_emb = timestep_embedding(
                time_ids.flatten(), cfg.addition_time_embed_dim).reshape(
                    text_embeds.shape[0], -1)
            temb = temb + self.add_embedding(
                torch.cat([text_embeds.float(), t_emb], dim=-1))
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
