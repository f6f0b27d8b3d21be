"""SAM 2.1's image path, batched: the Hiera trunk, the FPN neck, the prompt
encoder and the two-way mask decoder.

JAX counterpart: none (the JAX package has no segmenter of its own; its
``systems/segmentation.py`` reads precomputed masks). Reference analog: the
``LangSAMTextSegmentor`` of DGE's fork (threestudio/utils/sam.py:14-63)
runs lang-segment-anything, whose mask stage is ``SAM2ImagePredictor`` on
SAM 2.1 Hiera-Large (Ravi et al. 2024, arXiv:2408.00714; Hiera: Ryali et
al. 2023, arXiv:2306.00989). ``Sam2Config.hiera_large()`` follows
``sam2/configs/sam2.1/sam2.1_hiera_l.yaml``; ``Sam2Config.tiny()`` is the
tests' small network with the same layer kinds (windows that need padding,
a global block, pooled queries at every stage change).

Every parameter carries the checkpoint's own name
(``image_encoder.trunk.blocks.44.attn.qkv.weight``,
``sam_mask_decoder.conv_s0.weight``, ...), so the image-path entries of a
``sam2.1_hiera_large.pt`` ``"model"`` dict load by name
(``load_checkpoint``). Tokens are channels-last ``[B, H, W, C]`` as in the
source.

The layers (equations of ``modeling/backbones/hieradet.py`` and
``modeling/sam/*.py``):

- patch embedding: Conv2d(3 -> C, 7, stride 4, pad 3), plus ``pos_embed``
  resized bicubic to the token grid and ``pos_embed_window`` tiled;
- ``MultiScaleBlock``: ``x = shortcut + proj(attend(q, k, v))`` over windows
  (``window`` 0: the whole grid), then ``x + MLP(norm2(x))`` (4x, GELU);
  a stage's first block pools its queries 2x2 inside each window, takes the
  shortcut ``maxpool(Linear(norm1(x)))``, keeps the previous stage's window
  and leaves at half of it; windows pad the bottom and right edges with
  zeros, which take part in the attention as in the source;
- neck: 1x1 laterals to ``d_model``, nearest x2 top-down fusion by sum into
  ``fpn_top_down_levels``, the lowest level dropped (``scalp``); the decoder's
  ``conv_s0`` / ``conv_s1`` give the high-resolution features, and the image
  embedding is the 64² level plus ``no_mem_embed``;
- prompt: a box as two corners labelled 2 and 3 plus the padding point,
  each a random-Fourier encoding plus its label's embedding; the dense
  prompt ``no_mask_embed``;
- decoder: a two-way transformer (self-attention of the tokens,
  token->image and image->token attention downsampled x2, ReLU MLP) and a
  final token->image attention; upscaling with the high-resolution
  features; four hypernetwork MLPs; the sigmoid IoU head and the
  object-score MLP. ``select_masks`` is the single-mask output with dynamic
  fallback via stability.

Computation dtype, as ``models/layers``: ``Linear``, ``Conv2d`` and the
transposed convolutions compute in ``dtype``; LayerNorms take their
statistics in f32 and return ``dtype``; attention runs
``layers.attend_heads`` (FLASH on a card in bf16: the trunk's heads are 72
wide); position encodings and the prompt's Fourier features are f32, cast to
``dtype`` where they meet the activations; the mask logits, IoU and object
scores are returned in f32.

Departures from ``sam2.1_hiera_l.yaml``:

- the neck's sine position encodings are not computed (the image path
  never reads them);
- the video parts (memory attention and encoder, object pointers) and the
  prompt encoder's ``mask_downscaling`` are not built: a box prompt without
  a mask input never runs them;
- the FPN's top-down sum stays in ``dtype`` (the source upcasts the
  upsampled level to f32 under autocast);
- the input is resized with ``F.interpolate`` (bilinear, no antialias), as
  torchvision's ``Resize`` does when it enlarges.

Spans: ``seg.global_attn`` around the attention of every global block
(utils/tracing.py); ``systems/segmentation`` adds ``seg.encode`` and
``seg.decode``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dge_tpu_torch.models.layers import (Conv2d, LayerNorm, Linear,
                                         attend_heads, store_compute_dtype)
from dge_tpu_torch.utils import tracing

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class Sam2Config:
    """The image path's sizes (defaults: SAM 2.1 Hiera-Large)."""

    image_size: int = 1024
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    q_pool: int = 3
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0
    d_model: int = 256
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    scalp: int = 1
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    stability_delta: float = 0.05
    stability_thresh: float = 0.98

    @classmethod
    def hiera_large(cls) -> "Sam2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "Sam2Config":
        """64² images: token grids 16/8/4/2, windows 8/6/6/2 (stages 2 and
        3 pad), one global block, pooled queries at blocks 1, 3 and 6."""
        return cls(image_size=64, embed_dim=8, num_heads=1,
                   stages=(1, 2, 3, 2), global_att_blocks=(4,),
                   window_spec=(8, 6, 6, 2), d_model=16, decoder_heads=2,
                   decoder_mlp_dim=32)

    @property
    def embed_size(self) -> int:
        """The image embedding's side (the backbone's stride is 16)."""
        return self.image_size // 16

    def block_plan(self):
        """Each block's (dim, dim_out, heads, window, q_pool), and the
        stages' last blocks. A stage's first block keeps the previous
        stage's window (``Hiera.__init__``'s lag)."""
        dim, heads = self.embed_dim, self.num_heads
        ends = [sum(self.stages[:i]) - 1
                for i in range(1, len(self.stages) + 1)]
        pooled = [e + 1 for e in ends[:-1]][:self.q_pool]
        plan, stage = [], 0
        for i in range(sum(self.stages)):
            dim_out = dim
            window = (0 if i in self.global_att_blocks
                      else self.window_spec[stage])
            if i - 1 in ends:
                dim_out = int(dim * self.dim_mul)
                heads = int(heads * self.head_mul)
                stage += 1
            plan.append((dim, dim_out, heads, window, i in pooled))
            dim = dim_out
        return plan, ends


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``dtype`` (as layers.Conv2d)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 dtype: torch.dtype):
        super().__init__(cin, cout, kernel, stride=stride)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=self.stride)


class LayerNorm2d(nn.Module):
    """sam2_utils.LayerNorm2d over the channels of [B, C, H, W]: f32
    statistics, ``dtype`` out."""

    def __init__(self, c: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps, self.compute_dtype = eps, dtype

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1).float(), (x.shape[1],),
                         self.weight.float(), self.bias.float(), self.eps)
        return y.permute(0, 3, 1, 2).to(self.compute_dtype)


class MLP(nn.Module):
    """sam2_utils.MLP: ``depth`` Linear layers with ``act`` between them."""

    def __init__(self, cin: int, hidden: int, cout: int, depth: int,
                 dtype: torch.dtype, act=F.relu, sigmoid: bool = False):
        super().__init__()
        dims = [cin] + [hidden] * (depth - 1) + [cout]
        self.layers = nn.ModuleList(Linear(a, b, dtype=dtype)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.act, self.sigmoid = act, sigmoid

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return torch.sigmoid(x) if self.sigmoid else x


def _pool(x):
    """2x2 max pool, stride 2, floor, of channels-last [B, H, W, C]."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, :2 * h2, :2 * w2].reshape(b, h2, 2, w2, 2, c).amax(dim=(2, 4))


def window_partition(x, window: int):
    """[B, H, W, C] -> [B·nW, window, window, C], zeros padding the bottom
    and right edges, and the padded size."""
    b, h, w, c = x.shape
    ph, pw = (-h) % window, (-w) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // window, window, wp // window, window, c)
    return (x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c),
            (hp, wp))


def window_unpartition(x, window: int, pad_hw, hw):
    (hp, wp), (h, w) = pad_hw, hw
    b = x.shape[0] // ((hp // window) * (wp // window))
    x = x.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w] if (hp, wp) != (h, w) else x


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, q_pool: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.heads, self.q_pool = heads, q_pool
        self.qkv = Linear(dim, dim_out * 3, dtype=dtype)
        self.proj = Linear(dim_out, dim_out, dtype=dtype)

    def forward(self, x):
        b, h, w, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, h * w, 3, self.heads, -1).unbind(2)
        if self.q_pool:
            q = _pool(q.reshape(b, h, w, -1))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.heads, -1)
        out = attend_heads(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2))
        return self.proj(out.transpose(1, 2).reshape(b, h, w, -1))


class MultiScaleBlock(nn.Module):
    """hieradet.MultiScaleBlock (``window`` 0: global attention)."""

    def __init__(self, dim: int, dim_out: int, heads: int, window: int,
                 q_pool: bool, mlp_ratio: float, dtype: torch.dtype):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window, self.q_pool = window, q_pool
        self.norm1 = LayerNorm(dim, 1e-6, dtype)
        self.attn = MultiScaleAttention(dim, dim_out, heads, q_pool, dtype)
        self.norm2 = LayerNorm(dim_out, 1e-6, dtype)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2, dtype,
                       act=F.gelu)
        if dim != dim_out:
            self.proj = Linear(dim, dim_out, dtype=dtype)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_pool:
                shortcut = _pool(shortcut)
        h, w = x.shape[1:3]
        window = self.window
        if window:
            x, pad_hw = window_partition(x, window)
            x = self.attn(x)
        else:
            with tracing.span("seg.global_attn", device=x.device,
                              tokens=h * w):
                x = self.attn(x)
        if self.q_pool:
            window = self.window // 2
            h, w = shortcut.shape[1:3]
            pad_hw = (h + (-h) % window, w + (-w) % window) if window else None
        if window:
            x = window_unpartition(x, window, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Conv2d(3, dim, 7, stride=4, padding=3, dtype=dtype)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class Hiera(nn.Module):
    def __init__(self, cfg: Sam2Config, dtype: torch.dtype):
        super().__init__()
        plan, self.stage_ends = cfg.block_plan()
        dim, w0 = cfg.embed_dim, cfg.window_spec[0]
        self.patch_embed = PatchEmbed(dim, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, dim, *cfg.window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, dim, w0, w0))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(*p, mlp_ratio=cfg.mlp_ratio, dtype=dtype)
            for p in plan)

    def pos(self, h: int, w: int) -> torch.Tensor:
        """The position table [1, h, w, C] in f32."""
        pos = F.interpolate(self.pos_embed.float(), size=(h, w),
                            mode="bicubic")
        win = self.pos_embed_window.float()
        pos = pos + win.tile(1, 1, h // win.shape[2], w // win.shape[3])
        return pos.permute(0, 2, 3, 1)

    def forward(self, x):
        """[B, 3, S, S] -> each stage's last output, channels-last."""
        x = self.patch_embed(x)
        x = x + self.pos(*x.shape[1:3]).to(x.dtype)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outs.append(x)
        return outs


class _Lateral(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, dtype=dtype)


class FpnNeck(nn.Module):
    def __init__(self, cfg: Sam2Config, channels, dtype: torch.dtype):
        super().__init__()
        # lowest resolution first, as backbone_channel_list
        self.convs = nn.ModuleList(_Lateral(c, cfg.d_model, dtype)
                                   for c in reversed(channels))
        self.top_down = cfg.fpn_top_down_levels

    def forward(self, xs):
        """Channels-last stage outputs -> [B, d, H, W] levels."""
        out = [None] * len(xs)
        last = len(xs) - 1
        prev = None
        for i in range(last, -1, -1):
            lateral = self.convs[last - i].conv(xs[i].permute(0, 3, 1, 2))
            if i in self.top_down and prev is not None:
                prev = lateral + F.interpolate(prev, scale_factor=2.0,
                                               mode="nearest")
            else:
                prev = lateral
            out[i] = prev
        return out


class ImageEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config, dtype: torch.dtype):
        super().__init__()
        self.trunk = Hiera(cfg, dtype)
        channels = [p[1] for i, p in enumerate(cfg.block_plan()[0])
                    if i in self.trunk.stage_ends]
        self.neck = FpnNeck(cfg, channels, dtype)
        self.scalp = cfg.scalp

    def forward(self, x):
        feats = self.neck(self.trunk(x))
        return feats[:len(feats) - self.scalp]


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, feats))

    def encode(self, coords):
        """f32 coords in [0, 1], [..., 2] -> [..., 2·feats] in f32."""
        g = self.positional_encoding_gaussian_matrix.float()
        c = 2.0 * math.pi * ((2.0 * coords - 1.0) @ g)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, size: int, device) -> torch.Tensor:
        """The dense encoding [C, size, size] of the cell centres."""
        t = (torch.arange(size, device=device, dtype=torch.float32)
             + 0.5) / size
        yy, xx = torch.meshgrid(t, t, indexing="ij")
        return self.encode(torch.stack([xx, yy], -1)).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config):
        super().__init__()
        d = cfg.d_model
        self.image_size = cfg.image_size
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    def forward(self, corners):
        """Box corners [B, 2, 2] in input pixels -> the sparse prompt
        [B, 3, d] in f32 (corners labelled 2 and 3, the padding point)."""
        pe = self.pe_layer.encode((corners.float() + 0.5) / self.image_size)
        return torch.stack([
            pe[:, 0] + self.point_embeddings[2].weight[0].float(),
            pe[:, 1] + self.point_embeddings[3].weight[0].float(),
            self.not_a_point_embed.weight.float().expand(len(pe), -1)], 1)


class Attention(nn.Module):
    """sam.transformer.Attention: projections to ``dim // downsample``."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype,
                 downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = Linear(dim, inner, dtype=dtype)
        self.k_proj = Linear(dim, inner, dtype=dtype)
        self.v_proj = Linear(dim, inner, dtype=dtype)
        self.out_proj = Linear(inner, dim, dtype=dtype)

    def forward(self, q, k, v):
        def split(x):
            b, n, c = x.shape
            return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        out = attend_heads(split(self.q_proj(q)), split(self.k_proj(k)),
                           split(self.v_proj(v)))
        b, h, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * c))


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: Sam2Config, dtype: torch.dtype, skip_pe: bool):
        super().__init__()
        d, heads = cfg.d_model, cfg.decoder_heads
        down = cfg.attention_downsample_rate
        self.skip_pe = skip_pe
        self.self_attn = Attention(d, heads, dtype)
        self.norm1 = LayerNorm(d, 1e-5, dtype)
        self.cross_attn_token_to_image = Attention(d, heads, dtype, down)
        self.norm2 = LayerNorm(d, 1e-5, dtype)
        self.mlp = MLP(d, cfg.decoder_mlp_dim, d, 2, dtype)
        self.norm3 = LayerNorm(d, 1e-5, dtype)
        self.norm4 = LayerNorm(d, 1e-5, dtype)
        self.cross_attn_image_to_token = Attention(d, heads, dtype, down)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: Sam2Config, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.layers = nn.ModuleList(TwoWayBlock(cfg, dtype, i == 0)
                                    for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = Attention(
            d, cfg.decoder_heads, dtype, cfg.attention_downsample_rate)
        self.norm_final_attn = LayerNorm(d, 1e-5, dtype)

    def forward(self, image, image_pe, tokens):
        keys = image.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        out = self.final_attn_token_to_image(queries + tokens, keys + key_pe,
                                             keys)
        return self.norm_final_attn(queries + out), keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg: Sam2Config, dtype: torch.dtype):
        super().__init__()
        d, n = cfg.d_model, cfg.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(cfg, dtype)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(n, d)
        self.obj_score_token = nn.Embedding(1, d)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2d(d, d // 4, 2, 2, dtype),
            LayerNorm2d(d // 4, dtype), nn.GELU(),
            ConvTranspose2d(d // 4, d // 8, 2, 2, dtype), nn.GELU())
        self.conv_s0 = Conv2d(d, d // 8, 1, dtype=dtype)
        self.conv_s1 = Conv2d(d, d // 4, 1, dtype=dtype)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3, dtype) for _ in range(n))
        self.iou_prediction_head = MLP(d, d, n, cfg.iou_head_depth, dtype,
                                       sigmoid=True)
        self.pred_obj_score_head = MLP(d, d, 1, 3, dtype)

    def forward(self, embed, image_pe, sparse, dense, feat_s0, feat_s1):
        dt = embed.dtype
        out_tokens = torch.cat([self.obj_score_token.weight,
                                self.iou_token.weight,
                                self.mask_tokens.weight], dim=0).to(dt)
        tokens = torch.cat([out_tokens[None].expand(len(sparse), -1, -1),
                            sparse.to(dt)], dim=1)
        src = embed + dense.to(dt)
        b, c, h, w = src.shape
        hs, src = self.transformer(src, image_pe.to(dt).expand(b, -1, -1, -1),
                                   tokens)
        src = src.transpose(1, 2).reshape(b, c, h, w)
        dc1, ln1, act1, dc2, act2 = self.output_upscaling
        up = act1(ln1(dc1(src) + feat_s1))
        up = act2(dc2(up) + feat_s0)
        hyper = torch.stack([mlp(hs[:, 2 + i]) for i, mlp in enumerate(
            self.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = up.shape
        logits = (hyper @ up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        return (logits.float(), self.iou_prediction_head(hs[:, 1]).float(),
                self.pred_obj_score_head(hs[:, 0]).float())


class Sam2Model(nn.Module):
    """The image path: ``encode`` (``set_image``) and ``decode``
    (``predict`` with one box an image)."""

    def __init__(self, cfg: Sam2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.image_encoder = ImageEncoder(cfg, dtype)
        self.sam_prompt_encoder = PromptEncoder(cfg)
        self.sam_mask_decoder = MaskDecoder(cfg, dtype)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, cfg.d_model))

    def encode(self, x):
        """Normalised [B, 3, S, S] images -> (image embedding [B, d, e, e],
        the two high-resolution features), in ``dtype``."""
        s0, s1, embed = self.image_encoder(x.to(self.dtype))
        dec = self.sam_mask_decoder
        embed = embed + self.no_mem_embed.reshape(1, -1, 1, 1).to(embed.dtype)
        return embed, dec.conv_s0(s0), dec.conv_s1(s1)

    def decode(self, feats, corners):
        """``encode``'s features and box corners [B, 2, 2] in input pixels
        -> every mask token's logits [B, n, 4e, 4e], IoU [B, n] and object
        score logits [B, 1], in f32."""
        embed = feats[0]
        pe = self.sam_prompt_encoder
        dense = pe.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            len(embed), -1, *embed.shape[2:])
        grid = pe.pe_layer.grid(self.cfg.embed_size, embed.device)
        return self.sam_mask_decoder(embed, grid[None], pe(corners), dense,
                                     feats[1], feats[2])


def prepare(images, size: int):
    """[B, H, W, 3] in [0, 1] -> the normalised [B, 3, size, size] input in
    f32 (SAM2Transforms: bilinear resize, ImageNet mean and std; the
    constants as scalars, so that nothing is copied to the device)."""
    x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False)
    return torch.stack([(x[:, c] - m) / s for c, (m, s) in enumerate(
        zip(IMAGE_MEAN, IMAGE_STD))], 1)


def select_masks(logits, iou, delta: float, thresh: float):
    """The single-mask output with dynamic fallback via stability
    (``MaskDecoder._dynamic_multimask_via_stability``): mask 0 where its
    stability score (pixels above ``delta`` over pixels above ``-delta``; 1
    where none is) reaches ``thresh``, else the mask of highest IoU among
    the others. -> (chosen logits [B, h, w], choice [B], stability [B])."""
    single = logits[:, 0].flatten(1)
    area_i = (single > delta).sum(-1).float()
    area_u = (single > -delta).sum(-1).float()
    stability = torch.where(area_u > 0, area_i / area_u.clamp(min=1.0), 1.0)
    best = 1 + iou[:, 1:].argmax(-1)
    choice = torch.where(stability >= thresh, torch.zeros_like(best), best)
    idx = torch.arange(len(logits), device=logits.device)
    return logits[idx, choice], choice, stability


def random_params(model: Sam2Model, seed: int,
                  device=None) -> Dict[str, torch.Tensor]:
    """Weights drawn from ``seed``: every kernel and table normal of
    variance 1/fan_in (fan_in: elements over the first axis), the prompt's
    Fourier matrix standard normal (as the source draws it), norm scales 1
    and biases 0."""
    gen = torch.Generator(device=device or "cpu").manual_seed(int(seed))
    out = {}
    for name, t in model.state_dict().items():
        if t.dim() == 1:
            out[name] = torch.full(t.shape, float(name.endswith("weight")),
                                   device=device)
            continue
        v = torch.randn(t.shape, generator=gen, device=device)
        if not name.endswith("positional_encoding_gaussian_matrix"):
            v = v / math.sqrt(t.numel() // t.shape[0])
        out[name] = v
    return out


def load_checkpoint(path: str, model: Sam2Model) -> Dict[str, torch.Tensor]:
    """The image-path entries of a SAM 2.1 checkpoint (a ``.pt`` holding
    ``{"model": state_dict}``, or the state dict itself) under ``model``'s
    names; raises naming the entries it lacks."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model", sd)
    missing = [k for k in model.state_dict() if k not in sd]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} image-path entries, "
                       f"e.g. {missing[:3]}")
    return {k: sd[k] for k in model.state_dict()}


def build_model(cfg: Optional[Sam2Config] = None, *, device="cpu",
                dtype: torch.dtype = torch.float32,
                params: Optional[Dict[str, torch.Tensor]] = None,
                checkpoint: Optional[str] = None, seed: int = 0
                ) -> Sam2Model:
    """The network on ``device`` in ``dtype``, from ``params`` (a state
    dict under the checkpoint's names), else the ``checkpoint`` file, else
    weights drawn from ``seed``; frozen, in eval mode."""
    with torch.device("meta"):
        model = Sam2Model(cfg or Sam2Config.hiera_large(), dtype)
    model = model.to_empty(device=device)
    if params is None and checkpoint:
        params = load_checkpoint(checkpoint, model)
    if params is None:
        params = random_params(model, seed, device)
    model.load_state_dict(params)
    store_compute_dtype(model)
    for m in model.modules():
        if isinstance(m, ConvTranspose2d):
            m.to(m.compute_dtype)
    return model.eval().requires_grad_(False)
