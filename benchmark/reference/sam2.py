"""Plain float32 SAM 2.1 image path: the Hiera trunk, the FPN neck, the
prompt encoder and the two-way mask decoder, and its prediction from one box
prompt, one image at a time.

A frozen copy of what ``SAM2ImagePredictor.set_image`` and ``predict`` run
in the model that ``sam2/configs/sam2.1/sam2.1_hiera_l.yaml`` builds
(facebookresearch/sam2: ``modeling/backbones/{hieradet,image_encoder,
utils}.py``, ``modeling/sam/{prompt_encoder,mask_decoder,transformer}.py``,
``modeling/sam2_utils.py``, ``utils/transforms.py``). Parameter names are
the checkpoint's own, so the image-path entries of a ``sam2.1_hiera_large.pt``
``"model"`` dict, the program and this copy take one state dict.
``sd15.set_precision`` rounds the operands of every product (the control).

The configuration is the dict of ``benchmark/configs/sam2.1-hiera-l-bf16.json``
(``image_size``, ``trunk``, ``neck``, ``prompt_encoder``, ``mask_decoder``).

Where this copy departs from SAM 2.1:

- the neck's sine position encodings are not computed: the image path never
  reads them (the decoder takes the prompt encoder's dense encoding);
- the video parts (memory attention and encoder, object pointers) and the
  prompt encoder's ``mask_downscaling`` are left out with their parameters:
  a box prompt with no mask input never runs them;
- the image is resized with ``F.interpolate`` (bilinear, no antialias):
  torchvision's ``Resize`` antialiases only when it shrinks, and the views
  are enlarged;
- one box a view, given in the view's pixels (x0, y0, x1, y1), as
  ``predict(box=..., multimask_output=False)`` takes it from lang-sam.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import Precision
from benchmark.reference.sd15 import (Conv2d, LayerNorm, Linear, _p,
                                      attend_heads)

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(_p(self, x), _p(self, self.weight),
                                  self.bias.float(), stride=self.stride)


class MLP(nn.Module):
    """sam2_utils.MLP: ``depth`` Linear layers, ``act`` between them."""

    def __init__(self, cin: int, hidden: int, cout: int, depth: int,
                 act: str = "relu", sigmoid: bool = False):
        super().__init__()
        dims = [cin] + [hidden] * (depth - 1) + [cout]
        self.layers = nn.ModuleList(Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.act = F.relu if act == "relu" else F.gelu
        self.sigmoid = sigmoid

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return torch.sigmoid(x) if self.sigmoid else x


def _pool(x):
    """2x2 max pool, stride 2, of channels-last [B, H, W, C]."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def window_partition(x, window: int):
    """[B, H, W, C] -> windows [B·nW, window, window, C] and the padded size
    (zeros pad the bottom and right edges)."""
    b, h, w, c = x.shape
    ph, pw = (-h) % window, (-w) % window
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // window, window, wp // window, window, c)
    return (x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c),
            (hp, wp))


def window_unpartition(x, window: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp * wp // window // window)
    x = x.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, q_pool: bool):
        super().__init__()
        self.heads, self.q_pool = heads, q_pool
        self.qkv = Linear(dim, dim_out * 3)
        self.proj = Linear(dim_out, dim_out)

    def forward(self, x):
        b, h, w, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, h * w, 3, self.heads, -1).unbind(2)
        if self.q_pool:
            q = _pool(q.reshape(b, h, w, -1))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.heads, -1)
        out = attend_heads(_prec(self), q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2))
        return self.proj(out.transpose(1, 2).reshape(b, h, w, -1))


def _prec(module) -> Precision:
    return getattr(module, "prec", Precision())


class MultiScaleBlock(nn.Module):
    """hieradet.MultiScaleBlock. ``window`` 0: global attention; a block
    with ``q_pool`` pools its queries and its shortcut 2x2 and leaves its
    windows at half their size."""

    def __init__(self, dim: int, dim_out: int, heads: int, window: int,
                 q_pool: bool, mlp_ratio: float):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window, self.q_pool = window, q_pool
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, heads, q_pool)
        self.norm2 = LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2, "gelu")
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)

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
        if self.q_pool:
            window = self.window // 2
            h, w = shortcut.shape[1:3]
            pad_hw = (h + (-h) % window, w + (-w) % window) if window else None
        if window:
            x = window_unpartition(x, window, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, 7, stride=4, padding=3)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


def block_plan(t: dict):
    """Each block's (dim, dim_out, heads, window, q_pool) as
    ``Hiera.__init__`` lays them out: a stage's first block keeps the
    previous stage's window (the lag the source's comment names)."""
    dim, heads = int(t["embed_dim"]), int(t["num_heads"])
    stages = list(t["stages"])
    ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    pooled = [e + 1 for e in ends[:-1]][:int(t["q_pool"])]
    plan, stage = [], 0
    for i in range(sum(stages)):
        dim_out = dim
        window = (0 if i in t["global_att_blocks"]
                  else int(t["window_spec"][stage]))
        if i - 1 in ends:
            dim_out = int(dim * t["dim_mul"])
            heads = int(heads * t["head_mul"])
            stage += 1
        plan.append((dim, dim_out, heads, window, i in pooled))
        dim = dim_out
    return plan, ends


class Hiera(nn.Module):
    def __init__(self, t: dict):
        super().__init__()
        dim = int(t["embed_dim"])
        plan, self.stage_ends = block_plan(t)
        self.patch_embed = PatchEmbed(dim)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, dim, *t["window_pos_embed_bkg_spatial_size"]))
        w0 = int(t["window_spec"][0])
        self.pos_embed_window = nn.Parameter(torch.zeros(1, dim, w0, w0))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(*p, mlp_ratio=float(t["mlp_ratio"])) for p in plan)

    def forward(self, x):
        x = self.patch_embed(x)
        h, w = x.shape[1:3]
        pos = F.interpolate(self.pos_embed.float(), size=(h, w),
                            mode="bicubic")
        win = self.pos_embed_window.float()
        pos = pos + win.tile(1, 1, h // win.shape[2], w // win.shape[3])
        x = x + pos.permute(0, 2, 3, 1)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outs.append(x.permute(0, 3, 1, 2))
        return outs


class _Lateral(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1)


class FpnNeck(nn.Module):
    """image_encoder.FpnNeck with nearest top-down fusion by sum into
    ``fpn_top_down_levels``."""

    def __init__(self, n: dict):
        super().__init__()
        d = int(n["d_model"])
        self.convs = nn.ModuleList(_Lateral(c, d)
                                   for c in n["backbone_channel_list"])
        self.top_down = list(n["fpn_top_down_levels"])

    def forward(self, xs):
        out = [None] * len(xs)
        last = len(self.convs) - 1
        prev = None
        for i in range(last, -1, -1):
            lateral = self.convs[last - i].conv(xs[i])
            if i in self.top_down and prev is not None:
                prev = lateral + F.interpolate(prev, scale_factor=2.0,
                                               mode="nearest")
            else:
                prev = lateral
            out[i] = prev
        return out


class ImageEncoder(nn.Module):
    def __init__(self, t: dict, n: dict):
        super().__init__()
        self.trunk = Hiera(t)
        self.neck = FpnNeck(n)
        self.scalp = int(n["scalp"])

    def forward(self, x):
        feats = self.neck(self.trunk(x))
        return feats[:len(feats) - self.scalp]


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, feats))

    def encode(self, coords):
        """coords in [0, 1], [..., 2] -> [..., 2·feats]."""
        c = 2.0 * coords - 1.0
        c = 2.0 * math.pi * (_prec(self)(c) @ _prec(self)(
            self.positional_encoding_gaussian_matrix))
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, h: int, w: int, device):
        """The dense encoding [C, h, w] of the cell centres."""
        ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h
        xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        return self.encode(torch.stack([xx, yy], -1)).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    def __init__(self, d: int, embed_size: int, image_size: int):
        super().__init__()
        self.embed_size, self.image_size = embed_size, image_size
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    def forward(self, corners):
        """corners [B, 2, 2]: a box's two corners in the model's input
        pixels -> sparse [B, 3, C] (corners labelled 2 and 3, then the
        padding point, labelled -1), dense [B, C, e, e]."""
        pts = (corners + 0.5) / self.image_size
        sparse = self.pe_layer.encode(pts)
        sparse = torch.stack([
            sparse[:, 0] + self.point_embeddings[2].weight[0],
            sparse[:, 1] + self.point_embeddings[3].weight[0],
            self.not_a_point_embed.weight.expand(len(pts), -1)], dim=1)
        e = self.embed_size
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            len(pts), -1, e, e)
        return sparse, dense


class Attention(nn.Module):
    """sam.transformer.Attention: projections to ``dim // downsample``."""

    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj, self.k_proj = Linear(dim, inner), Linear(dim, inner)
        self.v_proj, self.out_proj = Linear(dim, inner), Linear(inner, dim)

    def forward(self, q, k, v):
        def split(x):
            b, n, c = x.shape
            return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        out = attend_heads(_prec(self), split(self.q_proj(q)),
                           split(self.k_proj(k)), split(self.v_proj(v)))
        b, h, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * c))


class TwoWayBlock(nn.Module):
    def __init__(self, d: int, heads: int, mlp: int, down: int, skip_pe: bool):
        super().__init__()
        self.skip_pe = skip_pe
        self.self_attn = Attention(d, heads)
        self.norm1 = LayerNorm(d)
        self.cross_attn_token_to_image = Attention(d, heads, down)
        self.norm2 = LayerNorm(d)
        self.mlp = MLP(d, mlp, d, 2, "relu")
        self.norm3 = LayerNorm(d)
        self.norm4 = LayerNorm(d)
        self.cross_attn_image_to_token = Attention(d, heads, down)

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
    def __init__(self, md: dict, d: int):
        super().__init__()
        heads = int(md["num_heads"])
        down = int(md["attention_downsample_rate"])
        self.layers = nn.ModuleList(
            TwoWayBlock(d, heads, int(md["mlp_dim"]), down, i == 0)
            for i in range(int(md["transformer_depth"])))
        self.final_attn_token_to_image = Attention(d, heads, down)
        self.norm_final_attn = LayerNorm(d)

    def forward(self, image, image_pe, tokens):
        keys = image.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        out = self.final_attn_token_to_image(queries + tokens, keys + key_pe,
                                             keys)
        return self.norm_final_attn(queries + out), keys


class LayerNorm2d(nn.Module):
    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MaskDecoder(nn.Module):
    """sam.mask_decoder.MaskDecoder with high-resolution features, the
    object-score MLP and sigmoid IoU (the sam2.1 yaml's settings)."""

    def __init__(self, md: dict, d: int):
        super().__init__()
        n = int(md["num_multimask_outputs"]) + 1
        self.num_mask_tokens = n
        self.transformer = TwoWayTransformer(md, d)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(n, d)
        self.obj_score_token = nn.Embedding(1, d)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4),
            nn.GELU(), ConvTranspose2d(d // 4, d // 8, 2, stride=2),
            nn.GELU())
        self.conv_s0 = Conv2d(d, d // 8, 1)
        self.conv_s1 = Conv2d(d, d // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(n))
        self.iou_prediction_head = MLP(d, int(md["iou_head_hidden_dim"]), n,
                                       int(md["iou_head_depth"]), sigmoid=True)
        self.pred_obj_score_head = MLP(d, d, 1, 3)

    def forward(self, embed, image_pe, sparse, dense, feat_s0, feat_s1):
        """-> logits [B, n, 4e, 4e] (every mask token's), iou [B, n],
        object score logits [B, 1]."""
        out_tokens = torch.cat([self.obj_score_token.weight,
                                self.iou_token.weight,
                                self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(len(sparse), -1, -1),
                            sparse], dim=1)
        src = embed + dense
        pos = image_pe.expand(len(src), -1, -1, -1)
        b, c, h, w = src.shape
        hs, src = self.transformer(src, pos, tokens)
        src = src.transpose(1, 2).reshape(b, c, h, w)
        dc1, ln1, act1, dc2, act2 = self.output_upscaling
        up = act1(ln1(dc1(src) + feat_s1))
        up = act2(dc2(up) + feat_s0)
        hyper = torch.stack([mlp(hs[:, 2 + i])
                             for i, mlp in enumerate(
                                 self.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = up.shape
        prec = _prec(self)
        logits = (prec(hyper) @ prec(up.reshape(b, c, h * w))).reshape(
            b, -1, h, w)
        return (logits, self.iou_prediction_head(hs[:, 1]),
                self.pred_obj_score_head(hs[:, 0]))


class Sam2(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        n, md = cfg["neck"], cfg["mask_decoder"]
        d = int(n["d_model"])
        self.image_size = int(cfg["image_size"])
        self.embed_size = self.image_size // 16
        self.delta = float(md["dynamic_multimask_stability_delta"])
        self.thresh = float(md["dynamic_multimask_stability_thresh"])
        self.image_encoder = ImageEncoder(cfg["trunk"], n)
        self.sam_prompt_encoder = PromptEncoder(d, self.embed_size,
                                                self.image_size)
        self.sam_mask_decoder = MaskDecoder(md, d)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, d))

    def encode(self, x):
        """A normalised [1, 3, S, S] image -> the image embedding and the two
        high-resolution features (``forward_image`` and ``set_image``)."""
        s0, s1, embed = self.image_encoder(x)
        dec = self.sam_mask_decoder
        embed = embed + self.no_mem_embed.reshape(1, -1, 1, 1)
        return embed, dec.conv_s0(s0), dec.conv_s1(s1)

    def decode(self, feats, corners):
        embed, s0, s1 = feats
        sparse, dense = self.sam_prompt_encoder(corners)
        pe = self.sam_prompt_encoder.pe_layer.grid(self.embed_size,
                                                   self.embed_size,
                                                   embed.device)
        return self.sam_mask_decoder(embed, pe[None], sparse, dense, s0, s1)


def select(logits, iou, delta: float, thresh: float):
    """Dynamic multimask via stability (``_dynamic_multimask_via_stability``):
    mask 0 where its stability score (area above ``delta`` over area above
    ``-delta``; 1 with none above) reaches ``thresh``, else the mask of
    highest IoU among 1..n. -> (chosen logits [B, h, w], choice [B],
    stability [B])."""
    single = logits[:, 0].flatten(1)
    area_i = (single > delta).sum(-1).float()
    area_u = (single > -delta).sum(-1).float()
    stability = torch.where(area_u > 0, area_i / area_u.clamp(min=1.0), 1.0)
    best = 1 + iou[:, 1:].argmax(-1)
    choice = torch.where(stability >= thresh, torch.zeros_like(best), best)
    idx = torch.arange(len(logits), device=logits.device)
    return logits[idx, choice], choice, stability


def prepare(net: Sam2, image):
    """[H, W, 3] in [0, 1] -> the normalised [1, 3, S, S] input
    (SAM2Transforms: resize to S x S, ImageNet mean and std)."""
    s = net.image_size
    x = F.interpolate(image.float().permute(2, 0, 1)[None], size=(s, s),
                      mode="bilinear", align_corners=False)
    mean = torch.tensor(IMAGE_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGE_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


def predict(net: Sam2, image, box) -> Dict[str, torch.Tensor]:
    """One view [H, W, 3] and its box (x0, y0, x1, y1) in the view's pixels
    -> ``logits`` [n, 4e, 4e], ``iou`` [n], ``object_score`` [1],
    ``stability``, ``choice`` and ``mask`` [H, W] (the chosen map resized
    bilinear to the view and thresholded at 0)."""
    h, w = image.shape[:2]
    s = net.image_size
    scale = torch.tensor([s / w, s / h], device=image.device)
    corners = torch.as_tensor(box, dtype=torch.float32,
                              device=image.device).reshape(1, 2, 2) * scale
    logits, iou, obj = net.decode(net.encode(prepare(net, image)), corners)
    chosen, choice, stab = select(logits, iou, net.delta, net.thresh)
    mask = F.interpolate(chosen[:, None], size=(h, w), mode="bilinear",
                         align_corners=False)[0, 0] > 0.0
    return {"logits": logits[0], "iou": iou[0], "object_score": obj[0],
            "stability": stab[0], "choice": choice[0], "mask": mask}


def box_in_view(box6, cam: dict):
    """The scene-space box (x0, y0, z0, x1, y1, z1) in a view: the pixel
    bounds (x0, y0, x1, y1) of its corners in front of the camera (depth >
    0.2), clipped to the view; None where nothing of it is left."""
    import numpy as np

    lo, hi = np.asarray(box6[:3], np.float64), np.asarray(box6[3:], np.float64)
    corners = np.array([[(lo, hi)[i >> k & 1][k] for k in range(3)]
                        for i in range(8)])
    hom = np.concatenate([corners, np.ones((8, 1))], 1)
    depth = hom @ np.asarray(cam["w2c"], np.float64)[2]
    ph = hom @ np.asarray(cam["full_proj"], np.float64).T
    front = depth > 0.2
    if not front.any():
        return None
    px = ((ph[front, 0] / ph[front, 3] + 1.0) * cam["width"] - 1.0) * 0.5
    py = ((ph[front, 1] / ph[front, 3] + 1.0) * cam["height"] - 1.0) * 0.5
    x0, x1 = np.clip([px.min(), px.max()], 0.0, cam["width"])
    y0, y1 = np.clip([py.min(), py.max()], 0.0, cam["height"])
    if x1 <= x0 or y1 <= y0:
        return None
    return [float(x0), float(y0), float(x1), float(y1)]


def pass_flops(net: Sam2, views: int, device="meta") -> float:
    """``FlopCounterMode``'s count of a round's work: one image's encoder,
    prompt encoder and decoder at the configuration's input size, times
    ``views``. On the meta device the network runs on shapes alone."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = torch.device(device)
    net = net.to(dev)
    s = net.image_size
    with FlopCounterMode(display=False) as fc:
        net.decode(net.encode(torch.zeros(1, 3, s, s, device=dev)),
                   torch.zeros(1, 2, 2, device=dev))
    return views * float(fc.get_total_flops())
