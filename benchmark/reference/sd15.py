"""Plain float32 SD-1.5 UNet (InstructPix2Pix, 8 input channels) and VAE,
with DGE's cross-view attention.

A frozen copy of the architecture as diffusers defines it (parameter names
included, so one state dict loads into the program and into this copy) and
of DGE's attention surgery (threestudio/utils/dge_utils.py): ``"plain"``
self-attention; ``"pivot_record"``, attention over the key (pivot) frames of
each CFG chunk together, recording each block's normed states and output;
``"pivot_reuse"``, each query token takes the recorded pivot output at the
pivot token of highest cosine similarity among those within 1 px of its
epipolar line (all of them where none is), blended over the two closest
keys. Everything computes in float32; ``set_precision`` makes every matrix
product, convolution and attention of a network round its operands first
(the control).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import Precision


def set_precision(model: nn.Module, mode: str) -> None:
    """Round the operands of every product in ``model`` to ``mode``."""
    prec = Precision(mode)
    for m in model.modules():
        m.prec = prec


def _p(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return getattr(module, "prec", Precision())(x)


@dataclasses.dataclass
class CrossView:
    closest: torch.Tensor  # long [F, n_key]
    blend_w1: torch.Tensor  # [F]
    lines: Dict[int, torch.Tensor]  # tokens -> [F, n_key, S, 3]
    pts: Dict[int, torch.Tensor]  # tokens -> [S, 3]
    n_key: int
    threshold: float = 1.0


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(_p(self, x), _p(self, self.weight),
                        None if self.bias is None else self.bias.float())


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(_p(self, x), _p(self, self.weight),
                                  self.bias.float())


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return super().forward(x.float())


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return super().forward(x.float())


def attend_heads(prec: Precision, q, k, v):
    """[B, H, S, D] softmax attention in float32."""
    q, k, v = prec(q), prec(k), prec(v)
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.zeros_like(q)
    for s in range(0, q.shape[2], 1024):
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, s:s + 1024], k)
        out[:, :, s:s + 1024] = torch.einsum(
            "bhqk,bhkd->bhqd", torch.softmax(logits * scale, -1), v)
    return out


def attend(prec: Precision, q, k, v, heads: int):
    def split(x):
        b, s, inner = x.shape
        return x.reshape(b, s, heads, inner // heads).transpose(1, 2)

    out = attend_heads(prec, split(q), split(k), split(v))
    b, h, s, d = out.shape
    return out.transpose(1, 2).reshape(b, s, h * d)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim or dim, inner, bias=False)
        self.to_v = Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim), nn.Identity()])

    def forward(self, x, context=None, frames: int = 0):
        c = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(c), self.to_v(c)
        prec = getattr(self, "prec", Precision())
        if frames:
            b, s, d = q.shape
            out = attend(prec, q.reshape(b // frames, frames * s, d),
                         k.reshape(b // frames, frames * s, d),
                         v.reshape(b // frames, frames * s, d),
                         self.heads).reshape(b, s, -1)
        else:
            out = attend(prec, q, k, v, self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


def epipolar_argmax(prec: Precision, img, piv, lines, pts, threshold: float,
                    block: int = 512):
    """For each query token, the index of the most cosine-similar pivot
    token among those within ``threshold`` px of its epipolar line
    (similarity 0 for the others), or of all pivot tokens where every one
    is farther. img [F, S, D], piv [F, K, S, D] unit tokens, lines
    [F, K, S, 3], pts [S, 3] -> long [F, K, S]. Ties keep the earliest
    index."""
    f, k, s, _ = piv.shape
    best_m = torch.full((f, k, s), -math.inf, device=img.device)
    idx_m = torch.zeros((f, k, s), dtype=torch.long, device=img.device)
    best_a = torch.full((f, k, s), -math.inf, device=img.device)
    idx_a = torch.zeros((f, k, s), dtype=torch.long, device=img.device)
    all_bad = torch.ones((f, k, s), dtype=torch.bool, device=img.device)
    for off in range(0, s, block):
        sim = torch.einsum("fsd,fktd->fkst", prec(img),
                           prec(piv[:, :, off:off + block]))
        viol = torch.einsum("fksc,tc->fkst", lines,
                            pts[off:off + block]).abs() > threshold
        for vals, best, idx in ((torch.where(viol, 0.0, sim), best_m, idx_m),
                                (sim, best_a, idx_a)):
            v, i = vals.max(dim=-1)
            better = v > best
            best.copy_(torch.where(better, v, best))
            idx.copy_(torch.where(better, i + off, idx))
        all_bad &= viol.all(dim=-1)
    return torch.where(all_bad, idx_a, idx_m)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)
        self.key = ""

    def forward(self, x, context, mode="plain", cross_view=None, pivot=None):
        n = self.norm1(x)
        if mode == "plain":
            a = self.attn1(n)
        elif mode == "pivot_record":
            a = self.attn1(n, frames=x.shape[0] // 3)
            pivot[self.key] = (n, a)
        elif mode == "pivot_reuse":
            a = self._reuse(n, cross_view, *pivot[self.key])
        else:
            raise ValueError(mode)
        x = x + a
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))

    def _reuse(self, n, cv: CrossView, piv_n, piv_a):
        b, s, d = n.shape
        f = b // 3
        fk = piv_n.shape[0] // 3
        piv_n = piv_n.reshape(3, fk, s, d)
        piv_a = piv_a.reshape(3, fk, s, d)
        img = _unit(n.reshape(3, f, s, d)[1])
        keys = _unit(piv_n[1][cv.closest])
        idx = epipolar_argmax(getattr(self, "prec", Precision()), img, keys,
                              cv.lines[s], cv.pts[s], cv.threshold)
        got = piv_a[:, cv.closest[..., None], idx]  # [3, F, K, S, D]
        if cv.n_key == 2:
            w1 = cv.blend_w1.reshape(1, f, 1, 1)
            out = w1 * got[:, :, 0] + (1.0 - w1) * got[:, :, 1]
        else:
            out = got[:, :, 0]
        return out.reshape(b, s, d)


def _tokens(x):
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _image(x, h, w):
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Transformer2D(nn.Module):
    def __init__(self, c: int, heads: int, context_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, c, eps=1e-6)
        self.proj_in = Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(c, heads, c // heads, context_dim)])
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x, context, **kw):
        h, w = x.shape[2:]
        y = _tokens(self.proj_in(self.norm(x)))
        y = self.transformer_blocks[0](y, context, **kw)
        return self.proj_out(_image(y, h, w)) + x


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout) if temb else None
        self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return h + x


class Down(nn.Module):
    def __init__(self, c: int, padding: int):
        super().__init__()
        self.padding = padding
        self.conv = Conv2d(c, c, 3, stride=2, padding=padding)

    def forward(self, x):
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Up(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    pass


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear_1 = Linear(cin, cout)
        self.linear_2 = Linear(cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoids, cos first (diffusers, flip_sin_to_cos=True, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class UNet(nn.Module):
    """diffusers UNet2DConditionModel, SD-1.5 layout (the keys of
    ``unet/config.json``)."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch = list(cfg["block_out_channels"])
        n, layers = len(ch), int(cfg["layers_per_block"])
        heads, groups = int(cfg["attention_head_dim"]), int(
            cfg["norm_num_groups"])
        ctx = int(cfg["cross_attention_dim"])
        temb = ch[0] * 4
        self.ch0 = ch[0]
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.conv_in = Conv2d(int(cfg["in_channels"]), ch[0], 3, padding=1)
        skips, c = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for i in range(n):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(layers):
                blk.resnets.append(Resnet(c, ch[i], temb, groups, 1e-5))
                c = ch[i]
                skips.append(c)
            if i != n - 1:
                blk.attentions = nn.ModuleList([
                    Transformer2D(ch[i], heads, ctx, groups)
                    for _ in range(layers)])
                blk.downsamplers = nn.ModuleList([Down(ch[i], 1)])
                skips.append(c)
            self.down_blocks.append(blk)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([
            Resnet(c, c, temb, groups, 1e-5), Resnet(c, c, temb, groups,
                                                     1e-5)])
        self.mid_block.attentions = nn.ModuleList([
            Transformer2D(c, heads, ctx, groups)])
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            ci = ch[n - 1 - i]
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(layers + 1):
                blk.resnets.append(Resnet(c + skips.pop(), ci, temb, groups,
                                          1e-5))
                c = ci
            if i != 0:
                blk.attentions = nn.ModuleList([
                    Transformer2D(ci, heads, ctx, groups)
                    for _ in range(layers + 1)])
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([Up(ci)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = Conv2d(ch[0], int(cfg["out_channels"]), 3, padding=1)
        for name, m in self.named_modules():
            if isinstance(m, TransformerBlock):
                m.key = name

    def forward(self, x, t: int, context, **kw):
        ts = torch.full((x.shape[0],), int(t), device=x.device)
        temb = self.time_embedding(timestep_embedding(ts, self.ch0))
        h = self.conv_in(x)
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
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb),
                                             context, **kw), temb)
        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if attns is not None:
                    h = attns[j](h, context, **kw)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEAttention(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, c, eps=1e-6)
        self.to_q = Linear(c, c)
        self.to_k = Linear(c, c)
        self.to_v = Linear(c, c)
        self.to_out = nn.ModuleList([Linear(c, c), nn.Identity()])

    def forward(self, x):
        h, w = x.shape[2:]
        y = _tokens(self.group_norm(x))
        y = attend(getattr(self, "prec", Precision()), self.to_q(y),
                   self.to_k(y), self.to_v(y), 1)
        return _image(self.to_out[0](y), h, w) + x


def _vae_mid(c, groups):
    blk = _Block()
    blk.resnets = nn.ModuleList([Resnet(c, c, None, groups, 1e-6),
                                 Resnet(c, c, None, groups, 1e-6)])
    blk.attentions = nn.ModuleList([VAEAttention(c, groups)])
    return blk


def _run_mid(blk, h):
    return blk.resnets[1](blk.attentions[0](blk.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, g = list(cfg["block_out_channels"]), int(cfg["norm_num_groups"])
        layers = int(cfg["layers_per_block"])
        self.conv_in = Conv2d(int(cfg["in_channels"]), ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        c = ch[0]
        for i in range(len(ch)):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(layers):
                blk.resnets.append(Resnet(c, ch[i], None, g, 1e-6))
                c = ch[i]
            if i != len(ch) - 1:
                blk.downsamplers = nn.ModuleList([Down(c, 0)])
            self.down_blocks.append(blk)
        self.mid_block = _vae_mid(c, g)
        self.conv_norm_out = GroupNorm(g, c, eps=1e-6)
        self.conv_out = Conv2d(c, 2 * int(cfg["latent_channels"]), 3,
                               padding=1)

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
    def __init__(self, cfg: dict):
        super().__init__()
        ch, g = list(cfg["block_out_channels"]), int(cfg["norm_num_groups"])
        layers, n = int(cfg["layers_per_block"]), len(cfg["block_out_channels"])
        self.conv_in = Conv2d(int(cfg["latent_channels"]), ch[-1], 3,
                              padding=1)
        self.mid_block = _vae_mid(ch[-1], g)
        self.up_blocks = nn.ModuleList()
        c = ch[-1]
        for i in range(n):
            ci = ch[n - 1 - i]
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(layers + 1):
                blk.resnets.append(Resnet(c, ci, None, g, 1e-6))
                c = ci
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([Up(c)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(g, c, eps=1e-6)
        self.conv_out = Conv2d(c, int(cfg["in_channels"]), 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAE(nn.Module):
    """diffusers AutoencoderKL, SD layout (the keys of ``vae/config.json``);
    images [B, 3, H, W] in [-1, 1]."""

    def __init__(self, cfg: dict):
        super().__init__()
        c2 = 2 * int(cfg["latent_channels"])
        self.scale = float(cfg["scaling_factor"])
        self.down = 2 ** (len(cfg["block_out_channels"]) - 1)
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(c2, c2, 1)
        self.post_quant_conv = Conv2d(c2 // 2, c2 // 2, 1)

    def encode(self, x, noise: Optional[torch.Tensor] = None):
        """The scaled posterior sample at the standard normal draw
        ``noise`` [B, 4, h, w], or its mean."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        return mean * self.scale

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z / self.scale))


def names_and_shapes(module: nn.Module) -> Sequence:
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]
