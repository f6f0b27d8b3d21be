"""Plain float32 SDXL UNet (InstructPix2Pix, 8 input channels) with its
text-time conditioning, the CLIP text towers SDXL reads, and a DGE round
over them.

A frozen copy of the architecture of ``diffusers/sdxl-instructpix2pix-768``
as diffusers defines it (its ``unet/config.json`` keys; parameter names
included, so one state dict loads into the program and into this copy),
built from ``sd15.py``'s blocks, which carry DGE's attention surgery
(``"plain"``, ``"pivot_record"``, ``"pivot_reuse"``) into every one of the
70 transformer blocks unchanged. ``set_precision`` (``sd15.py``) rounds the
operands of every product (the control).

Where this copy departs from diffusers:

- the cross-view modes are DGE's (threestudio/utils/dge_utils.py), which
  upstream DGE applies to SD-1.5 only; here every ``BasicTransformerBlock``
  of the SDXL UNet takes them;
- ``attention_head_dim`` is read as diffusers reads it for this UNet: the
  number of heads at each level (5 / 10 / 20, 64 wide);
- the UNet always takes the pooled embedding and the time ids
  (``addition_embed_type`` ``text_time`` only); ``PromptConditioned`` gives
  one prompt's pooled embeddings and the time ids of uncropped frames of
  the round's size, (H, W, 0, 0, H, W), as the pipeline's defaults do;
- the text towers run the causal mask only (no padding mask, as
  transformers' CLIPTextModel), return ``hidden_states[-2]`` (SDXL's
  penultimate layer) and pool the final layer norm's state at the largest
  token id (the end token);
- no dropout, no attention upcasting switch (everything is float32), and
  the VAE is ``sd15.VAE`` (SDXL's has the same layout, scale 0.13025).

The round is ``dge.edit_round`` over ``PromptConditioned(unet)``: one
prompt conditions every view, so the pooled embeddings of a CFG triple are
(pos, neg, neg) over its frames.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import dge, sd15
from benchmark.reference.sd15 import (Conv2d, Down, GroupNorm, LayerNorm,
                                      Linear, Resnet, TimestepEmbedding,
                                      TransformerBlock, Up, _Block,
                                      timestep_embedding)


class Transformer2D(nn.Module):
    """diffusers Transformer2DModel: ``depth`` blocks, Linear projections
    on the tokens (``use_linear_projection``) or 1x1 convolutions."""

    def __init__(self, c: int, heads: int, context_dim: int, groups: int,
                 depth: int, linear: bool):
        super().__init__()
        self.linear = linear
        self.norm = GroupNorm(groups, c, eps=1e-6)
        self.proj_in = Linear(c, c) if linear else Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(c, heads, c // heads, context_dim)
            for _ in range(depth)])
        self.proj_out = Linear(c, c) if linear else Conv2d(c, c, 1)

    def forward(self, x, context, **kw):
        h, w = x.shape[2:]
        y = self.norm(x)
        y = (self.proj_in(sd15._tokens(y)) if self.linear
             else sd15._tokens(self.proj_in(y)))
        for blk in self.transformer_blocks:
            y = blk(y, context, **kw)
        y = (sd15._image(self.proj_out(y), h, w) if self.linear
             else self.proj_out(sd15._image(y, h, w)))
        return y + x


class UNet(nn.Module):
    """diffusers UNet2DConditionModel in the SDXL layout (the keys of
    ``unet/config.json``: ``down_block_types`` says which levels attend,
    ``transformer_layers_per_block`` how deep, the mid block as deep as
    the lowest level, the up path mirrored)."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch = list(cfg["block_out_channels"])
        n, layers = len(ch), int(cfg["layers_per_block"])
        heads = list(cfg["attention_head_dim"])
        depth = list(cfg["transformer_layers_per_block"])
        attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        groups, ctx = int(cfg["norm_num_groups"]), int(
            cfg["cross_attention_dim"])
        linear = bool(cfg["use_linear_projection"])
        temb = ch[0] * 4
        self.ch0 = ch[0]
        self.time_dim = int(cfg["addition_time_embed_dim"])

        def transformer(level, c):
            return Transformer2D(c, heads[level], ctx, groups, depth[level],
                                 linear)

        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(
            int(cfg["projection_class_embeddings_input_dim"]), temb)
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
            if attn[i]:
                blk.attentions = nn.ModuleList([
                    transformer(i, ch[i]) for _ in range(layers)])
            if i != n - 1:
                blk.downsamplers = nn.ModuleList([Down(ch[i], 1)])
                skips.append(c)
            self.down_blocks.append(blk)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([
            Resnet(c, c, temb, groups, 1e-5), Resnet(c, c, temb, groups,
                                                     1e-5)])
        self.mid_block.attentions = nn.ModuleList([transformer(n - 1, c)])
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            lv = n - 1 - i
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(layers + 1):
                blk.resnets.append(Resnet(c + skips.pop(), ch[lv], temb,
                                          groups, 1e-5))
                c = ch[lv]
            if attn[lv]:
                blk.attentions = nn.ModuleList([
                    transformer(lv, ch[lv]) for _ in range(layers + 1)])
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([Up(ch[lv])])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = Conv2d(ch[0], int(cfg["out_channels"]), 3, padding=1)
        for name, m in self.named_modules():
            if isinstance(m, TransformerBlock):
                m.key = name

    def forward(self, x, t: int, context, pooled, time_ids, **kw):
        """x [B, 8, h, w], pooled [B, P], time_ids [B, 6]."""
        b = x.shape[0]
        ts = torch.full((b,), int(t), device=x.device)
        temb = self.time_embedding(timestep_embedding(ts, self.ch0))
        tid = timestep_embedding(time_ids.reshape(-1), self.time_dim)
        temb = temb + self.add_embedding(
            torch.cat([pooled.float(), tid.reshape(b, -1)], dim=-1))
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


class PromptConditioned(nn.Module):
    """The UNet with one prompt's pooled embeddings ``pooled_pos`` /
    ``pooled_neg`` [1, P] and the time ids of uncropped ``height`` x
    ``width`` frames bound, called as ``sd15.UNet`` is: a batch of three
    CFG chunks (pos, neg, neg) of equal size."""

    def __init__(self, unet: UNet, pooled_pos, pooled_neg, height: int,
                 width: int):
        super().__init__()
        self.unet = unet
        self.register_buffer("pooled_pos", pooled_pos.float().reshape(1, -1))
        self.register_buffer("pooled_neg", pooled_neg.float().reshape(1, -1))
        self.size = (height, width)

    def forward(self, x, t: int, context, **kw):
        f = x.shape[0] // 3
        pooled = torch.cat([self.pooled_pos.expand(f, -1),
                            self.pooled_neg.expand(2 * f, -1)])
        ids = time_ids(*self.size, device=x.device).expand(x.shape[0], 6)
        return self.unet(x, t, context, pooled, ids, **kw)


def edit_round(unet: UNet, vae: sd15.VAE, rgb, cond_rgb, emb_pos, emb_neg,
               pooled_pos, pooled_neg, full_proj, campos,
               gen: torch.Generator, recipe: dict, t_start: int):
    """``dge.edit_round`` over the SDXL UNet: one prompt's text states
    [B, S, D] and pooled embeddings [1, P]."""
    h, w = rgb.shape[1:3]
    net = PromptConditioned(unet, pooled_pos, pooled_neg, h, w)
    return dge.edit_round(net, vae, rgb, cond_rgb, emb_pos, emb_neg,
                          full_proj, campos, gen, recipe, t_start)


def pass_flops(unet: UNet, vae: sd15.VAE, views: int, height: int,
               width: int, cbs: int, text_len: int, text_dim: int,
               pooled_dim: int, device="meta") -> dict:
    """``dge.pass_flops`` over the SDXL UNet (its added embedding
    included)."""
    z = torch.zeros(1, pooled_dim, device=device)
    net = PromptConditioned(unet, z, z, height, width)
    return dge.pass_flops(net, vae, views, height, width, cbs, text_len,
                          text_dim, device)


# ---- the text towers ----

class _Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, s, self.heads, hd).transpose(1, 2)

        q, k, v = (split(p(x)) for p in (self.q_proj, self.k_proj,
                                          self.v_proj))
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, -math.inf)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int, act: str):
        super().__init__()
        self.fc1, self.fc2 = Linear(d, inner), Linear(inner, d)
        self.act = act

    def forward(self, x):
        h = self.fc1(x)
        h = (h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu"
             else F.gelu(h))
        return self.fc2(h)


class _Layer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = int(cfg["hidden_size"])
        self.layer_norm1 = LayerNorm(d, eps=1e-5)
        self.self_attn = _Attention(d, int(cfg["num_attention_heads"]))
        self.layer_norm2 = LayerNorm(d, eps=1e-5)
        self.mlp = _MLP(d, int(cfg["intermediate_size"]), cfg["hidden_act"])

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class TextTower(nn.Module):
    """transformers CLIPTextModel (CLIPTextModelWithProjection with a
    ``projection_dim``), from the keys of its ``config.json``."""

    def __init__(self, cfg: dict):
        super().__init__()
        d = int(cfg["hidden_size"])
        tm = _Block()
        tm.embeddings = _Block()
        tm.embeddings.token_embedding = nn.Embedding(int(cfg["vocab_size"]), d)
        tm.embeddings.position_embedding = nn.Embedding(
            int(cfg["max_position_embeddings"]), d)
        tm.encoder = _Block()
        tm.encoder.layers = nn.ModuleList([
            _Layer(cfg) for _ in range(int(cfg["num_hidden_layers"]))])
        tm.final_layer_norm = LayerNorm(d, eps=1e-5)
        self.text_model = tm
        p = cfg.get("projection_dim")
        self.text_projection = Linear(d, int(p), bias=False) if p else None

    def forward(self, ids) -> tuple:
        """ids [B, S] -> (hidden_states[-2] [B, S, D], the projected
        pooled state [B, P] or None)."""
        tm = self.text_model
        x = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding.weight[:ids.shape[1]])
        states = [x]
        for layer in tm.encoder.layers:
            x = layer(x)
            states.append(x)
        if self.text_projection is None:
            return states[-2], None
        final = tm.final_layer_norm(x)
        pooled = final[torch.arange(ids.shape[0], device=ids.device),
                       ids.argmax(dim=-1)]
        return states[-2], self.text_projection(pooled)


def encode_prompt(tower_l: TextTower, tower_g: TextTower, ids, ids_2=None):
    """SDXL's text conditioning: both towers' penultimate states
    concatenated [B, S, D_l + D_g] and the second tower's pooled embedding
    [B, P]."""
    h_l, _ = tower_l(ids)
    h_g, pooled = tower_g(ids if ids_2 is None else ids_2)
    return torch.cat([h_l, h_g], dim=-1), pooled


def time_ids(height: int, width: int, device=None) -> torch.Tensor:
    """The time ids of uncropped ``height`` x ``width`` frames [6]."""
    return torch.tensor([height, width, 0, 0, height, width],
                        dtype=torch.float32, device=device)

