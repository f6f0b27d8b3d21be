"""CLIP text encoder (ViT-L/14 text tower, the SD-1.5 text encoder; SDXL's
two towers).

JAX counterpart: ``dge_tpu/models/clip_text.py`` (the SD-1.5 tower). The
defaults: 12 layers, d=768, 12 heads, vocab 49408, max_len 77, causal
mask, quick-GELU, the final layer norm's output. Parameter names are
transformers' CLIPTextModel names (``text_model.encoder.layers.0.
self_attn.q_proj.weight``); the optional ``text_projection`` is
CLIPTextModelWithProjection's head. SDXL reads both its towers at the
penultimate layer (``hidden_state_index=-2``, transformers'
``hidden_states[-2]``, no final norm): CLIP-L (``sdxl_l``) and OpenCLIP
ViT-bigG/14 (``open_clip_bigg``: 32 layers, d=1280, 20 heads, MLP 5120,
exact GELU, a 1280 projection whose EOS state is the pooled embedding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dge_tpu_torch.models.layers import (Embedding, LayerNorm, Linear, attend,
                                         init_like_flax)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    intermediate_size: int = 3072
    # the text_projection head (the metrics CLIP uses 768); the SD-1.5 text
    # encoder has none
    projection_dim: Optional[int] = None
    # the MLP's activation: "quick_gelu" (OpenAI CLIP) or "gelu" (exact)
    hidden_act: str = "quick_gelu"
    # the states returned: None, the final layer norm's output; an index k,
    # transformers' hidden_states[k] (k = -2: the penultimate layer's
    # output, no final norm)
    hidden_state_index: Optional[int] = None

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                   max_length=16, intermediate_size=64)

    @classmethod
    def sdxl_l(cls) -> "CLIPTextConfig":
        """SDXL's first tower: CLIP ViT-L/14's, read at the penultimate
        layer."""
        return cls(hidden_state_index=-2)

    @classmethod
    def open_clip_bigg(cls) -> "CLIPTextConfig":
        """SDXL's second tower (``text_encoder_2``)."""
        return cls(hidden_size=1280, num_layers=32, num_heads=20,
                   intermediate_size=5120, projection_dim=1280,
                   hidden_act="gelu", hidden_state_index=-2)

    @classmethod
    def tiny_xl(cls) -> "Tuple[CLIPTextConfig, CLIPTextConfig]":
        """The two SDXL towers at test size: 16 + 16 wide (a 32-wide
        context), the second with the exact GELU and a 24-wide
        projection."""
        small = dict(vocab_size=1000, hidden_size=16, num_layers=2,
                     num_heads=2, max_length=16, hidden_state_index=-2)
        return (cls(intermediate_size=32, **small),
                cls(intermediate_size=64, projection_dim=24,
                    hidden_act="gelu", **small))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = Linear(d, d, dtype=dtype)
        self.k_proj = Linear(d, d, dtype=dtype)
        self.v_proj = Linear(d, d, dtype=dtype)
        self.out_proj = Linear(d, d, dtype=dtype)

    def forward(self, x, mask=None):
        """x [B, S, D]; ``mask`` [S, S] bool (True = attend) runs the JAX
        form with masked dense logits (f32, clip_text.py:65-67);
        ``mask=None`` attends to every token through ``layers.attend``
        (SDPA on a card: the vision tower)."""
        if mask is None:
            return self.out_proj(attend(self.q_proj(x), self.k_proj(x),
                                        self.v_proj(x), self.heads))
        b, s, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, s, self.heads, hd).transpose(1, 2)

        q = self.q_proj(x) * hd ** -0.5
        logits = torch.einsum("bhqd,bhkd->bhqk", split(q).float(),
                              split(self.k_proj(x)).float())
        logits = torch.where(mask, logits, torch.tensor(
            -1e9, dtype=logits.dtype, device=logits.device))
        v = split(self.v_proj(x))
        out = torch.einsum("bhqk,bhkd->bhqd",
                           torch.softmax(logits, dim=-1).to(v.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)
        if cfg.hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unknown hidden_act {cfg.hidden_act!r}")
        self.act = quick_gelu if cfg.hidden_act == "quick_gelu" else F.gelu

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, 1e-5, dtype)
        self.self_attn = CLIPAttention(cfg, dtype)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, 1e-5, dtype)
        self.mlp = CLIPMLP(cfg, dtype)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype)
        # an f32 parameter in every dtype, as the JAX module's ``param``: the
        # residual stream it starts stays f32 (clip_text.py:105-111)
        self.position_embedding = nn.Embedding(cfg.max_length,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPLayer(cfg, dtype) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        self.embeddings = _Embeddings(cfg, dtype)
        self.encoder = _Encoder(cfg, dtype)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, 1e-5, dtype)


class CLIPTextModel(nn.Module):
    """``dtype``: the computation dtype (models/layers.py's rules; the JAX
    module's ``dtype``)."""

    def __init__(self, config: CLIPTextConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.text_model = _TextTransformer(config, dtype)
        self.text_projection = (
            Linear(config.hidden_size, config.projection_dim, bias=False,
                   dtype=dtype)
            if config.projection_dim is not None else None)

    def init_like_flax(self, generator: torch.Generator) -> None:
        """The JAX module's default init (models/layers.init_like_flax), with
        the position table drawn at std 0.01 as its ``param`` is."""
        init_like_flax(self, generator)
        with torch.no_grad():
            self.text_model.embeddings.position_embedding.weight.normal_(
                0.0, 0.01, generator=generator)

    def forward(self, input_ids: torch.Tensor, return_pooled: bool = False):
        """input_ids [B, S] -> hidden states [B, S, D] (the final layer
        norm's output, or those ``hidden_state_index`` names); with
        ``return_pooled`` also the projected final state at the EOS token
        (the largest id) [B, projection_dim]."""
        tm = self.text_model
        b, s = input_ids.shape
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[None, :s])
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                       device=input_ids.device))
        hidden = [x]  # transformers' hidden_states
        for layer in tm.encoder.layers:
            x = layer(x, causal)
            hidden.append(x)
        final = tm.final_layer_norm(x)
        index = self.config.hidden_state_index
        out = final if index is None else hidden[index]
        if not return_pooled:
            return out
        if self.text_projection is None:
            raise ValueError(
                "return_pooled=True requires CLIPTextConfig.projection_dim")
        pooled = final[torch.arange(b, device=x.device),
                       input_ids.argmax(dim=-1)]
        return out, self.text_projection(pooled)
