"""CLIP vision tower (ViT) and the edit-quality scorer ``ClipSimilarity``.

JAX counterpart: ``dge_tpu/models/clip_vision.py``. Reference analog:
ClipSimilarity (threestudio/utils/clip_metrics.py:7-50), which scores the
text-image and directional similarity of an edit with CLIP. Parameter names
are transformers' ``CLIPVisionModelWithProjection`` names
(``vision_model.encoder.layers.0.self_attn.q_proj.weight``,
``visual_projection.weight``), so the vision half of a transformers
``CLIPModel`` state dict loads with ``load_state_dict``. The encoder layer
is the text tower's (``clip_text.CLIPLayer``) without a mask: attention
through ``layers.attend`` (SDPA pinned to ``EFFICIENT_ATTENTION`` on a
card; head width 64 at ViT-L/14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dge_tpu_torch.models.clip_text import CLIPLayer, CLIPTextConfig

# CLIP image normalisation
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """ViT-L/14 at 224^2 (openai/clip-vit-large-patch14)."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64, projection_dim=16)

    def layer_config(self) -> CLIPTextConfig:
        """The shared encoder layer's config."""
        return CLIPTextConfig(vocab_size=1, hidden_size=self.hidden_size,
                              num_layers=self.num_layers,
                              num_heads=self.num_heads,
                              max_length=self.num_positions,
                              intermediate_size=self.intermediate_size)

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        lcfg = cfg.layer_config()
        self.layers = nn.ModuleList(
            [CLIPLayer(lcfg) for _ in range(cfg.num_layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        # transformers' spelling
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPVisionModel(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size,
                                           config.projection_dim, bias=False)

    def init_like_flax(self, generator: torch.Generator) -> None:
        """The JAX module's default init (``layers.init_like_flax``), the
        class and position embeddings drawn at std 0.02 as its ``param``s
        are."""
        from dge_tpu_torch.models.layers import init_like_flax

        init_like_flax(self, generator)
        emb = self.vision_model.embeddings
        with torch.no_grad():
            emb.class_embedding.normal_(0.0, 0.02, generator=generator)
            emb.position_embedding.weight.normal_(0.0, 0.02,
                                                  generator=generator)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, 3, H, W], CLIP-normalised, at ``image_size`` -> the
        projected image features [B, projection_dim] (not normalised)."""
        vm = self.vision_model
        emb = vm.embeddings
        x = emb.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = emb.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class ClipSimilarity:
    """Edit-quality scorer (ClipSimilarity, clip_metrics.py:7-50): image
    features from the vision tower, text features from the text tower's
    projected pooled state (the reference's clip.encode_text), their
    cosine and directional similarities.
    Images are [B, H, W, 3] in [0, 1] (numpy or tensors); results are
    numpy arrays of length B."""

    def __init__(self, vision: CLIPVisionModel, text, tokenizer):
        self.vision = vision
        # a CLIPTextModel with a projection head: its projected pooled
        # state is the text feature
        self.text = text
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return self.vision.visual_projection.weight.device

    @torch.no_grad()
    def image_features(self, images) -> np.ndarray:
        """Unit image features [B, projection_dim]: bilinear resize to the
        tower's size (antialiased when it shrinks, as
        ``jax.image.resize``), CLIP normalisation, the tower."""
        size = self.vision.config.image_size
        x = (images if torch.is_tensor(images)
             else torch.from_numpy(np.asarray(images, np.float32)))
        x = x.to(self.device, torch.float32).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False, antialias=True)
        mean = torch.tensor(CLIP_MEAN, device=self.device)[None, :, None,
                                                           None]
        std = torch.tensor(CLIP_STD, device=self.device)[None, :, None, None]
        return _unit(self.vision((x - mean) / std).cpu().numpy())

    @torch.no_grad()
    def text_features(self, texts) -> np.ndarray:
        ids = torch.as_tensor(self.tokenizer(texts), dtype=torch.long,
                              device=self.device)
        return _unit(self.text(ids, return_pooled=True)[1].cpu().numpy())

    def __call__(self, img_src, img_edit, text_src, text_edit):
        """(sim_src, sim_edit, sim_direction, sim_image), as the reference's
        forward (clip_metrics.py:33-50)."""
        fi_s = self.image_features(img_src)
        fi_e = self.image_features(img_edit)
        ft_s = self.text_features(text_src)
        ft_e = self.text_features(text_edit)
        di, dt = fi_e - fi_s, ft_e - ft_s
        di = di / (np.linalg.norm(di, axis=-1, keepdims=True) + 1e-8)
        dt = dt / (np.linalg.norm(dt, axis=-1, keepdims=True) + 1e-8)
        return ((fi_s * ft_s).sum(-1), (fi_e * ft_e).sum(-1),
                (di * dt).sum(-1), (fi_s * fi_e).sum(-1))


def build_clip_similarity(params: Optional[dict] = None, tokenizer=None,
                          vision_cfg: Optional[CLIPVisionConfig] = None,
                          text_cfg: Optional[CLIPTextConfig] = None,
                          seed: int = 0, device="cuda") -> ClipSimilarity:
    """A ``ClipSimilarity`` on ``device``: ViT-L/14 and its text tower with a
    768-wide projection unless configs are given; ``params``
    (``{"vision", "text"}`` state dicts, from
    ``weights.load_clip_checkpoint`` or ``clip_vision_params_from_jax``)
    load strictly, otherwise the weights are random from ``seed`` (the
    scores then mean nothing). ``tokenizer`` defaults to the
    ``HashTokenizer`` of the text tower's vocabulary."""
    from dge_tpu_torch import resolve_device
    from dge_tpu_torch.diffusion.tokenizer import HashTokenizer
    from dge_tpu_torch.models.clip_text import CLIPTextModel

    dev = resolve_device(device)
    vision_cfg = vision_cfg or CLIPVisionConfig()
    text_cfg = text_cfg or CLIPTextConfig(projection_dim=768)
    with dev:
        vision = CLIPVisionModel(vision_cfg)
        text = CLIPTextModel(text_cfg)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        vision.init_like_flax(gen)
        text.init_like_flax(gen)
    else:
        vision.load_state_dict(params["vision"])
        text.load_state_dict(params["text"])
    for m in (vision, text):
        m.eval().requires_grad_(False)
    tokenizer = tokenizer or HashTokenizer(vocab_size=text_cfg.vocab_size,
                                           max_length=text_cfg.max_length)
    return ClipSimilarity(vision, text, tokenizer)
