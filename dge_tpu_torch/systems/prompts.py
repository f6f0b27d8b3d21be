"""Prompt processing: text -> CLIP embeddings with disk cache and
view-dependent variants.

JAX counterpart: ``dge_tpu/systems/prompts.py`` (a copy: it is numpy only,
and the port imports nothing of the JAX package). Reference analog:
threestudio/models/prompt_processors/base.py — md5-keyed embedding cache
(:340-404), view-dependent prompt variants (side/front/back/overhead,
:226-295), and PromptProcessorOutput returning [cond, uncond] embeddings
(:51-78). The encoder runs in-process; the embeddings are kept as numpy
arrays on the host. An encoder that also gives a pooled embedding (SDXL's
``ip2p.encode_text``: ``(states, pooled)``) has it cached and returned
beside the states (``PromptOutput.cond_pooled`` / ``uncond_pooled``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PromptConfig:
    prompt: str = ""
    negative_prompt: str = ""
    front_threshold: float = 45.0
    back_threshold: float = 45.0
    overhead_threshold: float = 60.0
    use_view_dependent: bool = False


VIEW_SUFFIXES = {
    "side": ", side view",
    "front": ", front view",
    "back": ", back view",
    "overhead": ", overhead view",
}


def view_dependent_prompts(prompt: str) -> Dict[str, str]:
    """The four directional variants (base.py:226-295)."""
    return {k: prompt + s for k, s in VIEW_SUFFIXES.items()}


def classify_view(
    azimuth_deg: float, elevation_deg: float, cfg: PromptConfig
) -> str:
    if elevation_deg > cfg.overhead_threshold:
        return "overhead"
    a = (azimuth_deg + 180.0) % 360.0 - 180.0
    if abs(a) < cfg.front_threshold:
        return "front"
    if abs(a) > 180.0 - cfg.back_threshold:
        return "back"
    return "side"


def _to_numpy(x) -> np.ndarray:
    """An encoder output (a tensor on any device, or an array) on the
    host."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class PromptProcessor:
    """Encode prompts once, cache to .npz keyed by md5 (mirrors the
    reference's .threestudio_cache/text_embeddings layout)."""

    def __init__(
        self, tokenizer, encode_fn, cache_dir: Optional[str] = None,
        cfg: Optional[PromptConfig] = None,
    ):
        self.tokenizer = tokenizer
        # ids [B, S] -> embeddings [B, S, D], or (them, pooled [B, P])
        self.encode_fn = encode_fn
        self.cache_dir = cache_dir
        self.cfg = cfg or PromptConfig()
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self._mem: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {}

    def _cache_path(self, text: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        key = hashlib.md5(text.encode()).hexdigest()
        return os.path.join(self.cache_dir, f"{key}.npz")

    def encode(self, text: str) -> np.ndarray:
        return self.encode_pooled(text)[0]

    def encode_pooled(self, text: str
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(states [S, D], pooled [P] or None)."""
        if text in self._mem:
            return self._mem[text]
        path = self._cache_path(text)
        if path and os.path.exists(path):
            with np.load(path) as z:
                out = (z["emb"], z["pooled"] if "pooled" in z else None)
        else:
            ids = self.tokenizer([text])
            enc = self.encode_fn(ids)
            if isinstance(enc, tuple):
                out = (_to_numpy(enc[0])[0], _to_numpy(enc[1])[0])
            else:
                out = (_to_numpy(enc)[0], None)
            if path:
                np.savez(path, emb=out[0], **(
                    {} if out[1] is None else {"pooled": out[1]}))
        self._mem[text] = out
        return out

    def __call__(self) -> "PromptOutput":
        cfg = self.cfg
        variants = (
            {k: self.encode(v) for k, v in view_dependent_prompts(cfg.prompt).items()}
            if cfg.use_view_dependent
            else None
        )
        cond, cond_pooled = self.encode_pooled(cfg.prompt)
        uncond, uncond_pooled = self.encode_pooled(cfg.negative_prompt)
        return PromptOutput(
            cond=cond,
            uncond=uncond,
            variants=variants,
            cfg=cfg,
            cond_pooled=cond_pooled,
            uncond_pooled=uncond_pooled,
        )


@dataclasses.dataclass
class PromptOutput:
    cond: np.ndarray  # [S, D]
    uncond: np.ndarray  # [S, D]
    variants: Optional[Dict[str, np.ndarray]] = None
    cfg: Optional[PromptConfig] = None
    cond_pooled: Optional[np.ndarray] = None  # [P] (SDXL)
    uncond_pooled: Optional[np.ndarray] = None

    def get_text_embeddings(
        self, azimuth_deg: Optional[float] = None,
        elevation_deg: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(cond, uncond); view-dependent variant when angles are given
        (PromptProcessorOutput.get_text_embeddings, base.py:51-78)."""
        cond = self.cond
        if (
            self.variants is not None
            and azimuth_deg is not None
            and elevation_deg is not None
        ):
            cond = self.variants[
                classify_view(azimuth_deg, elevation_deg, self.cfg)
            ]
        return cond, self.uncond
