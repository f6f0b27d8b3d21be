"""Text-prompted segmentation backends for local editing.

JAX counterpart: ``dge_tpu/systems/segmentation.py``. Reference analog:
LangSAMTextSegmentor (threestudio/utils/sam.py:14-63), lang-segment-anything
with a full-mask fallback on failure. The contract is a per-view [H, W]
float mask in {0, 1} for a text prompt:

- ``precomputed``: mask PNGs from a directory, one per view id, read with
  the port's own image codec (utils/saving.load_image)
- ``torch_sam``: lang_sam / segment-anything where importable (gated)
- fallback: the full-image mask, the reference's failure behaviour
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from dge_tpu_torch.utils import saving


def full_mask_segmentor(image: np.ndarray, prompt: str) -> np.ndarray:
    """Reference fallback: everything is editable (sam.py:31-63)."""
    return np.ones(image.shape[:2], np.float32)


def _resize_nearest(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.INTER_NEAREST: source index floor(dst · src / dst)."""
    ys = np.minimum((np.arange(h) * (m.shape[0] / h)).astype(int),
                    m.shape[0] - 1)
    xs = np.minimum((np.arange(w) * (m.shape[1] / w)).astype(int),
                    m.shape[1] - 1)
    return m[ys][:, xs]


def precomputed_segmentor(mask_dir: str) -> Callable:
    """Masks from ``<mask_dir>/<view_id:04d>.png`` (grayscale, >127 = in)."""
    state = {"next_id": 0}

    def seg(image: np.ndarray, prompt: str, view_id: Optional[int] = None):
        vid = state["next_id"] if view_id is None else view_id
        if view_id is None:
            state["next_id"] += 1
        path = os.path.join(mask_dir, f"{vid:04d}.png")
        if not os.path.exists(path):
            return full_mask_segmentor(image, prompt)
        m = np.round(saving.load_image(path)[..., 0] * 255.0)
        if m.shape != image.shape[:2]:
            m = _resize_nearest(m, *image.shape[:2])
        return (m > 127).astype(np.float32)

    return seg


def torch_sam_segmentor() -> Callable:
    """lang_sam-backed segmentor when the package and its weights exist
    locally; mirrors LangSAMTextSegmentor's predict and fallback
    (sam.py:22-63)."""
    try:
        from lang_sam import LangSAM  # type: ignore

        model = LangSAM()
    except Exception:  # the optional package or its weights are missing
        return full_mask_segmentor

    def seg(image: np.ndarray, prompt: str):
        try:
            from PIL import Image

            pil = Image.fromarray(
                (np.clip(image, 0, 1) * 255).astype(np.uint8))
            masks = model.predict([pil], [prompt])[0]["masks"]
            if len(masks) == 0:
                return full_mask_segmentor(image, prompt)
            return np.asarray(masks[0]).astype(np.float32)
        except Exception:  # the reference's fallback on a failed predict
            return full_mask_segmentor(image, prompt)

    return seg


def build_segmentor(kind: str = "fallback", mask_dir: str = "") -> Callable:
    if kind == "precomputed":
        return precomputed_segmentor(mask_dir)
    if kind == "torch_sam":
        return torch_sam_segmentor()
    return full_mask_segmentor
