"""Quality metrics: PSNR / SSIM (and an optional perceptual distance) over
render directories, and the CLIP similarity arithmetic.

JAX counterpart: ``dge_tpu/ops/metrics.py``; reference analogs
gaussiansplatting/metrics.py:36-93 and utils/clip_metrics.py.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dge_tpu_torch import resolve_device
from dge_tpu_torch.ops import losses as L
from dge_tpu_torch.utils import saving


def evaluate_pair_dirs(
    renders_dir: str,
    gt_dir: str,
    perceptual_fn: Optional[Callable] = None,
    device="cuda",
) -> Dict:
    """Compare same-named images in two directories (metrics.py semantics).
    Returns {psnr, ssim, per_view} and, with ``perceptual_fn``, lpips."""
    dev = resolve_device(device)
    names = sorted(f for f in os.listdir(renders_dir)
                   if f.lower().endswith((".png", ".jpg")))
    per_view = {}
    for name in names:
        a = torch.from_numpy(
            saving.load_image(os.path.join(renders_dir, name))).to(dev)
        b = torch.from_numpy(
            saving.load_image(os.path.join(gt_dir, name))).to(dev)
        entry = {"psnr": float(L.psnr(a, b)), "ssim": float(L.ssim(a, b))}
        if perceptual_fn is not None:
            entry["lpips"] = float(perceptual_fn(a, b))
        per_view[name] = entry

    def mean(key):
        vals = [e[key] for e in per_view.values() if key in e]
        return float(np.mean(vals)) if vals else None

    out = {"psnr": mean("psnr"), "ssim": mean("ssim"), "per_view": per_view}
    if perceptual_fn is not None and per_view:
        out["lpips"] = mean("lpips")
    return out


def clip_similarity(image_feats: np.ndarray, text_feats: np.ndarray
                    ) -> np.ndarray:
    """Cosine similarity between CLIP features (clip_metrics.py:33-50); the
    caller extracts the features."""
    a = image_feats / np.linalg.norm(image_feats, axis=-1, keepdims=True)
    b = text_feats / np.linalg.norm(text_feats, axis=-1, keepdims=True)
    return (a * b).sum(-1)


def clip_directional_similarity(img_feats_src, img_feats_edit, text_feats_src,
                                text_feats_edit) -> np.ndarray:
    """Directional CLIP similarity: the edit direction in image space against
    the one in text space."""
    di = img_feats_edit - img_feats_src
    dt = text_feats_edit - text_feats_src
    di = di / (np.linalg.norm(di, axis=-1, keepdims=True) + 1e-8)
    dt = dt / (np.linalg.norm(dt, axis=-1, keepdims=True) + 1e-8)
    return (di * dt).sum(-1)
