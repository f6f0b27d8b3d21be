"""Scene-editing utilities on GaussianScene: mask growth, concatenation,
localized views, anchors.

JAX counterpart: ``dge_tpu/scene/editing.py``. Reference analogs
(GaussianEditor's additions to GaussianModel):

- get_near_gaussians_by_mask: grow the editable mask to nearby Gaussians
  through a bounding box and a nearest-neighbour test
  (gaussian_model.py:865-898)
- concat_gaussians (gaussian_model.py:900-923)
- the localize views that restrict rendering to the masked subset
  (gaussian_model.py:217-268)
- the anchor state and the per-generation anchor loss
  (gaussian_model.py:126-184; configured but not added to DGE's training
  loss, kept for custom loops)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dge_tpu_torch.scene.gaussians import GaussianScene, from_arrays

MAX_ANCHOR_WEIGHT = 10.0  # gaussian_model.py:38


def grow_mask_to_neighbors(scene: GaussianScene, mask: torch.Tensor,
                           dist_thresh: float = 0.1) -> torch.Tensor:
    """Extend a per-Gaussian bool mask to nearby Gaussians: the alive
    candidates inside the masked set's 3-97% quantile box scaled by 1.3
    whose nearest masked neighbour lies within ``dist_thresh``. Returns the
    grown bool mask on the scene's device. The neighbour search runs on the
    host (scipy's cKDTree); it runs once per edit, not per step."""
    from scipy.spatial import cKDTree

    xyz = scene.xyz.detach().cpu().numpy()
    alive = scene.alive.cpu().numpy()
    m = torch.as_tensor(mask).cpu().numpy().astype(bool) & alive
    if m.any():
        sel = xyz[m]
        lo = np.quantile(sel, 0.03, axis=0)
        hi = np.quantile(sel, 0.97, axis=0)
        mid, half = (lo + hi) / 2, (hi - lo) * 1.3 / 2
        lo, hi = mid - half, mid + half
        cand = np.where(alive & ~m & np.all((xyz >= lo) & (xyz <= hi),
                                            axis=1))[0]
        if len(cand):
            d, _ = cKDTree(sel).query(xyz[cand], k=1)
            m[cand[d <= dist_thresh]] = True
    return torch.from_numpy(m).to(scene.device)


def localized(scene: GaussianScene,
              mask: Optional[torch.Tensor] = None) -> GaussianScene:
    """The scene restricted to the masked subset (``grad_mask > 0`` when no
    mask is given) by clearing ``alive`` outside it: the shapes stay, no
    row is sliced out."""
    m = (scene.grad_mask > 0) if mask is None else mask.to(torch.bool)
    return scene.replace(alive=scene.alive & m)


def concat_scenes(a: GaussianScene, b: GaussianScene) -> GaussianScene:
    """The alive Gaussians of ``a`` followed by those of ``b`` in a new
    scene (concat_gaussians). The SH degrees must match."""
    if a.max_sh_degree != b.max_sh_degree:
        raise ValueError(f"SH degrees differ: {a.max_sh_degree} and "
                         f"{b.max_sh_degree}")

    def cat(name):
        return np.concatenate(
            [getattr(s, name).detach().cpu().numpy()[s.alive.cpu().numpy()]
             for s in (a, b)], axis=0)

    return from_arrays(*(cat(k) for k in ("xyz", "features_dc",
                                          "features_rest", "opacity",
                                          "scaling", "rotation")),
                       max_sh_degree=a.max_sh_degree,
                       active_sh_degree=int(a.active_sh_degree),
                       device=a.device)


def anchor_snapshot(scene: GaussianScene) -> Dict[str, torch.Tensor]:
    """The anchor state (update_anchor): detached copies of the anchored
    fields, the generation tags and ``alive``."""
    return {k: getattr(scene, k).detach().clone()
            for k in ("xyz", "features_dc", "opacity", "scaling",
                      "generation", "alive")}


def anchor_loss(scene: GaussianScene, anchor: Dict[str, torch.Tensor],
                generation_weights: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Generation-weighted squared distance to the anchor snapshot
    (gaussian_model.anchor_loss): a newer densify generation is pulled less
    toward the anchor; weights ``min(10, 1 + generation)`` unless
    ``generation_weights`` (indexed by the clipped generation) are given."""
    valid = scene.alive & anchor["alive"]
    if generation_weights is None:
        gw = torch.clamp(1.0 + scene.generation.float(),
                         max=MAX_ANCHOR_WEIGHT)
    else:
        gw = generation_weights[torch.clamp(
            scene.generation.long(), 0, len(generation_weights) - 1)]
    w = torch.where(valid, gw, torch.zeros_like(gw))

    def field(name):
        d = (getattr(scene, name) - anchor[name]) ** 2
        return (w * d.reshape(d.shape[0], -1).sum(dim=1)).sum()

    total = sum(field(k) for k in ("xyz", "features_dc", "opacity",
                                   "scaling"))
    return total / torch.clamp(w.sum(), min=1.0)
