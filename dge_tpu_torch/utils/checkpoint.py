"""Checkpoint and resume of a fit: scene, Adam state, densification
statistics and, when given, a random generator's state.

JAX counterpart: ``dge_tpu/utils/checkpoint.py`` (orbax there). Here one
``torch.save`` of plain dicts of tensors and numbers, read back with
``torch.load(weights_only=True)``, and ``<path>_meta.json`` beside it as in
the JAX version. Reference analogs: Lightning ckpts and
GaussianModel.capture()/restore() (gaussian_model.py:110-204).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import torch

from dge_tpu_torch import resolve_device
from dge_tpu_torch.scene.gaussians import GaussianScene
from dge_tpu_torch.systems.fit import FitState


def save_checkpoint(path: str, scene: GaussianScene, opt_state: Dict[str, dict],
                    fit_state: FitState, extra: Optional[Dict] = None,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write a full training checkpoint (capture() analog). ``extra`` goes
    into ``<path>_meta.json`` and must be JSON-serialisable."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def host(tree):
        return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                for k, v in tree.items()}

    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    payload = {
        "scene": host(fields(scene)),
        "opt_state": {k: host(st) for k, st in opt_state.items()},
        "fit_state": host(fields(fit_state)),
    }
    if generator is not None:
        payload["generator_state"] = generator.get_state()
    torch.save(payload, path)
    meta = {"max_sh_degree": scene.max_sh_degree, **(extra or {})}
    with open(path + "_meta.json", "w") as f:
        json.dump(meta, f)
    return path


def restore_checkpoint(path: str, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[GaussianScene, Dict[str, dict], FitState,
                                  dict]:
    """Read a checkpoint onto ``device`` → (scene, opt_state, fit_state,
    meta). A saved generator state is put into ``generator`` when one is
    passed (it must live where the saved one did)."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)

    def put(tree):
        return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                for k, v in tree.items()}

    scene = GaussianScene(**put(payload["scene"]))
    opt_state = {k: put(st) for k, st in payload["opt_state"].items()}
    fit_state = FitState(**put(payload["fit_state"]))
    if generator is not None and "generator_state" in payload:
        generator.set_state(payload["generator_state"])
    meta = {}
    if os.path.exists(path + "_meta.json"):
        with open(path + "_meta.json") as f:
            meta = json.load(f)
    return scene, opt_state, fit_state, meta
