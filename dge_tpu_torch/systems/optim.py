"""Per-group Adam for the Gaussian parameters, as plain functions on a
small state of tensors.

JAX counterpart: ``dge_tpu/systems/optim.py`` (optax ``multi_transform`` of
six ``optax.adam`` groups). Reference analog: GaussianModel.training_setup
(gaussian_model.py:336-380): six Adam groups (xyz, f_dc, f_rest, opacity,
scaling, rotation) with eps=1e-15 and an exponential-decay LR schedule on
xyz.

The state lives in the same padded buffers as the parameters:
``state[name] = {"mu", "nu", "count"}`` with ``mu``/``nu`` shaped like the
parameter and ``count`` a Python int. Densify returns a row mask and
``zero_adam_rows`` clears the moments of those rows; capacity growth pads
them (``fit._pad_opt_state``). The update matches optax: the schedule is read
at the count before the increment, the bias correction uses the count after
it, update = -lr · m̂ / (sqrt(v̂) + eps).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from dge_tpu_torch.ops.losses import expon_lr_schedule

B1, B2 = 0.9, 0.999


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """OptimizationParams defaults with DGE's scaler hooks
    (arguments/__init__.py:71-89)."""

    max_steps: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.000016
    position_lr_delay_mult: float = 0.01
    feature_lr: float = 0.0125
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    eps: float = 1e-15

    @classmethod
    def scaled(
        cls,
        max_steps: int,
        lr_scaler: float = 1.0,
        lr_final_scaler: float = 1.0,
        color_lr_scaler: float = 1.0,
        opacity_lr_scaler: float = 1.0,
        scaling_lr_scaler: float = 1.0,
        rotation_lr_scaler: float = 1.0,
        **kw,
    ) -> "OptimConfig":
        """DGE's scaler constructor (arguments/__init__.py:72-80)."""
        return cls(
            max_steps=max_steps,
            position_lr_init=0.00016 * lr_scaler,
            position_lr_final=0.000016 * lr_final_scaler,
            feature_lr=0.0125 * color_lr_scaler,
            opacity_lr=0.05 * opacity_lr_scaler,
            scaling_lr=0.005 * scaling_lr_scaler,
            rotation_lr=0.001 * rotation_lr_scaler,
            **kw,
        )


def learning_rates(cfg: OptimConfig, spatial_lr_scale: float = 1.0
                   ) -> Dict[str, Callable[[int], float]]:
    """Per-group learning rate as a function of the group's step count."""
    sls = spatial_lr_scale
    xyz_sched = expon_lr_schedule(
        cfg.position_lr_init * sls,
        cfg.position_lr_final * sls,
        cfg.max_steps,
        lr_delay_steps=0,
        lr_delay_mult=cfg.position_lr_delay_mult,
    )

    def const(lr):
        return lambda count: lr

    return {
        "xyz": xyz_sched,
        "features_dc": const(cfg.feature_lr),
        "features_rest": const(cfg.feature_lr / 20.0),
        "opacity": const(cfg.opacity_lr),
        "scaling": const(cfg.scaling_lr),
        "rotation": const(cfg.rotation_lr),
    }


def init_state(params: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    return {k: {"mu": torch.zeros_like(v), "nu": torch.zeros_like(v),
                "count": 0} for k, v in params.items()}


def adam_update(grads, state, params, lrs, eps: float):
    """One Adam step of every group → (new params, new state); nothing is
    changed in place."""
    new_params, new_state = {}, {}
    for k in params:
        g, st = grads[k], state[k]
        count = st["count"] + 1
        mu = B1 * st["mu"] + (1.0 - B1) * g
        nu = B2 * st["nu"] + (1.0 - B2) * (g * g)
        mu_hat = mu / float(np.float32(1.0) - np.float32(B1) ** count)
        nu_hat = nu / float(np.float32(1.0) - np.float32(B2) ** count)
        lr = lrs[k](st["count"])  # the schedule reads the count before it
        new_params[k] = params[k] - lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
        new_state[k] = {"mu": mu, "nu": nu, "count": count}
    return new_params, new_state


class Optimizer(NamedTuple):
    init: Callable  # params -> state
    update: Callable  # (grads, state, params) -> (params, state)


def make_optimizer(cfg: OptimConfig, spatial_lr_scale: float = 1.0) -> Optimizer:
    lrs = learning_rates(cfg, spatial_lr_scale)
    return Optimizer(
        init=init_state,
        update=lambda grads, state, params: adam_update(
            grads, state, params, lrs, cfg.eps))


# Fields whose grads are zeroed outside the editable region. The reference
# hooks every field EXCEPT rotation (apply_grad_mask, gaussian_model.py:841-851).
MASKED_FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling")


def apply_grad_mask(grads: Dict[str, torch.Tensor], grad_mask: torch.Tensor,
                    alive: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero grads of non-editable / dead Gaussians (functional version of the
    backward hooks at gaussian_model.py:834-856)."""
    m = (grad_mask > 0) & alive
    out = {}
    for k, g in grads.items():
        rows = m if k in MASKED_FIELDS else alive
        out[k] = g * rows.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
    return out


def zero_adam_rows(state, rows: torch.Tensor, fields: Optional[tuple] = None):
    """Zero Adam mu/nu for the given rows (bool [capacity]): the padded-buffer
    equivalent of the reference's optimizer-state surgery
    (gaussian_model.py:553-566, 609-641). ``fields=None`` touches every
    group."""
    keep = ~rows
    out = {}
    for k, st in state.items():
        if fields is None or k in fields:
            m = keep.reshape((-1,) + (1,) * (st["mu"].dim() - 1)).to(
                st["mu"].dtype)
            st = {"mu": st["mu"] * m, "nu": st["nu"] * m, "count": st["count"]}
        out[k] = st
    return out


def state_from_optax(inner_states: dict, device="cuda") -> Dict[str, dict]:
    """Carry an optax ``multi_transform`` state across: ``inner_states`` maps
    each group name to ``{"mu", "nu", "count"}`` taken from the JAX state as
    numpy (the ``ScaleByAdamState`` leaves of that group)."""
    from dge_tpu_torch import resolve_device

    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return {k: {"mu": f32(st["mu"]), "nu": f32(st["nu"]),
                "count": int(st["count"])} for k, st in inner_states.items()}
