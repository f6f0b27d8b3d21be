"""Densification and pruning in fixed-capacity padded buffers.

JAX counterpart: ``dge_tpu/systems/densify.py``. Reference analog:
GaussianModel.densify_and_prune / densify_and_clone / densify_and_split /
prune_points (gaussian_model.py:568-809), including the DGE quantile cap
(``max_densify_percent``, :773-777) and the mask-aware rules (grads zeroed
outside the editable mask :772, prune restricted to the mask :794).

As in the JAX version the capacity is fixed: new Gaussians are written into
free (dead) slots allocated by prefix-sum rank, so rows can be compared one
by one with the JAX package; when free slots run out the overflow is dropped
and counted (``dropped``), and the host grows the capacity
(``grow_capacity``, see fit.py). Nothing here syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dge_tpu_torch.ops.projection import quat_to_rotmat
from dge_tpu_torch.scene.gaussians import GaussianScene, inverse_sigmoid


class DensifyInfo(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    dropped: torch.Tensor  # clones/children that found no free slot
    changed_rows: torch.Tensor  # bool [cap]: rows whose Adam state must reset


def _masked_quantile(values: torch.Tensor, alive: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """torch.quantile(values_of_alive, q) with linear interpolation
    (densify_and_prune, gaussian_model.py:775), at a fixed shape."""
    n = alive.sum()
    inf = torch.full_like(values, float("inf"))
    sorted_v = torch.sort(torch.where(alive, values, inf)).values
    pos = torch.clamp(q, 0.0, 1.0) * torch.clamp(n - 1, min=0).float()
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.float()
    last = values.shape[0] - 1
    vlo = sorted_v[torch.clamp(lo, 0, last)]
    vhi = sorted_v[torch.clamp(hi, 0, last)]
    return vlo + (vhi - vlo) * frac


def _scatter(dst: torch.Tensor, src: torch.Tensor, dest: torch.Tensor):
    """``dst`` with ``src[i]`` written at row ``dest[i]``; rows sent to the
    sentinel ``dest == cap`` are dropped (they land in one spare row)."""
    if src.dim() == 0:
        src = src.expand(dest.shape[0])
    ext = torch.cat([dst, dst[:1]], dim=0)
    ext[dest] = src.to(dst.dtype)
    return ext[:-1]


def densify_and_prune(
    scene: GaussianScene,
    grad_accum: torch.Tensor,  # [cap] accumulated screen-space grad norms
    denom: torch.Tensor,  # [cap] accumulation counts
    max_radii2d: torch.Tensor,  # [cap] max screen radius seen
    generator: Optional[torch.Generator] = None,
    *,
    max_grad: float,
    max_densify_percent: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float,
    generation_num: int = 0,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[GaussianScene, DensifyInfo]:
    """``generator`` draws the two [cap, 3] standard-normal arrays that place
    the split children; ``noise`` hands both over ready-made instead (the
    parity tests pass the JAX draws)."""
    cap = scene.capacity
    dev = scene.device
    alive = scene.alive
    editable = scene.grad_mask > 0
    zero = torch.zeros_like(grad_accum)

    grads = torch.where(denom > 0, grad_accum / torch.clamp(denom, min=1), zero)
    grads = torch.where(torch.isnan(grads), zero, grads)
    grads = torch.where(alive & editable, grads, zero)

    if max_densify_percent < 1.0:
        n_alive = alive.sum()
        nnz = (grads > 0).sum().float()
        valid_percent = nnz * max_densify_percent / torch.clamp(
            n_alive.float(), min=1.0)
        thr = _masked_quantile(grads, alive, 1.0 - valid_percent)
        grads = torch.where(grads < thr, zero, grads)

    max_scale = scene.get_scaling.max(dim=-1).values
    dense_cut = percent_dense * extent
    hot = grads >= max_grad
    clone_mask = hot & (max_scale <= dense_cut) & alive
    split_mask = hot & (max_scale > dense_cut) & alive

    # dead slots first, each class in index order
    free_list = torch.argsort(alive.to(torch.int8), stable=True)
    n_free = cap - alive.sum()
    sentinel = torch.full((cap,), cap, dtype=torch.long, device=dev)

    params = scene.params()

    # ---- clone (densify_and_clone, gaussian_model.py:730-766) ----
    clone_rank = torch.cumsum(clone_mask.long(), 0) - 1
    clone_ok = clone_mask & (clone_rank < n_free)
    clone_dest = torch.where(
        clone_ok, free_list[torch.clamp(clone_rank, 0, cap - 1)], sentinel)

    new_params = {k: _scatter(v, v, clone_dest) for k, v in params.items()}
    true = torch.tensor(True, device=dev)
    gen_tag = torch.tensor(generation_num, dtype=scene.generation.dtype,
                           device=dev)
    new_alive = _scatter(alive, true, clone_dest)
    new_grad_mask = _scatter(scene.grad_mask, scene.grad_mask, clone_dest)
    new_generation = _scatter(scene.generation, gen_tag, clone_dest)
    n_cloned = clone_ok.sum()

    # ---- split (densify_and_split, gaussian_model.py:673-728): N=2 children
    # sampled from the Gaussian, scales /(0.8*N), source pruned ----
    split_rank = torch.cumsum(split_mask.long(), 0) - 1
    slot0 = n_cloned + 2 * split_rank
    slot1 = slot0 + 1
    both_ok = split_mask & (slot0 < n_free) & (slot1 < n_free)
    dest0 = torch.where(
        both_ok, free_list[torch.clamp(slot0, 0, cap - 1)], sentinel)
    dest1 = torch.where(
        both_ok, free_list[torch.clamp(slot1, 0, cap - 1)], sentinel)

    std = scene.get_scaling  # [cap, 3]
    rot = quat_to_rotmat(scene.get_rotation)  # [cap, 3, 3]
    if noise is None:
        noise = (torch.randn(cap, 3, generator=generator, device=dev),
                 torch.randn(cap, 3, generator=generator, device=dev))
    child_scaling = torch.log(torch.clamp(std / 1.6, min=1e-30))  # 0.8*N, N=2

    for dest, draw in ((dest0, noise[0]), (dest1, noise[1])):
        sample = draw.to(dev) * std
        # rot @ sample as an elementwise row sum: full f32 on every device
        child_xyz = scene.xyz + (rot * sample[:, None, :]).sum(dim=-1)
        new_params["xyz"] = _scatter(new_params["xyz"], child_xyz, dest)
        new_params["scaling"] = _scatter(new_params["scaling"], child_scaling,
                                         dest)
        for k in ("features_dc", "features_rest", "opacity", "rotation"):
            new_params[k] = _scatter(new_params[k], params[k], dest)
        new_alive = _scatter(new_alive, true, dest)
        new_grad_mask = _scatter(new_grad_mask, scene.grad_mask, dest)
        new_generation = _scatter(new_generation, gen_tag, dest)

    # prune split sources (prune_filter, gaussian_model.py:719-726)
    new_alive = new_alive & ~both_ok
    n_split = both_ok.sum()

    # ---- prune (densify_and_prune, gaussian_model.py:787-795) ----
    opacity_act = torch.sigmoid(new_params["opacity"][:, 0])
    prune = opacity_act < min_opacity
    if max_screen_size:
        big_vs = max_radii2d > max_screen_size
        big_ws = torch.exp(new_params["scaling"]).max(dim=-1).values \
            > 0.1 * extent
        prune = prune | big_vs | big_ws
    prune = prune & (new_grad_mask > 0) & new_alive
    n_pruned = prune.sum()
    new_alive = new_alive & ~prune

    dropped = (clone_mask & ~clone_ok).sum() \
        + 2 * (split_mask & ~both_ok).sum()

    changed = torch.zeros(cap, dtype=torch.bool, device=dev)
    for dest in (clone_dest, dest0, dest1):
        changed = _scatter(changed, true, dest)
    changed = changed | both_ok | prune

    new_scene = scene.replace(
        alive=new_alive,
        grad_mask=new_grad_mask,
        generation=new_generation,
        **new_params,
    )
    return new_scene, DensifyInfo(
        n_cloned=n_cloned,
        n_split=n_split,
        n_pruned=n_pruned,
        dropped=dropped,
        changed_rows=changed,
    )


def reset_opacity(scene: GaussianScene) -> Tuple[GaussianScene, torch.Tensor]:
    """Clamp the opacity activation to <= 0.01 (reset_opacity,
    gaussian_model.py:447-452). Returns (scene, rows) where rows marks the
    opacity Adam state to zero."""
    new_act = torch.clamp(scene.get_opacity, max=0.01)
    new_logit = inverse_sigmoid(torch.clamp(new_act, 1e-7, 1 - 1e-7))
    new_op = torch.where(scene.alive[:, None], new_logit, scene.opacity)
    return scene.replace(opacity=new_op), scene.alive


def grow_capacity(scene: GaussianScene, new_capacity: int) -> GaussianScene:
    """Capacity growth: dead rows appended with the safe defaults."""
    cap = scene.capacity
    if new_capacity <= cap:
        return scene
    pad = new_capacity - cap

    def pad_arr(x, fill=0.0):
        p = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                       device=x.device)
        return torch.cat([x, p], dim=0)

    rot = torch.zeros(pad, 4, dtype=scene.rotation.dtype, device=scene.device)
    rot[:, 0] = 1.0
    return scene.replace(
        xyz=pad_arr(scene.xyz),
        features_dc=pad_arr(scene.features_dc),
        features_rest=pad_arr(scene.features_rest),
        opacity=pad_arr(scene.opacity, -10.0),
        scaling=pad_arr(scene.scaling, -20.0),
        rotation=torch.cat([scene.rotation, rot], dim=0),
        alive=pad_arr(scene.alive, False),
        grad_mask=pad_arr(scene.grad_mask, 0.0),
        generation=pad_arr(scene.generation, 0),
    )
