"""Gaussian-block sharding: the capacity split into blocks over ranks.

JAX counterpart: ``dge_tpu/parallel/gauss_shard.py``. Per-Gaussian
preprocessing (cull, project, covariance, SH) is parallel over the Gaussian
axis: each rank preprocesses ``capacity / n`` rows, and the compact
screen-space fields are gathered for the binning, which needs every visible
Gaussian's tile rect. Two schemes:

- ``sharded_preprocess``: preprocess sharded, binning and compositing on
  the gathered set (compose with parallel/tile_shard.py for pixel
  parallelism);
- depth-slab compositing (``make_depth_slab_render`` /
  ``make_depth_slab_train_step``): each rank composites only the Gaussians
  of ITS depth slab (an equal-count partition of the visible depths), and
  the per-slab (color, depth, T) images merge with the associative
  front-to-back "over" operator ``c = c_near + T_near c_far``, ``T = T_near
  T_far``. In the train step the parameters, the Adam state and the
  ``FitState`` stay sharded too.

In JAX the caller hands over whole arrays and ``shard_map`` splits them;
here each rank holds its block: ``shard_scene`` / ``shard_rows`` cut it
from a whole scene or state and ``gather_scene`` / ``gather_rows`` join the
blocks again. The capacity must divide by the axis size (grow it with
``densify.grow_capacity``).

Backends: the renders default to the list kernel (``"cuda_tiles"``) on a
card, the train step to ``"cuda_train"`` (its forward returns each slab's
final T over a zero background and its backward takes that T's gradient);
on the CPU ``"torch_tiles"`` and ``"torch"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dge_tpu_torch.ops import losses as L
from dge_tpu_torch.ops import projection
from dge_tpu_torch.ops import render as R
from dge_tpu_torch.parallel import dist as D
from dge_tpu_torch.parallel.shard import adam_step
from dge_tpu_torch.parallel.tile_shard import (GAUSS_AXIS, gather_prep,
                                               preprocess_scene,
                                               render_backend)
from dge_tpu_torch.scene.gaussians import GaussianScene
from dge_tpu_torch.systems import optim as O
from dge_tpu_torch.systems.fit import FitState, _train_backend

_ROW_FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
               "rotation", "alive", "grad_mask", "generation")


def make_gauss_mesh(n: Optional[int] = None) -> D.Mesh:
    return D.Mesh((n or D.world_size(),), (GAUSS_AXIS,))


def _block(capacity: int, mesh: D.Mesh, axis: str) -> slice:
    n = mesh.size(axis)
    if capacity % n:
        raise ValueError(f"capacity {capacity} does not split over {n} "
                         "ranks: grow it (densify.grow_capacity) to a "
                         "multiple")
    b = capacity // n
    i = mesh.index(axis)
    return slice(i * b, (i + 1) * b)


def shard_scene(scene: GaussianScene, mesh: D.Mesh,
                axis: str = GAUSS_AXIS) -> GaussianScene:
    """This rank's block of the scene's rows."""
    sl = _block(scene.capacity, mesh, axis)
    return scene.replace(**{k: getattr(scene, k)[sl] for k in _ROW_FIELDS})


def gather_scene(block: GaussianScene, mesh: D.Mesh,
                 axis: str = GAUSS_AXIS) -> GaussianScene:
    """The whole scene from every rank's block (on every rank)."""
    group = mesh.group(axis)
    return block.replace(**{k: D.all_gather_cat(getattr(block, k), group)
                            for k in _ROW_FIELDS})


def shard_rows(state, capacity: int, mesh: D.Mesh, axis: str = GAUSS_AXIS):
    """This rank's block of an Adam state (``{name: {"mu", "nu",
    "count"}}``) or a ``FitState``."""
    sl = _block(capacity, mesh, axis)
    if isinstance(state, FitState):
        return state.replace(grad_accum=state.grad_accum[sl],
                             denom=state.denom[sl],
                             max_radii2d=state.max_radii2d[sl])
    return {k: {"mu": st["mu"][sl], "nu": st["nu"][sl],
                "count": st["count"]} for k, st in state.items()}


def gather_rows(state, mesh: D.Mesh, axis: str = GAUSS_AXIS):
    """The whole Adam state or ``FitState`` from every rank's block."""
    group = mesh.group(axis)
    if isinstance(state, FitState):
        return state.replace(**{
            f.name: D.all_gather_cat(getattr(state, f.name), group)
            for f in dataclasses.fields(state) if f.name != "step"})
    return {k: {"mu": D.all_gather_cat(st["mu"], group),
                "nu": D.all_gather_cat(st["nu"], group),
                "count": st["count"]} for k, st in state.items()}


def sharded_preprocess(mesh: D.Mesh, scene_block: GaussianScene, cam, *,
                       scale_modifier: float = 1.0,
                       axis: str = GAUSS_AXIS) -> projection.Preprocessed:
    """``projection.preprocess`` of this rank's block, the fields gathered
    over ``axis``: every rank holds the whole capacity's."""
    return gather_prep(preprocess_scene(scene_block, cam,
                                        scale_modifier=scale_modifier),
                       mesh.group(axis))


def _slab_bounds(depth, visible, n_dev: int, k: int, sample_cap: int = 4096):
    """Equal-count depth slab ``[lo, hi)`` of rank ``k`` from a strided
    sample of the visible depths (the same on every rank)."""
    if n_dev == 1:
        return -float("inf"), float("inf")
    d = torch.where(visible, depth.detach(),
                    torch.full_like(depth, float("inf")))
    n = d.shape[0]
    samp = torch.sort(d[::max(1, n // sample_cap)]).values
    v = int(torch.isfinite(samp).sum())
    ranks = [min(max(v * j // n_dev, 0), samp.shape[0] - 1)
             for j in range(1, n_dev)]
    edges = samp[ranks]  # [n_dev - 1] ascending
    lo = -float("inf") if k == 0 else edges[k - 1]
    hi = float("inf") if k == n_dev - 1 else edges[k]
    return lo, hi


def _merge_slabs(parts_color, parts_depth, parts_t, n_dev: int):
    """Fold per-slab images front to back with the over operator (slab 0
    nearest)."""
    c, d, t = parts_color[0], parts_depth[0], parts_t[0]
    for j in range(1, n_dev):
        c = c + t[..., None] * parts_color[j]
        d = d + t * parts_depth[j]
        t = t * parts_t[j]
    return c, d, t


def _slab_composite(prep, vis_slab, cam, *, height, width, tile_px,
                    max_per_tile, chunk, backend, **caps):
    """Bin and composite ONE depth slab over a zero background → (color,
    depth, final_T, spill)."""
    color, depth, final_t, spill, _ = R.rasterize(
        prep._replace(visible=vis_slab), prep.mean2d, height, width,
        torch.zeros(3, device=prep.mean2d.device), backend=backend,
        tile_px=tile_px, max_per_tile=max_per_tile, chunk=chunk, **caps)
    return color, depth, final_t, spill


def slab_visible(prep, n_dev: int, k: int):
    """The visible Gaussians of depth slab ``k`` of ``n_dev``."""
    lo, hi = _slab_bounds(prep.depth, prep.visible, n_dev, k)
    return prep.visible & (prep.depth >= lo) & (prep.depth < hi)


def make_depth_slab_render(
    mesh: D.Mesh,
    height: int,
    width: int,
    *,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    chunk: int = 64,
    axis: str = GAUSS_AXIS,
    backend: Optional[str] = None,
    **caps,
):
    """``fn(scene_block, cam, bg)`` → (color, depth, alpha, spill): this
    rank's block preprocessed and gathered, its depth slab composited, the
    slabs gathered and merged with the over operator. Equal to the whole
    render up to the order of depth ties (a slab's quantisation is finer
    than the whole image's) and the early stop: a slab starts at T = 1, so
    a pixel saturated in a nearer slab still takes the farther slabs'
    pairs, weighted by its small T (ROADMAP.md §3)."""
    n_dev = mesh.size(axis)
    group = mesh.group(axis)

    @torch.no_grad()
    def fn(scene_block, cam, bg):
        prep = sharded_preprocess(mesh, scene_block, cam, axis=axis)
        c, d, t, spill = _slab_composite(
            prep, slab_visible(prep, n_dev, mesh.index(axis)), cam,
            height=height, width=width, tile_px=tile_px,
            max_per_tile=max_per_tile, chunk=chunk,
            backend=render_backend(scene_block.device, backend), **caps)
        c, d, t = _merge_slabs(D.all_gather_stack(c, group),
                               D.all_gather_stack(d, group),
                               D.all_gather_stack(t, group), n_dev)
        c = c + t[..., None] * bg[None, None, :]
        return c, d, 1.0 - t, D.all_reduce_sum(spill, group)

    return fn


def make_depth_slab_train_step(
    optimizer: O.Optimizer,
    mesh: D.Mesh,
    height: int,
    width: int,
    *,
    lambda_dssim: float = 0.0,
    lambda_l1: float = 1.0,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    chunk: int = 64,
    axis: str = GAUSS_AXIS,
    backend: Optional[str] = None,
    **caps,
):
    """Model-parallel step ``(scene_block, opt_block, fit_block, cam,
    target, bg)`` → the three blocks updated and ``{"loss", "spill"}``.
    Each rank composites its depth slab; the merged image drives a loss
    that every rank computes alike; gradients flow back through the two
    gathers (whose backward sums the cotangents over the ranks). Each
    rank's loss is divided by the rank count before the gradient, so that
    sum is exact (``gauss_shard.py:268-276``). The Adam update is
    elementwise, so updating each block alone equals the whole update.
    Each slab starts at T = 1, so where pixels saturate its early stop, and
    with it the gradients, are not the unsharded step's (the JAX step's
    are not either; ROADMAP.md §3)."""
    n_dev = mesh.size(axis)
    group = mesh.group(axis)

    def step(scene_block, opt_block, fit_block: FitState, cam, target, bg):
        use = _train_backend(backend, scene_block.device)
        names = list(scene_block.params())
        params = {k: p.detach().requires_grad_(True)
                  for k, p in scene_block.params().items()}
        offset = torch.zeros(scene_block.capacity, 2,
                             device=scene_block.device, requires_grad=True)
        local = preprocess_scene(scene_block.with_params(params), cam)
        local = local._replace(mean2d=local.mean2d + offset)
        prep = gather_prep(local, group)
        c, _, t, spill = _slab_composite(
            prep, slab_visible(prep, n_dev, mesh.index(axis)), cam,
            height=height, width=width, tile_px=tile_px,
            max_per_tile=max_per_tile, chunk=chunk, backend=use, **caps)
        parts_c = D.all_gather_stack(c, group)
        parts_t = D.all_gather_stack(t, group)
        c, _, t = _merge_slabs(parts_c, torch.zeros_like(parts_t), parts_t,
                               n_dev)
        c = c + t[..., None] * bg[None, None, :]
        loss = lambda_l1 * L.l1_loss(c, target)
        if lambda_dssim:
            loss = loss + lambda_dssim * (1.0 - L.ssim(c, target))
        # every rank holds the same loss: 1/n of each makes the summed
        # cotangents of the gathers exact
        loss = loss / n_dev
        g = torch.autograd.grad(loss, [params[k] for k in names] + [offset])
        with torch.no_grad():
            scene_block, opt_block = adam_step(
                optimizer, scene_block, opt_block, dict(zip(names, g[:-1])))
            gn = torch.stack([g[-1][:, 0] * (width * 0.5),
                              g[-1][:, 1] * (height * 0.5)], dim=-1)
            vis = local.visible
            fit_block = fit_block.replace(
                grad_accum=fit_block.grad_accum
                + torch.linalg.vector_norm(gn, dim=-1),
                denom=fit_block.denom + vis.float(),
                max_radii2d=torch.maximum(fit_block.max_radii2d, torch.where(
                    vis, local.radius.detach(),
                    torch.zeros_like(local.radius))),
                step=fit_block.step + 1)
            aux = {"loss": D.all_reduce_sum(loss.detach(), group),
                   "spill": D.all_reduce_sum(spill, group)}
        return scene_block, opt_block, fit_block, aux

    return step
