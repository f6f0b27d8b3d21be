"""View-parallel sharded training and rendering.

JAX counterpart: ``dge_tpu/parallel/shard.py`` (``make_sharded_train_step``,
``make_sharded_render``). The camera views split over the ``view`` axis of
a mesh of ranks; the scene, the Adam state and the ``FitState`` are
replicated. Each rank renders its views and takes their gradients, the
gradients (parameters and the screen-space offset) are summed over the
ranks, and every rank applies the same masked Adam update: distributed
bundle adjustment over the camera set. Because every rank applies the same
reduced numbers, and the port's kernels and ordered fold repeat bit for bit,
the replicas stay identical.

Every rank is handed the whole stacked camera batch and targets (as the JAX
step is) and takes views ``[i·k, (i+1)·k)``, ``i`` its view index and ``k``
the views per rank (1 in the JAX step).
"""

from __future__ import annotations

from typing import Optional

import torch

from dge_tpu_torch.ops import losses as L
from dge_tpu_torch.ops import render as R
from dge_tpu_torch.parallel import dist as D
from dge_tpu_torch.parallel.mesh import VIEW_AXIS, index_cameras
from dge_tpu_torch.systems import optim as O
from dge_tpu_torch.systems.fit import FitState, _train_backend


def own_views(mesh: D.Mesh, axis: str, n_views: int) -> range:
    """The views of this rank: a contiguous block of ``n_views`` over the
    ranks of ``axis``."""
    n = mesh.size(axis)
    if n_views % n:
        raise ValueError(f"{n_views} views do not split over {n} ranks")
    k = n_views // n
    i = mesh.index(axis)
    return range(i * k, (i + 1) * k)


def accumulate_view_stats(fit_state: FitState, goffset: torch.Tensor,
                          views_visible: torch.Tensor,
                          radii: torch.Tensor, width: int,
                          height: int) -> FitState:
    """Densification statistics of one multi-view step: ``goffset`` the
    screen-space offset's gradient summed over the views, ``views_visible``
    the number of views that see each Gaussian (``denom`` counts views, as
    the view-sharded JAX step does), ``radii`` the largest radius."""
    g = torch.stack([goffset[:, 0] * (width * 0.5),
                     goffset[:, 1] * (height * 0.5)], dim=-1)
    return fit_state.replace(
        grad_accum=fit_state.grad_accum + torch.linalg.vector_norm(g, dim=-1),
        denom=fit_state.denom + views_visible,
        max_radii2d=torch.maximum(fit_state.max_radii2d, radii),
        step=fit_state.step + 1)


def adam_step(optimizer: O.Optimizer, scene, opt_state, grads: dict):
    """The masked Adam update of ``grads`` → (scene, opt_state)."""
    grads = O.apply_grad_mask(grads, scene.grad_mask, scene.alive)
    params, opt_state = optimizer.update(grads, opt_state, scene.params())
    return scene.with_params(params), opt_state


def view_grads(scene, views, view_loss):
    """Each view's gradients with respect to the scene's parameters and a
    zero screen-space offset, summed over ``views``: ``view_loss(scene,
    offset, v)`` → (loss, visible, radii, spill) of view ``v``. Returns
    (gradients by name, the offset's gradient, the number of views that see
    each Gaussian, its largest radius, the summed loss, the summed
    spill)."""
    names = list(scene.params())
    grads = {k: torch.zeros_like(v) for k, v in scene.params().items()}
    z = torch.zeros(scene.capacity, device=scene.device)
    goff = torch.zeros(scene.capacity, 2, device=scene.device)
    vis = radii = z
    loss_sum = torch.zeros((), device=scene.device)
    spill = torch.zeros((), dtype=torch.int32, device=scene.device)
    for v in views:
        params = {k: p.detach().requires_grad_(True)
                  for k, p in scene.params().items()}
        offset = torch.zeros(scene.capacity, 2, device=scene.device,
                             requires_grad=True)
        loss, visible, r, sp = view_loss(scene.with_params(params), offset, v)
        g = torch.autograd.grad(loss, [params[k] for k in names] + [offset])
        with torch.no_grad():
            for k, gk in zip(names, g[:-1]):
                grads[k] += gk
            goff = goff + g[-1]
            vis = vis + visible.float()
            radii = torch.maximum(radii, torch.where(visible, r.detach(), z))
            loss_sum = loss_sum + loss.detach()
            spill = spill + sp
    return grads, goff, vis, radii, loss_sum, spill


def make_sharded_train_step(
    optimizer: O.Optimizer,
    mesh: D.Mesh,
    *,
    lambda_dssim: float = 0.2,
    lambda_l1: float = 1.0,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    chunk: int = 64,
    backend: Optional[str] = None,
    axis: str = VIEW_AXIS,
    **caps,
):
    """A (scene, opt_state, fit_state, cams, targets, bg) step: ``cams`` a
    stacked CameraArrays of V views, ``targets`` [V, H, W, 3]. One optimizer
    step on the view-summed gradients; the loss is the mean over the views,
    ``denom`` gains the number of views that see each Gaussian (capped at
    V) and ``max_radii2d`` the largest radius. Returns (scene, opt_state,
    fit_state, {"loss", "spill"}), the spill summed over the views.
    ``backend=None`` is ``"cuda_train"`` on a card and ``"torch"`` on the
    CPU (``"torch_tiles"`` is the counterpart of the JAX default
    ``"jnp"``); ``caps`` go to ``render`` (``max_tiles_per_gaussian``,
    ``max_pairs``, ``big_capacity``, ``small_slots``, ``tight_cull``)."""
    group = mesh.group(axis)

    def step(scene, opt_state, fit_state: FitState, cams, targets, bg):
        use = _train_backend(backend, scene.device)
        n_views = int(targets.shape[0])
        mine = own_views(mesh, axis, n_views)

        def view_loss(s, offset, v):
            out = R.render(s, index_cameras(cams, v), bg, tile_px=tile_px,
                           max_per_tile=max_per_tile, chunk=chunk,
                           mean2d_offset=offset, backend=use, **caps)
            loss = lambda_l1 * L.l1_loss(out.color, targets[v])
            if lambda_dssim:
                loss = loss + lambda_dssim * (1.0 - L.ssim(out.color,
                                                           targets[v]))
            return loss, out.visible, out.radii, out.spill

        grads, goff, vis, radii, loss_sum, spill = view_grads(scene, mine,
                                                              view_loss)
        with torch.no_grad():
            # the reductions of the JAX step: psum of the gradients and the
            # visibility, pmean of the loss, pmax of the radii
            grads = {k: D.all_reduce_sum(g, group) for k, g in grads.items()}
            goff = D.all_reduce_sum(goff, group)
            vis = torch.clamp(D.all_reduce_sum(vis, group), max=float(n_views))
            radii = D.all_reduce_max(radii, group)
            loss = D.all_reduce_mean(loss_sum / len(mine), group)
            spill = D.all_reduce_sum(spill, group)
            scene, opt_state = adam_step(optimizer, scene, opt_state, grads)
            fit_state = accumulate_view_stats(fit_state, goff, vis, radii,
                                              cams.width, cams.height)
        return scene, opt_state, fit_state, {"loss": loss, "spill": spill}

    return step


def make_sharded_render(
    mesh: D.Mesh,
    *,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    chunk: int = 64,
    backend: Optional[str] = None,
    axis: str = VIEW_AXIS,
    **caps,
):
    """(scene, cams, bg) -> (colors [V, H, W, 3], depths [V, H, W], spill):
    each rank renders its views; the images are gathered in view order on
    every rank. The JAX function drops the binning spill
    (``shard.py:133-138``); this one returns it summed over the views.
    ``backend=None`` is ``render``'s default for the scene's device."""
    group = mesh.group(axis)

    @torch.no_grad()
    def fn(scene, cams, bg):
        n_views = int(cams.w2c.shape[0])
        outs = [R.render(scene, index_cameras(cams, v), bg, tile_px=tile_px,
                         max_per_tile=max_per_tile, chunk=chunk,
                         backend=backend, **caps)
                for v in own_views(mesh, axis, n_views)]
        colors = D.all_gather_cat(torch.stack([o.color for o in outs]), group)
        depths = D.all_gather_cat(torch.stack([o.depth for o in outs]), group)
        spill = D.all_reduce_sum(
            torch.stack([o.spill for o in outs]).sum().to(torch.int32), group)
        return colors, depths, spill

    return fn
