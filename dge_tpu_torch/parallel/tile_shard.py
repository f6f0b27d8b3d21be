"""Tile-axis sharding: the tile-row bands of ONE image over ranks.

JAX counterpart: ``dge_tpu/parallel/tile_shard.py``. View sharding
(parallel/shard.py) cannot help a single render; this module splits the
image into horizontal bands of whole tile rows, one band per rank:

- preprocess runs replicated over the whole camera (or, in
  ``make_gauss_tile_render``, over this rank's Gaussian block, the fields
  then gathered over the ``gauss`` axis);
- each rank bins only the Gaussians that overlap its band and composites
  the band; the bands are gathered in order into the whole image.

The band trick: ``mean2d`` shifted by ``-y_off`` and binned and composited
against a ``band_px``-high viewport (``render.rasterize``), so off-band
Gaussians cull out as the reference's tile culling does
(cuda_rasterizer/forward.cu:229-255). The band's depth keys are the whole
image's (its tile count, the Gaussians on its screen), and on the
pair-stream backends its stream is shifted to the whole image's block
offsets (``pairs_above``: the stream lengths of the bands above, one
all-gather), so each tile composites as in the whole image, early stop
included.

Backends: the renders default to ``"cuda_tiles"`` on a card (per-tile lists
through the list kernel K2 and its layout kernel, the list compositor the
JAX functions run) and ``"torch_tiles"`` on the CPU; the train step to
``"cuda_train"`` (pair binning of the band, K1 forward, K3 / suffix / K4
backward and the ordered fold) and ``"torch"``. ``"torch_tiles"`` is the
counterpart of the JAX ``composite.composite`` everywhere.
"""

from __future__ import annotations

from typing import Optional

import torch

from dge_tpu_torch.ops import binning
from dge_tpu_torch.ops import losses as L
from dge_tpu_torch.ops import projection
from dge_tpu_torch.ops import render as R
from dge_tpu_torch.parallel import dist as D
from dge_tpu_torch.parallel.mesh import VIEW_AXIS, index_cameras
from dge_tpu_torch.parallel.shard import (accumulate_view_stats, adam_step,
                                          own_views, view_grads)
from dge_tpu_torch.systems import optim as O
from dge_tpu_torch.systems.fit import FitState, _train_backend

TILE_AXIS = "tile"
GAUSS_AXIS = "gauss"


def make_tile_mesh(n: Optional[int] = None) -> D.Mesh:
    return D.Mesh((n or D.world_size(),), (TILE_AXIS,))


def make_gauss_tile_mesh(n_gauss: int, n_tile: int) -> D.Mesh:
    """2-axis mesh: Gaussian blocks x tile bands."""
    return D.Mesh((n_gauss, n_tile), (GAUSS_AXIS, TILE_AXIS))


def make_view_tile_mesh(n_view: int, n_tile: int) -> D.Mesh:
    """2-axis mesh: camera views x tile bands."""
    return D.Mesh((n_view, n_tile), (VIEW_AXIS, TILE_AXIS))


def render_backend(device, backend: Optional[str] = None) -> str:
    """A band or slab render's backend: the list kernel on a card, the
    plain list compositor on the CPU."""
    if backend:
        return backend
    on_card = torch.device(device).type == "cuda"
    return "cuda_tiles" if on_card else "torch_tiles"


def _band_px(height: int, n: int, tile_px: int) -> int:
    if height % (n * tile_px):
        raise ValueError(f"height {height} must divide into {n} bands of "
                         f"whole {tile_px}px tile rows")
    return height // n


def preprocess_scene(scene, cam, **kw) -> projection.Preprocessed:
    return projection.preprocess(
        scene.xyz, scene.get_scaling, scene.get_rotation, scene.get_opacity,
        scene.get_features, scene.alive, cam, scene.active_sh_degree,
        scene.max_sh_degree, **kw)


def band_rasterize(prep, mean2d, height: int, width: int, band_px: int,
                   y_off: int, bg, *, tile_px: int = 32, **kw):
    """Rows ``[y_off, y_off + band_px)`` of the ``height`` x ``width`` image
    of ``prep`` → (color, depth, final_T, spill, spill_parts). ``kw`` go to
    ``render.rasterize``, whose ``stream_base`` (``pairs_above``) puts the
    band's pairs at the whole image's block offsets."""
    tiles_x, tiles_y = -(-width // tile_px), -(-height // tile_px)
    seen = binning.tile_rects(mean2d.detach(), prep.radius.detach(),
                              prep.visible, tile_px, tiles_x, tiles_y)[4]
    shift = torch.tensor([0.0, float(y_off)], device=mean2d.device)
    return R.rasterize(prep, mean2d - shift, band_px, width, bg,
                       tile_px=tile_px, depth_keys=(tiles_x * tiles_y, seen),
                       **kw)


def pairs_above(mesh: D.Mesh, axis: str = TILE_AXIS):
    """``rasterize``'s ``stream_base`` for this rank's band along ``axis``:
    band ``i``'s first pair follows, in the whole image's stream, the
    streams of bands ``0 .. i-1`` (one all-gather of every band's stream
    length; every rank of the axis calls it at once)."""
    group, i = mesh.group(axis), mesh.index(axis)

    def base(length):
        return D.all_gather_cat(length.reshape(1), group)[:i].sum()

    return base


def _band_render(scene, cam, bg, band_px: int, y_off: int, *, tile_px,
                 max_per_tile, chunk, backend, stream_base=None, **caps):
    """Render rows ``[y_off, y_off + band_px)`` of ``cam``'s image →
    (color, depth, final_T, spill)."""
    prep = preprocess_scene(scene, cam)
    color, depth, final_t, spill, _ = band_rasterize(
        prep, prep.mean2d, cam.height, cam.width, band_px, y_off, bg,
        backend=backend, tile_px=tile_px, max_per_tile=max_per_tile,
        chunk=chunk, stream_base=stream_base, **caps)
    return color, depth, final_t, spill


def make_tile_sharded_render(
    mesh: D.Mesh,
    height: int,
    width: int,
    *,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    chunk: int = 64,
    axis: str = TILE_AXIS,
    backend: Optional[str] = None,
    **caps,
):
    """(scene, cam, bg) -> (color [H, W, 3], depth, alpha, spill): the
    tile-row bands of one image rendered on the ranks of ``axis`` and
    gathered in order on each; the spill summed over the bands."""
    n = mesh.size(axis)
    band_px = _band_px(height, n, tile_px)
    group = mesh.group(axis)

    @torch.no_grad()
    def fn(scene, cam, bg):
        color, depth, final_t, spill = _band_render(
            scene, cam, bg, band_px, mesh.index(axis) * band_px,
            tile_px=tile_px, max_per_tile=max_per_tile, chunk=chunk,
            backend=render_backend(scene.device, backend),
            stream_base=pairs_above(mesh, axis), **caps)
        return (D.all_gather_cat(color, group), D.all_gather_cat(depth, group),
                1.0 - D.all_gather_cat(final_t, group),
                D.all_reduce_sum(spill, group))

    return fn


def gather_prep(prep: projection.Preprocessed,
                group) -> projection.Preprocessed:
    """The per-Gaussian fields of every rank's block, concatenated in block
    order (a tiled ``all_gather`` of each field; differentiable)."""
    return projection.Preprocessed(*(D.all_gather_cat(x, group)
                                     for x in prep))


def make_gauss_tile_render(
    mesh: D.Mesh,
    height: int,
    width: int,
    *,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    chunk: int = 64,
    gauss_axis: str = GAUSS_AXIS,
    tile_axis: str = TILE_AXIS,
    backend: Optional[str] = None,
    **caps,
):
    """2-axis (gauss x tile) render of one image: ``fn(scene_block, cam,
    bg)`` with ``scene_block`` this rank's block of the capacity along
    ``gauss`` (``gauss_shard.shard_scene``); each rank preprocesses its
    block, the fields are gathered over ``gauss``, and the rank composites
    its band along ``tile`` → (color [H, W, 3], depth, alpha, spill)."""
    n_tile = mesh.size(tile_axis)
    n_gauss = mesh.size(gauss_axis)
    band_px = _band_px(height, n_tile, tile_px)
    g_group, t_group = mesh.group(gauss_axis), mesh.group(tile_axis)

    @torch.no_grad()
    def fn(scene_block, cam, bg):
        prep = gather_prep(preprocess_scene(scene_block, cam), g_group)
        color, depth, final_t, spill, _ = band_rasterize(
            prep, prep.mean2d, height, width, band_px,
            mesh.index(tile_axis) * band_px, bg,
            backend=render_backend(scene_block.device, backend),
            tile_px=tile_px, max_per_tile=max_per_tile, chunk=chunk,
            stream_base=pairs_above(mesh, tile_axis), **caps)
        # every gauss rank of a band bins the same gathered set: count once
        spill = D.all_reduce_sum(
            spill, mesh.group((gauss_axis, tile_axis))) // n_gauss
        return (D.all_gather_cat(color, t_group),
                D.all_gather_cat(depth, t_group),
                1.0 - D.all_gather_cat(final_t, t_group), spill)

    return fn


def make_view_tile_train_step(
    optimizer: O.Optimizer,
    mesh: D.Mesh,
    height: int,
    width: int,
    *,
    lambda_dssim: float = 0.2,
    lambda_l1: float = 1.0,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    chunk: int = 64,
    backend: Optional[str] = None,
    **caps,
):
    """2-axis step: views over ``view``, each view's image over ``tile``
    bands. A rank's loss is its band's L1 (and, with ``lambda_dssim``, its
    rows of the whole image's SSIM map, over the band extended by halo
    rows of its neighbours) divided by the band count; losses sum over
    bands and average over views, gradients sum over the mesh.

    ``denom`` gains the number of views that see a Gaussian: the MAX over
    bands, the SUM over views. The JAX step takes the MAX over both axes
    (``tile_shard.py:349-351``), so it counts a Gaussian once however many
    views see it, unlike its view-sharded step; the port's two steps agree
    (ROADMAP.md §3). Each band composites as the whole image does
    (``band_rasterize``), so the step is the view-sharded step's."""
    n_tile = mesh.size(TILE_AXIS)
    band_px = _band_px(height, n_tile, tile_px)
    t_group, v_group = mesh.group(TILE_AXIS), mesh.group(VIEW_AXIS)
    w_group = mesh.group((VIEW_AXIS, TILE_AXIS))
    pad = 11 // 2
    if lambda_dssim and band_px < pad:
        raise ValueError(f"band height {band_px} < SSIM window radius {pad}")
    above = pairs_above(mesh)

    def step(scene, opt_state, fit_state: FitState, cams, targets, bg):
        use = _train_backend(backend, scene.device)
        y0 = mesh.index(TILE_AXIS) * band_px
        mine = own_views(mesh, VIEW_AXIS, int(targets.shape[0]))

        def band_loss(s, offset, v):
            prep = preprocess_scene(s, index_cameras(cams, v))
            color, _, _, sp, _ = band_rasterize(
                prep, prep.mean2d + offset, height, width, band_px, y0, bg,
                backend=use, tile_px=tile_px, max_per_tile=max_per_tile,
                chunk=chunk, stream_base=above, **caps)
            target = targets[v]
            loss = lambda_l1 * L.l1_loss(color, target[y0:y0 + band_px])
            if lambda_dssim:
                # the whole image's SSIM from per-band pieces: the map of
                # the halo-extended band, this band's rows kept; the mean
                # of equal bands' means is the whole image's mean
                color_h = D.halo_rows(color, t_group, pad)
                tgt = torch.nn.functional.pad(target, (0, 0, 0, 0, pad, pad))
                smap = L.ssim_map(color_h, tgt[y0:y0 + band_px + 2 * pad])
                loss = loss + lambda_dssim * (
                    1.0 - torch.mean(smap[pad:pad + band_px]))
            return loss / n_tile, prep.visible, prep.radius, sp

        grads, goff, vis, radii, loss_sum, spill = view_grads(scene, mine,
                                                              band_loss)
        with torch.no_grad():
            loss = D.all_reduce_mean(D.all_reduce_sum(loss_sum / len(mine),
                                                      t_group), v_group)
            grads = {k: D.all_reduce_sum(g, w_group) for k, g in grads.items()}
            goff = D.all_reduce_sum(goff, w_group)
            vis = D.all_reduce_sum(D.all_reduce_max(vis, t_group), v_group)
            radii = D.all_reduce_max(radii, w_group)
            spill = D.all_reduce_sum(spill, w_group)
            scene, opt_state = adam_step(optimizer, scene, opt_state, grads)
            fit_state = accumulate_view_stats(fit_state, goff, vis, radii,
                                              width, height)
        return scene, opt_state, fit_state, {"loss": loss, "spill": spill}

    return step
