"""High-level render API: preprocess -> binning -> compositing, the
spill-free evaluation renderer, the mask lift and the point-cloud render.

JAX counterpart: ``dge_tpu/ops/render.py`` (``RenderOut``, ``render``,
``grow_caps``, ``SpillFreeRenderer``, ``render_weights``,
``render_point_cloud``); reference analog
gaussian_renderer/__init__.py:45-150. Backends:

- ``"cuda_stream"``: pair binning + the hand-written CUDA forward kernel
  (ops/pairs_composite.py, the counterpart of JAX ``"pallas_stream"``),
  through its wrapper, which takes the plain version for CPU tensors. Not
  differentiable through the kernel: for evaluation;
- ``"cuda_train"``: the same forward kernel with the hand-written backward
  kernels behind one ``torch.autograd.Function`` (ops/pairs_backward.py, the
  counterpart of JAX ``"pallas_train"``). Its forward also stores
  ``boundary_T``, the transmittance entering each (tile, stream block) row,
  and hands it to the backward, whose kernels then run one thread block per
  row and never walk a tile's whole range again;
- ``"torch"``: pair binning + the forward kernel's plain PyTorch version,
  differentiable by plain autograd: the CPU twin and the gradient oracle;
- ``"cuda_tiles"``: per-tile-list binning (``bin_gaussians``) + the list
  kernel K2 (ops/tiles_composite.py, the counterpart of JAX ``"pallas"``:
  the lists laid out as a chunk-aligned stream through the forward's
  hand-written row and combine kernels) at chunk ``max(chunk, 128)``,
  through its wrapper. Forward only; ``spill_parts`` is None;
- ``"torch_tiles"``: the same binning + the plain per-tile-list compositor
  (ops/composite.py, the counterpart of JAX ``"jnp"``) at ``chunk``,
  differentiable by plain autograd, on either device.

``backend=None`` picks ``"cuda_stream"`` for a scene on a CUDA device and
``"torch"`` for a scene on the CPU; ``default_train_backend`` gives the
backend a trainer uses. The list backends cut a tile's list into chunks from
the tile's own slot 0, the stream backends at absolute stream offsets, so
the two families can differ at pixels that saturate across a chunk edge
(ops/composite.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dge_tpu_torch.ops import (binning, composite, pairs_backward,
                               pairs_composite, projection, tiles_composite)

BACKENDS = ("cuda_stream", "cuda_train", "torch", "cuda_tiles", "torch_tiles")
LIST_BACKENDS = ("cuda_tiles", "torch_tiles")


class RenderOut(NamedTuple):
    color: torch.Tensor  # [H, W, 3]
    depth: torch.Tensor  # [H, W]
    alpha: torch.Tensor  # [H, W] 1 - final_T
    radii: torch.Tensor  # [N]
    visible: torch.Tensor  # [N] bool
    spill: torch.Tensor  # scalar int32 binning overflow
    # [4] int32 (slot, cap, tile, stream) overflow attribution
    spill_parts: torch.Tensor = None


def default_backend(device) -> str:
    return "cuda_stream" if torch.device(device).type == "cuda" else "torch"


def default_train_backend(device) -> str:
    """``"cuda_train"`` (kernel forward and backward) on a CUDA device,
    ``"torch"`` (plain autograd) on the CPU."""
    return "cuda_train" if torch.device(device).type == "cuda" else "torch"


def grow_caps(caps: dict, parts) -> dict:
    """One spill-ladder rung: double ONLY the cap classes that overflowed.

    ``caps`` keys: max_per_tile / max_tiles_per_gaussian / small_slots /
    max_pairs / big_capacity. ``parts`` is RenderOut.spill_parts or None —
    None doubles everything. A copy of the JAX ``grow_caps``, including its
    ``big_capacity`` 0 -> 8192 jump (see ROADMAP.md §3). When every
    attributed class is at its ceiling the caps come back unchanged: callers
    treat that as an irreducible residual and stop."""
    if parts is None:
        wants = [True] * 4
    else:
        p = [int(x) for x in parts]
        if len(p) == 3:  # legacy (gauss, tile, stream)
            p = [p[0], p[0], p[1], p[2]]
        wants = [x > 0 for x in p]
    c = dict(caps)
    slot, cap, tile, stream = wants
    if slot:
        c["max_tiles_per_gaussian"] = min(c["max_tiles_per_gaussian"] * 2, 256)
    if cap:
        c["small_slots"] = min(c["small_slots"] * 2, 32)
        # 0 = the binning auto default (n/32 capped) — jump past it
        c["big_capacity"] = (c["big_capacity"] * 2 if c["big_capacity"]
                             else 8192)
    if tile:
        c["max_per_tile"] = c["max_per_tile"] * 2
    if stream:
        c["max_pairs"] = c["max_pairs"] * 2
    return c


def render(
    scene,
    cam,
    bg: Optional[torch.Tensor] = None,
    *,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    max_tiles_per_gaussian: int = 32,
    max_pairs: int = 0,
    big_capacity: int = 0,
    small_slots: int = 4,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
    chunk: int = 64,
    backend: Optional[str] = None,
    tight_cull: bool = False,
) -> RenderOut:
    """Render ``scene`` from ``cam`` (a CameraArrays on the scene's device).

    The compositor runs on stream blocks of ``max(chunk, 128)`` pairs, as
    the JAX pair-stream backends do. ``tight_cull`` drops (Gaussian, tile)
    pairs no pixel of which can pass the alpha >= 1/255 skip: exact for
    colour, depth and gradients. Preprocess runs under autograd whenever a
    scene parameter (or ``mean2d_offset``, ``override_color``) requires a
    gradient; binning always takes detached inputs. ``mean2d_offset`` [N, 2]
    is added to the projected means: pass zeros and take the gradient with
    respect to it to harvest per-Gaussian screen-space gradients for
    densification."""
    backend = backend or default_backend(scene.device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown render backend {backend!r}")
    dev = scene.device
    bg = (torch.zeros(3, device=dev) if bg is None
          else torch.as_tensor(bg, dtype=torch.float32).to(dev))

    prep = projection.preprocess(
        scene.xyz,
        scene.get_scaling,
        scene.get_rotation,
        scene.get_opacity,
        scene.get_features,
        scene.alive,
        cam,
        scene.active_sh_degree,
        scene.max_sh_degree,
        scale_modifier=scale_modifier,
        override_color=override_color,
    )
    mean2d = prep.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    color, depth, final_t, spill, parts = rasterize(
        prep, mean2d, cam.height, cam.width, bg, backend=backend,
        tile_px=tile_px, max_per_tile=max_per_tile,
        max_tiles_per_gaussian=max_tiles_per_gaussian, max_pairs=max_pairs,
        big_capacity=big_capacity, small_slots=small_slots, chunk=chunk,
        tight_cull=tight_cull)
    return RenderOut(
        color=color,
        depth=depth,
        alpha=1.0 - final_t,
        radii=prep.radius.detach(),
        visible=prep.visible,
        spill=spill,
        spill_parts=parts,
    )


def rasterize(prep, mean2d, height: int, width: int, bg, *, backend: str,
              tile_px: int = 32, max_per_tile: int = 2048,
              max_tiles_per_gaussian: int = 32, max_pairs: int = 0,
              big_capacity: int = 0, small_slots: int = 4, chunk: int = 64,
              tight_cull: bool = False, depth_keys=None,
              stream_base=None):
    """Binning and compositing of preprocessed Gaussians (``prep``, with
    screen positions ``mean2d``) against a ``height`` x ``width`` viewport
    whose top left is pixel (0, 0) → (color, depth, final_T, spill,
    spill_parts). ``render`` calls it with the camera's size; a tile band
    shifts ``mean2d`` by its first row and passes its own height
    (parallel/tile_shard.py), and a depth slab passes a narrower
    ``prep.visible`` (parallel/gauss_shard.py).

    A band composites as the whole image does only if each tile sees the
    same pairs in the same order and, on the pair-stream backends, the same
    stream blocks: a pixel's early stop holds to the end of a block
    (ops/pairs_composite.py), so where a tile's range is cut into blocks
    decides which pairs a saturated pixel refuses. ``depth_keys`` (the
    whole image's tile count and on-screen Gaussians,
    ``binning.bin_gaussians_pairs``) makes the depth keys, and so the order
    of ties, the whole image's. ``stream_base`` maps this viewport's stream
    length (a 0-dim tensor, ``PairBins.length``) to the whole image's
    stream position of its first pair; the stream is then shifted by that
    position modulo the block size, so that every tile's range is cut where
    the whole image's is. The list backends cut each tile's list from its
    own first entry and need no shift."""
    if backend in LIST_BACKENDS:
        color, depth, final_t, spill = _render_lists(
            backend, prep, mean2d, height, width, bg, tile_px=tile_px,
            max_per_tile=max_per_tile,
            max_tiles_per_gaussian=max_tiles_per_gaussian, chunk=chunk,
            tight_cull=tight_cull, depth_keys=depth_keys)
        return color, depth, final_t, spill, None
    with torch.no_grad():
        pb = binning.bin_gaussians_pairs(
            mean2d.detach(),
            prep.depth.detach(),
            prep.radius.detach(),
            prep.visible,
            height=height,
            width=width,
            tile_px=tile_px,
            max_per_tile=max_per_tile,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            max_pairs=max_pairs,
            big_capacity=big_capacity,
            small_slots=small_slots,
            conic=prep.conic.detach() if tight_cull else None,
            opacity=prep.opacity.detach() if tight_cull else None,
            depth_keys=depth_keys,
        )
    geom = dict(height=height, width=width, tiles_x=pb.tiles_x,
                tiles_y=pb.tiles_y, tile_px=tile_px, chunk=max(chunk, 128))
    shift = 0
    if stream_base is not None:
        shift = int(stream_base(pb.length)) % geom["chunk"]
        pb = _shift_stream(pb, shift)
    feats = (mean2d, prep.conic, prep.rgb, prep.depth, prep.opacity)
    if backend == "cuda_train":
        # kernel forward (which hands boundary_T over) and kernel backward,
        # whose fold reads the binning's layout of the shifted stream; bg·T
        # stays outside the Function so that autograd supplies dL/dT_fin
        color, depth, final_t = pairs_backward.stream_composite(
            *feats, pb.pair_ids, pb.starts.to(torch.int32).contiguous(),
            pb.counts.to(torch.int32).contiguous(),
            layout=pb.fold_layout(shift), **geom)
        color = color + final_t[..., None] * bg[None, None, :]
    else:
        color, depth, final_t = pairs_composite.composite_pairs(
            pb.pair_ids, pb.starts, pb.counts, *feats, bg=bg,
            use_kernel=backend == "cuda_stream", **geom)
    return color, depth, final_t, pb.spill, pb.spill_parts


def _shift_stream(pb: binning.PairBins, shift: int) -> binning.PairBins:
    """``pb`` with ``shift`` unused positions before its first pair (id 0,
    in no tile's range, so never composited and given no gradient). The
    fold's layout takes the same ``shift`` (``PairBins.fold_layout``)."""
    if not shift:
        return pb
    pad = pb.pair_ids.new_zeros(shift)
    return pb._replace(pair_ids=torch.cat([pad, pb.pair_ids]),
                       starts=pb.starts + shift)


def _bin_lists(prep, mean2d, height, width, *, tile_px, max_per_tile,
               max_tiles_per_gaussian, tight_cull,
               depth_keys=None) -> binning.TileBins:
    with torch.no_grad():
        return binning.bin_gaussians(
            mean2d.detach(), prep.depth.detach(), prep.radius.detach(),
            prep.visible, height=height, width=width, tile_px=tile_px,
            max_per_tile=max_per_tile,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            conic=prep.conic.detach() if tight_cull else None,
            opacity=prep.opacity.detach() if tight_cull else None,
            depth_keys=depth_keys)


def _render_lists(backend, prep, mean2d, height, width, bg, *, chunk,
                  **bin_kw):
    """The per-tile-list backends → (color, depth, final_T, spill)."""
    bins = _bin_lists(prep, mean2d, height, width, **bin_kw)
    feats = (mean2d, prep.conic, prep.rgb, prep.depth, prep.opacity)
    geom = dict(height=height, width=width, tiles_x=bins.tiles_x,
                tiles_y=bins.tiles_y, tile_px=bin_kw["tile_px"], bg=bg)
    if backend == "cuda_tiles":
        color, depth, final_t = tiles_composite.composite_tiles(
            bins.lists, bins.counts, *feats, order=bins.order,
            chunk=max(chunk, 128), **geom)
        return color, depth, final_t, bins.spill
    out = composite.composite(bins.lists, bins.counts, *feats,
                              spill=bins.spill, chunk=chunk, **geom)
    return out.color, out.depth, out.final_T, out.spill


def render_point_cloud(points, colors, cam, *, point_size: float = 0.01,
                       opacity: float = 0.99, bg=None, **render_kw
                       ) -> RenderOut:
    """Render a raw coloured point cloud as isotropic Gaussians
    (point_cloud_render, gaussian_renderer/__init__.py:156-250), on the
    camera's device."""
    import numpy as np

    from dge_tpu_torch.scene import gaussians as G

    pts = np.asarray(points, np.float32)
    n = len(pts)
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    scene = G.from_arrays(
        pts,
        G.rgb_to_sh(np.asarray(colors, np.float32)).reshape(n, 1, 3),
        np.zeros((n, 0, 3), np.float32),
        np.full((n, 1), np.log(opacity / (1 - opacity)), np.float32),
        np.full((n, 3), np.log(point_size), np.float32),
        rot,
        max_sh_degree=0,
        device=cam.device,
    )
    return render(scene, cam, bg, **render_kw)


class LiftOut(NamedTuple):
    weights: torch.Tensor  # [capacity] summed mask weights
    counts: torch.Tensor  # [capacity] summed hit weights
    spill: torch.Tensor  # scalar int32 list entries the binning dropped
    # [4] int32 (slot, cap, tile, stream) attribution of the spill
    spill_parts: torch.Tensor


def render_weights(scene, cam, mask_img, *, tile_px: int = 32,
                   max_per_tile: int = 2048, max_tiles_per_gaussian: int = 32,
                   chunk: int = 64) -> LiftOut:
    """Back-project a per-pixel mask ``[H, W]`` to per-Gaussian (weights, hit
    counts), each ``[capacity]`` (GaussianModel.apply_weights,
    gaussian_model.py:817-832, apply_weights.cu): lifts a segmentation mask
    to Gaussian space for local editing. Binning always culls tightly: the
    lift skips alpha < 1/255 as the colour compositors do. Also returns the
    list binning's spill and its attribution: entries dropped at these caps
    are missing from the lift (``grow_caps`` takes ``spill_parts``)."""
    with torch.no_grad():
        prep = projection.preprocess(
            scene.xyz, scene.get_scaling, scene.get_rotation,
            scene.get_opacity, scene.get_features, scene.alive, cam,
            scene.active_sh_degree, scene.max_sh_degree)
        bins = _bin_lists(prep, prep.mean2d, cam.height, cam.width,
                          tile_px=tile_px,
                          max_per_tile=max_per_tile,
                          max_tiles_per_gaussian=max_tiles_per_gaussian,
                          tight_cull=True)
        w, c = composite.lift_weights(
            bins.lists, bins.counts, bins.order, prep.mean2d, prep.conic,
            prep.opacity,
            torch.as_tensor(mask_img, dtype=torch.float32).to(scene.device),
            num_gaussians=scene.capacity, height=cam.height, width=cam.width,
            tiles_x=bins.tiles_x, tiles_y=bins.tiles_y, tile_px=tile_px,
            chunk=chunk)
        return LiftOut(w, c, bins.spill, bins.spill_parts)


class SpillFreeRenderer:
    """Adaptive-cap renderer for evaluation paths (render CLI, quality
    eval): probe-and-grow the binning caps until ``spill == 0``.

    The first rung enables exact tight tile culling; later rungs double
    only the overflowing cap class (``grow_caps`` + ``spill_parts``); the
    list backends report no ``spill_parts``, so every cap doubles. Every
    rung syncs ``spill`` to the host. ``backend`` defaults to
    ``"cuda_stream"`` for a scene on a CUDA device and ``"torch"`` for one
    on the CPU; the list backends run where their compositor does
    (``"cuda_tiles"`` on a CUDA device, ``"torch_tiles"`` on either); any
    other pairing raises.

    Usage::

        r = SpillFreeRenderer(scene, bg)
        r.probe(cams[0])              # grow caps on a representative view
        for cam in cams:
            color, spill = r(cam)     # re-grows if this view still spills
    """

    def __init__(self, scene, bg=None, *, log=None, max_grow=8, backend=None,
                 **render_kw):
        want = default_backend(scene.device)
        backend = backend or want
        allowed = {want, "torch_tiles"}
        if torch.device(scene.device).type == "cuda":
            allowed.add("cuda_tiles")
        if backend not in allowed:
            raise ValueError(
                f"SpillFreeRenderer: backend {backend!r} does not run on a "
                f"scene on {scene.device} (expected {want!r})")
        self._scene = scene
        self._bg = bg
        self._max_grow = max_grow
        self._log = log if log is not None else (lambda msg: None)
        n = int(scene.capacity)
        caps = dict(
            max_per_tile=4096,
            max_tiles_per_gaussian=32,
            small_slots=4,
            # start at the bin_gaussians_pairs auto defaults so the ladder
            # doubles from where the backend would have started
            max_pairs=max(1 << 18, 1 << int(2 * n - 1).bit_length()),
            big_capacity=1 << max(int(n // 32 - 1).bit_length(), 6),
        )
        for k in list(caps):
            if k in render_kw:
                v = render_kw.pop(k)
                # render()'s 0/None sentinels mean "auto"; storing them here
                # would make the doubling ladder multiply 0 forever
                if v:
                    caps[k] = v
        self._caps = caps
        self._kw = dict(render_kw, backend=backend)

    @property
    def caps(self):
        return dict(self._caps)

    @property
    def tight_cull(self) -> bool:
        return bool(self._kw.get("tight_cull"))

    def render(self, cam) -> RenderOut:
        """One render at the current caps (no ladder)."""
        return render(self._scene, cam, self._bg, **self._kw, **self._caps)

    def _fwd(self, cam):
        o = self.render(cam)
        return o.color, o.spill, o.spill_parts

    def _grow(self, sp: int, parts=None):
        """One ladder rung: "cull" (enabled culling), "grew" (caps doubled)
        or "stuck" (attributed classes at their ceilings)."""
        if not self._kw.get("tight_cull"):
            self._kw["tight_cull"] = True
            self._log(f"render spill {sp}: enabling tight_cull")
            return "cull"
        new = grow_caps(self._caps, parts)
        if new == self._caps:
            self._log(f"render spill {sp}: caps at ceilings — "
                      "irreducible residual")
            return "stuck"
        self._caps = new
        self._log(f"render spill {sp} (parts "
                  f"{None if parts is None else [int(x) for x in parts]}"
                  f"): growing caps to {self._caps}")
        return "grew"

    def probe(self, cam) -> int:
        """Grow caps until ``cam`` renders with spill == 0 (or max_grow
        rungs are exhausted — returns the residual spill, 0 on success)."""
        grows = 0
        while grows < self._max_grow:
            _, sp, parts = self._fwd(cam)
            if int(sp) == 0:
                return 0
            rung = self._grow(int(sp), parts)
            if rung == "stuck":
                return int(sp)
            grows += 1 if rung == "grew" else 0
        # ladder exhausted after a final grow: re-probe so the reported
        # residual matches the caps actually in effect
        _, sp, _ = self._fwd(cam)
        return int(sp)

    def __call__(self, cam, regrow: int = 4):
        """Render one view spill-free, re-growing caps (``regrow`` rungs)
        if this view is denser than the probe view. Returns (color, spill);
        spill > 0 only if the ladder was exhausted."""
        color, sp, parts = self._fwd(cam)
        for _ in range(regrow):
            if int(sp) == 0:
                break
            if self._grow(int(sp), parts) == "stuck":
                break
            color, sp, parts = self._fwd(cam)
        return color, int(sp)
