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

import dataclasses
from typing import NamedTuple, Optional

import torch

from dge_tpu_torch.ops import (binning, composite, cuda_build,
                               pairs_backward, pairs_composite, projection,
                               tiles_composite)
from dge_tpu_torch.utils import tracing

BACKENDS = ("cuda_stream", "cuda_train", "torch", "cuda_tiles", "torch_tiles")
LIST_BACKENDS = ("cuda_tiles", "torch_tiles")
# spill-ladder rungs of SpillFreeRenderer (its ``_grow``): "cull" enabled
# tight culling, "grew" doubled caps, "stuck" found the attributed classes
# at their ceilings; a group of the tracing registry
ladder_counts = tracing.group("render_ladder",
                              {"cull": 0, "grew": 0, "stuck": 0})
# SpillFreeRenderer.__call__'s frames in a CUDA graph (``_FrameGraph``):
# "captures" frames captured, "replays" frames replayed, "eager" frames
# that ran without a graph; a group of the tracing registry
graph_counts = tracing.group("render_graph",
                             {"captures": 0, "replays": 0, "eager": 0})
# the scene's tensors that render()'s getters read
SCENE_READS = ("xyz", "scaling", "rotation", "opacity", "features_dc",
               "features_rest", "alive")


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
    densification. Spans (utils/tracing.py): ``render.view`` over the call,
    ``render.preprocess`` and ``rasterize``'s two."""
    backend = backend or default_backend(scene.device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown render backend {backend!r}")
    dev = scene.device
    with tracing.span("render.view", device=dev):
        bg = (torch.zeros(3, device=dev) if bg is None
              else torch.as_tensor(bg, dtype=torch.float32).to(dev))
        with tracing.span("render.preprocess", device=dev):
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
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            max_pairs=max_pairs, big_capacity=big_capacity,
            small_slots=small_slots, chunk=chunk, tight_cull=tight_cull)
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
    own first entry and need no shift. Spans (utils/tracing.py):
    ``render.binning`` and ``render.composite``."""
    if backend in LIST_BACKENDS:
        color, depth, final_t, spill = _render_lists(
            backend, prep, mean2d, height, width, bg, tile_px=tile_px,
            max_per_tile=max_per_tile,
            max_tiles_per_gaussian=max_tiles_per_gaussian, chunk=chunk,
            tight_cull=tight_cull, depth_keys=depth_keys)
        return color, depth, final_t, spill, None
    dev = mean2d.device
    with torch.no_grad(), tracing.span("render.binning", device=dev):
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
        shift = tracing.host_read(stream_base(pb.length),
                                  "render.stream_base") % geom["chunk"]
        pb = _shift_stream(pb, shift)
    feats = (mean2d, prep.conic, prep.rgb, prep.depth, prep.opacity)
    with tracing.span("render.composite", device=dev):
        if backend == "cuda_train":
            # kernel forward (which hands boundary_T over) and kernel
            # backward, whose fold reads the binning's layout of the shifted
            # stream; bg·T stays outside the Function so that autograd
            # supplies dL/dT_fin
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
    dev = mean2d.device
    with tracing.span("render.binning", device=dev):
        bins = _bin_lists(prep, mean2d, height, width, **bin_kw)
    feats = (mean2d, prep.conic, prep.rgb, prep.depth, prep.opacity)
    geom = dict(height=height, width=width, tiles_x=bins.tiles_x,
                tiles_y=bins.tiles_y, tile_px=bin_kw["tile_px"], bg=bg)
    with tracing.span("render.composite", device=dev):
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
    render reads ``spill`` on the host once (``host_syncs["render.spill"]``,
    utils/tracing.py) and each rung is counted in ``ladder_counts``; a call
    is a ``render.spill_free`` span. ``backend`` defaults to
    ``"cuda_stream"`` for a scene on a CUDA device and ``"torch"`` for one
    on the CPU; the list backends run where their compositor does
    (``"cuda_tiles"`` on a CUDA device, ``"torch_tiles"`` on either); any
    other pairing raises.

    ``__call__`` replays its frame from a CUDA graph where ``_replays``
    holds (a ``"cuda_stream"`` scene on the card, no autograd graph to
    record, spans not recording): the frame is captured once per
    ``frame_key`` (caps, keywords, viewport, the scene's storage) and
    replayed per pose, the same kernels with the same arguments, so the
    same bits. It counts in ``graph_counts``. ``probe`` and ``render`` run
    eagerly.

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
            max_pairs=binning.default_max_pairs(n),
            big_capacity=binning.default_big_capacity(n),
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
        self._graph = None  # the _FrameGraph that __call__ replays

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
        """One render → (color, its spill read on the host, spill_parts)."""
        o = self.render(cam)
        return (o.color, tracing.host_read(o.spill, "render.spill"),
                o.spill_parts)

    def _grow(self, sp: int, parts=None):
        """One ladder rung: "cull" (enabled culling), "grew" (caps doubled)
        or "stuck" (attributed classes at their ceilings); counted in
        ``ladder_counts``."""
        rung = self._rung(sp, parts)
        ladder_counts[rung] += 1
        return rung

    def _rung(self, sp: int, parts) -> str:
        if not self._kw.get("tight_cull"):
            self._kw["tight_cull"] = True
            self._log(f"render spill {sp}: enabling tight_cull")
            return "cull"
        if parts is not None:
            parts = tracing.host_read(parts, "render.spill_parts",
                                      lambda p: p.tolist())
        new = grow_caps(self._caps, parts)
        if new == self._caps:
            self._log(f"render spill {sp}: caps at ceilings — "
                      "irreducible residual")
            return "stuck"
        self._caps = new
        self._log(f"render spill {sp} (parts {parts}): growing caps to "
                  f"{self._caps}")
        return "grew"

    def probe(self, cam) -> int:
        """Grow caps until ``cam`` renders with spill == 0 (or max_grow
        rungs are exhausted — returns the residual spill, 0 on success)."""
        with tracing.span("render.spill_free", probe=True):
            grows = 0
            while grows < self._max_grow:
                _, sp, parts = self._fwd(cam)
                if sp == 0:
                    return 0
                rung = self._grow(sp, parts)
                if rung == "stuck":
                    return sp
                grows += 1 if rung == "grew" else 0
            # ladder exhausted after a final grow: re-probe so the reported
            # residual matches the caps actually in effect
            return self._fwd(cam)[1]

    def __call__(self, cam, regrow: int = 4):
        """Render one view spill-free, re-growing caps (``regrow`` rungs)
        if this view is denser than the probe view. Returns (color, spill);
        spill > 0 only if the ladder was exhausted."""
        with tracing.span("render.spill_free"):
            color, sp, parts = self._frame(cam)
            for _ in range(regrow):
                if sp == 0:
                    break
                # reads ``parts`` before the next frame drops their graph
                if self._grow(sp, parts) == "stuck":
                    break
                color, sp, parts = self._frame(cam)
            return color, sp

    def _replays(self, cam) -> bool:
        """Whether ``__call__`` replays a captured frame for ``cam``: the
        scene on a CUDA device and the ``"cuda_stream"`` backend; the
        preprocess on its kernel path (no autograd graph to record); the
        camera's tensors as that kernel takes them and ``bg`` (None or a
        tensor) on the scene's device; spans not recording, since they are
        Python, which a replay does not run."""
        scene, bg = self._scene, self._bg
        dev = scene.device
        if dev.type != "cuda" or self._kw["backend"] != "cuda_stream" or \
                tracing.is_recording():
            return False
        camera = [getattr(cam, name) for name, _ in projection.CAMERA_FIELDS]
        tensors = [v for v in self._kw.values() if isinstance(v, torch.Tensor)]
        if projection.needs_graph(*(getattr(scene, n) for n in SCENE_READS),
                                  bg, *camera, *tensors):
            return False
        return (bg is None or isinstance(bg, torch.Tensor) and
                bg.device == dev) and all(
            isinstance(t, torch.Tensor) and t.device == dev and
            t.dtype == torch.float32 and tuple(t.shape) == shape
            for t, (_, shape) in zip(camera, projection.CAMERA_FIELDS))

    def _frame(self, cam):
        """``__call__``'s render → (color, its spill read on the host,
        spill_parts): a replay of the frame captured under the current
        ``frame_key`` where ``_replays`` holds (captured first where the key
        changed), else ``_fwd``. A replayed colour is returned as a copy,
        since callers keep frames across calls."""
        if not self._replays(cam):
            graph_counts["eager"] += 1
            return self._fwd(cam)
        key = frame_key(self._scene, self._bg, cam.height, cam.width,
                        self._caps, self._kw)
        if self._graph is None or self._graph.key != key:
            # dropped first, so that the capture's empty_cache frees its pool
            self._graph = None
            self._graph = _FrameGraph(key, self.render, cam)
            graph_counts["captures"] += 1
        color, spill, parts = self._graph.replay(cam)
        graph_counts["replays"] += 1
        return (color.clone(), tracing.host_read(spill, "render.spill"),
                parts)


def _address(x):
    """A tensor by its address, anything else as it is."""
    return x.data_ptr() if isinstance(x, torch.Tensor) else x


def frame_key(scene, bg, height: int, width: int, caps: dict,
              kw: dict) -> tuple:
    """What a frame of ``render(scene, cam, bg, **kw, **caps)`` captured in
    a CUDA graph depends on, besides the camera's values: the caps, every
    keyword (``tight_cull``, ``tile_px``, ``chunk``, ``scale_modifier``,
    the backend), the viewport, the SH degrees and the capacity (which fix
    every scene tensor's shape) by value; each scene tensor the getters
    read (``SCENE_READS``) and ``bg`` by address. An update in place
    (Adam's ``add_``) keeps the key, and the replay sees it; a ladder rung,
    or a scene tensor reallocated (densify), changes it."""
    return (tuple(sorted(caps.items())),
            tuple(sorted((k, _address(v)) for k, v in kw.items())),
            int(height), int(width), scene.active_sh_degree,
            scene.max_sh_degree, scene.capacity,
            tuple(_address(getattr(scene, n)) for n in SCENE_READS),
            _address(bg))


class _FrameGraph:
    """One frame of ``render`` captured in a CUDA graph, with a private
    memory pool of its own, for ``SpillFreeRenderer.__call__`` to replay
    per pose.

    The graph reads the camera from its own tensors, into which each
    replay copies the pose's, device to device, and writes the frame into
    tensors of its pool, which every replay overwrites. The capture follows
    PyTorch's rule: one eager frame on a side stream first, so that the
    sort's and the cumsum's workspaces and the libraries' first-call set-up
    happen outside it. The kernels' C entries launch on the current stream
    (``cuda_build.launch``), which is the capture's during the capture.
    Their launches are taken back out of ``cuda_build.launch_counts``, since
    a capture launches nothing on the device, and counted again at every
    replay, so that the counts read as on the eager path."""

    def __init__(self, key: tuple, render_frame, cam):
        self.key = key
        self.device = cam.w2c.device.index
        names = [name for name, _ in projection.CAMERA_FIELDS]
        self.camera = [getattr(cam, n).detach().clone(
            memory_format=torch.contiguous_format) for n in names]
        static = dataclasses.replace(cam, **dict(zip(names, self.camera)))
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                render_frame(static)
            torch.cuda.current_stream().wait_stream(side)
            before = dict(cuda_build.launch_counts)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                out = render_frame(static)
        self.out = (out.color, out.spill, out.spill_parts)
        self.launches = {k: n - before[k]
                         for k, n in cuda_build.launch_counts.items()
                         if n != before[k]}
        for k, n in self.launches.items():
            cuda_build.count(k, -n)

    def replay(self, cam):
        """The frame for ``cam`` → (color, spill, spill_parts): the graph's
        own tensors, overwritten by the next replay."""
        with torch.cuda.device(self.device):
            torch._foreach_copy_(self.camera, [
                getattr(cam, name) for name, _ in projection.CAMERA_FIELDS])
            self.graph.replay()
        for k, n in self.launches.items():
            cuda_build.count(k, n)
        return self.out
