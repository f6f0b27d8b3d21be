"""The DGE editing system: render -> multi-view edit -> direct 3DGS refit.

JAX counterpart: ``dge_tpu/systems/edit.py``. Reference analog:
threestudio/systems/DGE.py:

- render_all_view caches the original renders (:241-264)
- update_mask lifts SAM masks to per-Gaussian weights and installs the grad
  mask for local editing (:101-165)
- edit_all_view re-edits the view set every camera_update_per_step steps
  through the guidance, with ring-ordered cameras and the
  added_noise_schedule annealing (:523-586)
- training_step fits the Gaussians to the edited frames with L1 +
  perceptual loss (:617-699), densifying every 100 steps (:266-296); with
  ``use_sds`` it distils the multi-view guidance's score into the scene
  instead, every step over a random camera batch (:685-694)

View renders (origin frames, each round's inputs, validation) take the
CUDA stream kernel K1 on a card and its plain version on the CPU; the refit
is ``FitLoop.train_step`` (K1, K3, K4 and the ordered fold on a card), and an
SDS step renders its views twice: without a gradient for the guidance, then
in one autograd graph through the VAE encoder (each render K1 forward and
K3, K4 and the fold backward). All per-step randomness comes from
``step_generator(seed, step)`` and the edit round's from ``step_generator(seed, 1_000_000 + round_start)`` (the JAX
``fold_in`` pattern), so a resumed run replays the uninterrupted one.

Under a process group (``batch_mode: "shard"``) every rank runs the system
alike: the same draws, the same gathered noise predictions, the same refit.
``check_replicas`` compares a checksum of the ranks' scenes after a run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

import dge_tpu_torch
from dge_tpu_torch.diffusion import ddim
from dge_tpu_torch.diffusion import ip2p as P
from dge_tpu_torch.ops import render as R
from dge_tpu_torch.parallel import dist as D
from dge_tpu_torch.parallel.mesh import stack_cameras
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.scene.gaussians import GaussianScene
from dge_tpu_torch.systems import fit as F
from dge_tpu_torch.systems import guidance as GD
from dge_tpu_torch.systems import optim as O
from dge_tpu_torch.systems import segmentation as SG
from dge_tpu_torch.utils import checkpoint as CK
from dge_tpu_torch.utils import saving, tracing


@dataclasses.dataclass
class EditConfig:
    """configs/dge.yaml system block (DGE.Config, DGE.py:31-77)."""

    max_steps: int = 1000
    camera_update_per_step: int = 500
    added_noise_schedule: Sequence[int] = (999, 300, 300, 21)
    densify_interval: int = 100
    densify_from: int = 100
    densify_until: int = 10_000
    max_densify_percent: float = 0.01
    densify_grad_threshold: float = 5.0
    min_opacity: float = 0.005
    lambda_l1: float = 10.0
    lambda_perceptual: float = 10.0
    camera_batch_size: int = 5
    max_view_num: int = 20
    seg_prompt: str = ""
    # the sam2 segmentor's prompt: a scene-space box (x0, y0, z0, x1, y1,
    # z1), projected into each view in place of a text detector's box
    seg_box: Optional[Sequence[float]] = None
    mask_thres: float = 0.8
    use_masked_image: bool = False
    # SDS mode (DGE.py:685-694): per-step score distillation through the
    # multi-view guidance instead of refitting edited frames
    use_sds: bool = False
    lambda_sds: float = 1.0
    # cached original renders / edited frames / Gaussian masks are reloaded
    # when present unless overwrite is set (DGE.py:96-99)
    cache_overwrite: bool = False
    # LR scalers (DGE.py:500-515 -> OptimizationParams ctor)
    gs_lr_scaler: float = 3.0
    gs_final_lr_scaler: float = 3.0
    color_lr_scaler: float = 3.0
    opacity_lr_scaler: float = 2.0
    scaling_lr_scaler: float = 2.0
    rotation_lr_scaler: float = 2.0
    tile_px: int = 32
    max_per_tile: int = 2048
    chunk: int = 64


def step_generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one stream of a run (a step, or 1_000_000 + a round
    start): the counterpart of ``fold_in(PRNGKey(seed), stream)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, stream])
                        .generate_state(1)[0]))
    return gen


def _choose_views(n: int, k: int, generator: torch.Generator) -> List[int]:
    """``k`` distinct positions out of ``n`` (an SDS step's camera batch; the
    JAX system's ``jax.random.choice`` without replacement)."""
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:k].tolist()


def _timestep(lo: int, hi: int, generator: torch.Generator) -> int:
    """An SDS step's timestep, uniform in ``[lo, hi]``."""
    return int(torch.randint(lo, hi + 1, (1,), generator=generator,
                             device=generator.device))


@dge_tpu_torch.register("dge-system")
class DGESystem:
    def __init__(self, cfg: EditConfig, scene: GaussianScene,
                 cameras: Sequence[CameraArrays], guidance=None,
                 text_emb_pos: Optional[torch.Tensor] = None,
                 text_emb_neg: Optional[torch.Tensor] = None,
                 perceptual_fn: Optional[Callable] = None,
                 cameras_extent: float = 1.0,
                 cache_dir: Optional[str] = None,
                 segmentor: Optional[Callable] = None,
                 camera_pool: Optional[Sequence[CameraArrays]] = None,
                 pooled_pos: Optional[torch.Tensor] = None,
                 pooled_neg: Optional[torch.Tensor] = None):
        """``text_emb_*`` [1, S, D] and, for the SDXL editor, ``pooled_*``
        [1, P]: the prompt's and the negative prompt's."""
        self.cfg = cfg
        self.scene = scene
        self.cameras = list(cameras)
        # full camera pool for per-round view resampling (gs_load.py:286-292)
        self.camera_pool = (list(camera_pool) if camera_pool is not None
                            else None)
        self.guidance = guidance
        self.text_emb_pos = text_emb_pos
        self.text_emb_neg = text_emb_neg
        self.pooled_pos = pooled_pos
        self.pooled_neg = pooled_neg
        self.segmentor = segmentor
        self.cache_dir = cache_dir
        self.cameras_extent = cameras_extent
        ocfg = O.OptimConfig.scaled(
            cfg.max_steps,
            lr_scaler=cfg.gs_lr_scaler,
            lr_final_scaler=cfg.gs_final_lr_scaler,
            color_lr_scaler=cfg.color_lr_scaler,
            opacity_lr_scaler=cfg.opacity_lr_scaler,
            scaling_lr_scaler=cfg.scaling_lr_scaler,
            rotation_lr_scaler=cfg.rotation_lr_scaler,
            densification_interval=cfg.densify_interval,
            densify_from_iter=cfg.densify_from,
            densify_until_iter=cfg.densify_until,
            densify_grad_threshold=cfg.densify_grad_threshold,
            lambda_dssim=0.0,
        )
        self.optim_cfg = ocfg
        self.loop = F.FitLoop(
            ocfg,
            extent=cameras_extent,
            max_densify_percent=cfg.max_densify_percent,
            min_opacity=cfg.min_opacity,
            spatial_lr_scale=cameras_extent,
            tile_px=cfg.tile_px,
            max_per_tile=cfg.max_per_tile,
            chunk=cfg.chunk,
            lambda_l1=cfg.lambda_l1,
            perceptual_fn=perceptual_fn,
            lambda_perceptual=cfg.lambda_perceptual,
        )
        self.opt_state, self.fit_state = self.loop.init(scene)
        self.origin_frames: Dict[int, np.ndarray] = {}
        self.edit_frames: Dict[int, np.ndarray] = {}
        self.view_list = list(range(len(self.cameras)))
        self.total_spill = 0
        self.losses_finite = True  # every step's loss so far
        # binning spill of the gradient-free view renders
        self.render_spill = 0
        # list entries the mask lift dropped after its cap ladder, and the
        # caps it ended at (None until a mask is lifted)
        self.lift_spill = 0
        self.lift_caps: Optional[dict] = None
        # host seconds by stage ("origin", "edit", "fit", "sds",
        # "validate")
        self.seconds: Dict[str, float] = defaultdict(float)
        self.device = scene.device
        self._render_backend = R.default_backend(self.device)

    def _render(self, vid: int, override_color=None) -> torch.Tensor:
        """A gradient-free view render at the loop's current binning caps
        (every cap the spill ladder grows reaches the renders the edit
        round consumes)."""
        with torch.no_grad():
            out = R.render(self.scene, self.cameras[vid],
                           torch.zeros(3, device=self.device),
                           override_color=override_color,
                           backend=self._render_backend, **self.loop.caps)
        self.render_spill += tracing.host_read(out.spill, "edit.render_spill")
        return out.color

    def _render_np(self, vid: int) -> np.ndarray:
        return self._render(vid).cpu().numpy()

    # ---- edit cache (DGE.py:96-99: reload unless overwrite) ----
    def _cache_load_frames(self, subdir: str
                           ) -> Optional[Dict[int, np.ndarray]]:
        """A complete cached frame set for the current view list, or None if
        missing, incomplete or overwritten."""
        if not self.cache_dir or self.cfg.cache_overwrite:
            return None
        frames = {}
        for vid in self.view_list:
            p = os.path.join(self.cache_dir, subdir, f"{vid:04d}.png")
            if not os.path.exists(p):
                return None
            frames[vid] = saving.load_image(p)
        return frames

    def probe_caps(self) -> None:
        """Grow the loop's binning caps until every view renders spill-free
        (SpillFreeRenderer's ladder), so that no origin frame, edit input or
        refit step drops pairs. The JAX system renders at its initial caps
        and drops them silently (ROADMAP.md §3)."""
        r = R.SpillFreeRenderer(self.scene, torch.zeros(3, device=self.device),
                                backend=self._render_backend, **self.loop.caps)
        start = r.caps
        for vid in self.view_list:
            if r.probe(self.cameras[vid]):
                raise RuntimeError(f"view {vid}: binning spill at the caps' "
                                   "ceilings")
        if r.caps != start or r.tight_cull != self.loop.tight_cull:
            self.loop.tight_cull = r.tight_cull
            for k, v in r.caps.items():
                setattr(self.loop, k, v)
            self.loop._rebuild()
            self.cfg.max_per_tile = self.loop.max_per_tile

    # ---- stage 0: cache original renders (render_all_view) ----
    def render_all_views(self) -> Dict[int, np.ndarray]:
        """The origin frames (from the cache when it holds them), after the
        caps are probed spill-free over the views."""
        t0 = time.time()
        self.probe_caps()
        cached = self._cache_load_frames("origin")
        if cached is not None:
            self.origin_frames = cached
            return self.origin_frames
        for vid in self.view_list:
            # at PNG (u8) precision, so cache-hit and cache-miss runs are
            # bit-identical (the reference round-trips through PNGs too)
            self.origin_frames[vid] = _quantize_u8(self._render_np(vid))
            if self.cache_dir:
                saving.save_image(
                    os.path.join(self.cache_dir, "origin", f"{vid:04d}.png"),
                    self.origin_frames[vid])
        self.seconds["origin"] += time.time() - t0
        return self.origin_frames

    # ---- local editing mask (update_mask, DGE.py:101-165) ----
    def segment_views(self) -> SG.SegmentOut:
        """The batch segmentor (``sam2``) over the origin frames of
        ``view_list``, copied to the device one by one into one tensor,
        ``camera_batch_size`` views an encoder call, each prompted with
        ``cfg.seg_box`` projected into it; masks [V, H, W] on the device, by
        view."""
        if self.cfg.seg_box is None:
            raise ValueError("the sam2 segmentor needs a scene-space box "
                             "(system.seg_box: x0, y0, z0, x1, y1, z1)")
        views = self.view_list
        cam = self.cameras[views[0]]
        frames = torch.empty((len(views), cam.height, cam.width, 3),
                             device=self.device)
        for i, v in enumerate(views):
            frames[i].copy_(torch.from_numpy(
                self.origin_frames[v] if v in self.origin_frames
                else self._render_np(v)))
        boxes = SG.project_box(self.cfg.seg_box,
                               stack_cameras([self.cameras[v] for v in views]))
        return self.segmentor.segment(frames, boxes,
                                      self.cfg.camera_batch_size)

    def update_mask(self) -> None:
        """Segment each original view (a batch segmentor: all of them in
        ``segment_views``), lift the masks to per-Gaussian weights
        (``render_weights``), threshold, install the grad mask; the mask is
        cached as ``gs_mask.npy``.

        The lift's list caps start at ``max_per_tile`` and 32 tiles a
        Gaussian and grow (``grow_caps``, the classes ``spill_parts``
        names) until each view's binning drops nothing; the JAX system
        lifts at its fixed caps and loses the deepest entries of every
        overflowing tile (ROADMAP.md §3). ``lift_spill`` (0, or this
        raises) and ``lift_caps`` record the outcome."""
        if not self.cfg.seg_prompt or self.segmentor is None:
            return
        cap = self.scene.capacity
        if self.cache_dir and not self.cfg.cache_overwrite:
            p = os.path.join(self.cache_dir, "gs_mask.npy")
            if os.path.exists(p):
                gmask = np.load(p)
                if gmask.shape[0] == cap:
                    self.scene = self.scene.replace(grad_mask=torch.as_tensor(
                        gmask, dtype=torch.float32, device=self.device))
                    return
        caps = dict(max_per_tile=self.cfg.max_per_tile,
                    max_tiles_per_gaussian=32)
        weights = torch.zeros(cap, device=self.device)
        counts = torch.zeros(cap, device=self.device)
        self.lift_spill = 0
        batched = (self.segment_views().masks
                   if hasattr(self.segmentor, "segment") else None)
        for i, vid in enumerate(self.view_list):
            if batched is not None:
                mask = batched[i]
            else:
                img = self.origin_frames.get(vid)
                if img is None:
                    img = self._render_np(vid)
                mask = self.segmentor(img, self.cfg.seg_prompt)  # [H, W]
            while True:
                lift = R.render_weights(self.scene, self.cameras[vid], mask,
                                        tile_px=self.cfg.tile_px,
                                        chunk=self.cfg.chunk, **caps)
                spill = int(lift.spill)
                if spill == 0:
                    break
                grown = R.grow_caps(caps, lift.spill_parts)
                if grown == caps:
                    raise RuntimeError(f"view {vid}: the mask lift drops "
                                       f"{spill} entries at the caps' "
                                       f"ceilings {caps}")
                caps = grown
            self.lift_spill += spill
            weights = weights + lift.weights
            counts = counts + lift.counts
        self.lift_caps = caps
        frac = torch.where(counts > 0, weights / counts.clamp(min=1.0), 0.0)
        gmask = (frac > self.cfg.mask_thres) & self.scene.alive
        self.scene = self.scene.replace(grad_mask=gmask.float())
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            np.save(os.path.join(self.cache_dir, "gs_mask.npy"),
                    self.scene.grad_mask.cpu().numpy())

    def resample_views(self, seed: int) -> None:
        """Re-draw the working view subset from the full camera pool
        (gs_load.py:286-292; DGE re-samples after the first round)."""
        pool = self.camera_pool
        if pool is None or len(pool) <= len(self.view_list):
            return
        r = np.random.default_rng(seed)
        idx = sorted(r.choice(len(pool), size=len(self.view_list),
                              replace=False))
        self.cameras = [pool[i] for i in idx]
        self.view_list = list(range(len(self.cameras)))
        self.origin_frames = {}
        self.render_all_views()

    # ---- stage 1: multi-view edit round (edit_all_view, DGE.py:523-586) --
    def edit_all_views(self, generator: torch.Generator, global_step: int = 0,
                       update_camera: bool = False) -> None:
        t0 = time.time()
        if update_camera:
            self.resample_views(global_step + 1)
        cached = self._cache_load_frames(f"edit_{global_step}")
        if cached is not None:
            self.edit_frames.update(cached)
            return
        cfg = self.cfg
        sched = list(cfg.added_noise_schedule)
        round_idx = min(len(sched) - 1,
                        global_step // max(cfg.camera_update_per_step, 1))
        max_step = sched[round_idx]

        # ring-order the cameras for coherent batching (sort_the_cameras_idx)
        centers = np.stack([tracing.host_read(self.cameras[v].campos,
                                              "edit.ring_order", _numpy)
                            for v in self.view_list])
        # view direction in world = third row of the w2c rotation
        forwards = np.stack([tracing.host_read(self.cameras[v].w2c[2, :3],
                                               "edit.ring_order", _numpy)
                             for v in self.view_list])
        views_sorted = [self.view_list[i]
                        for i in _ring_order(centers, forwards)]
        renders = []
        for vid in views_sorted:
            img = self._render(vid)
            if cfg.use_masked_image:
                # restrict the guidance input to the editable region: the
                # per-Gaussian mask rendered as colour (DGE.py:566-567)
                mask_color = self.scene.grad_mask[:, None].expand(-1, 3)
                m = self._render(vid, override_color=mask_color)
                img = img * (m[..., :1] > 0.5)
            renders.append(img)
        rgb = torch.stack(renders)
        cond = torch.stack([torch.from_numpy(self.origin_frames[v])
                            for v in views_sorted]).to(self.device)
        n = rgb.shape[0]
        pos = self.text_emb_pos.expand((n,) + self.text_emb_pos.shape[-2:])
        neg = self.text_emb_neg.expand((n,) + self.text_emb_neg.shape[-2:])
        cams = stack_cameras([self.cameras[v] for v in views_sorted])
        edited = self.guidance(rgb, cond, pos, neg, cams, generator,
                               max_step=max_step, **self._pooled(n))
        edited = _quantize_u8(tracing.host_read(edited, "edit.frames",
                                                _numpy))
        for i, vid in enumerate(views_sorted):
            self.edit_frames[vid] = edited[i]
            if self.cache_dir:
                saving.save_image(
                    os.path.join(self.cache_dir, f"edit_{global_step}",
                                 f"{vid:04d}.png"), edited[i])
        self.seconds["edit"] += time.time() - t0

    # ---- stage 2: refit (training_step, DGE.py:617-699) ----
    def fit_step(self, vid: int, generator: torch.Generator
                 ) -> Dict[str, object]:
        target = torch.from_numpy(self.edit_frames[vid]).to(self.device)
        bg = torch.zeros(3, device=self.device)
        self.scene, self.opt_state, self.fit_state, aux = \
            self.loop.train_step(self.scene, self.opt_state, self.fit_state,
                                 self.cameras[vid], target, bg)
        self.scene, self.opt_state, self.fit_state, _ = \
            self.loop.maybe_densify(self.scene, self.opt_state,
                                    self.fit_state, generator)
        # spill_parts is a [4] attribution vector; everything else scalar
        return {k: (v.cpu().numpy() if v.dim() else v.item())
                for k, v in aux.items()}

    # ---- SDS mode (use_sds branch, DGE.py:685-694) ----
    def sds_loss_and_grads(self, vids: Sequence[int], target: torch.Tensor,
                           noise: torch.Tensor,
                           backend: Optional[str] = None):
        """The SDS refit's loss ``lambda_sds · 0.5 Σ(lat - target)² / B`` and
        its gradients: the ``B`` views rendered in one autograd graph that
        shares one screen-space offset [N, 2], resized to the guidance's
        size, encoded with the posterior draw ``noise`` that made the target.
        ``backend`` defaults to the trainer's (``"cuda_train"`` on a card).
        Returns (loss, gradients by parameter name and
        ``"mean2d_offset"``, the renders)."""
        backend = F._train_backend(backend or self.loop.backend, self.device)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self.scene.params().items()}
        offset = torch.zeros(self.scene.capacity, 2, dtype=torch.float32,
                             device=self.device, requires_grad=True)
        scene = self.scene.with_params(params)
        bg = torch.zeros(3, device=self.device)
        outs = [R.render(scene, self.cameras[v], bg, mean2d_offset=offset,
                         backend=backend, **self.loop.caps) for v in vids]
        rgb = torch.stack([o.color for o in outs])
        b, h, w = rgb.shape[:3]
        rh, rw = P.resize_to_64_multiple(h, w,
                                         self.guidance.cfg.resize_target)
        if (rh, rw) != (h, w):
            rgb = GD._resize(rgb, rh, rw)
        lat = P.encode_images_with(self.guidance.models, rgb, noise)
        loss = self.cfg.lambda_sds * 0.5 * ((lat - target) ** 2).sum() / b
        names = list(params)
        grads = torch.autograd.grad(loss,
                                    [params[k] for k in names] + [offset])
        return (loss.detach(), dict(zip(names + ["mean2d_offset"], grads)),
                outs)

    def sds_step(self, generator: torch.Generator) -> Dict[str, object]:
        """One SDS step over a random camera batch: the views rendered
        without a gradient and encoded, the guidance's multi-view eps at a
        random ``t`` -> target latents, then the refit through the renders
        and the encoder, the masked Adam update, the densification
        statistics (visible in any view, the largest radius, the shared
        offset's gradient) and ``maybe_densify``. Draws, in order: the
        views, the posterior sample, ``t``, the noise, the pivot offsets,
        then the densify's."""
        g = self.guidance
        models = g.models
        cbs = min(self.cfg.camera_batch_size, len(self.view_list))
        vids = [self.view_list[i] for i in
                _choose_views(len(self.view_list), cbs, generator)]
        rgb = torch.stack([self._render(v) for v in vids])
        cond = torch.stack([torch.from_numpy(self.origin_frames[v])
                            for v in vids]).to(self.device)
        b, h, w = rgb.shape[:3]
        rh, rw = P.resize_to_64_multiple(h, w, g.cfg.resize_target)
        if (rh, rw) != (h, w):
            rgb, cond = GD._resize(rgb, rh, rw), GD._resize(cond, rh, rw)
        enc_noise = P._normal(P.latent_shape(models, rgb), generator)
        with torch.no_grad():
            latents = P.encode_images_with(models, rgb, enc_noise)
        pos = self.text_emb_pos.expand((b,) + self.text_emb_pos.shape[-2:])
        neg = self.text_emb_neg.expand((b,) + self.text_emb_neg.shape[-2:])
        pooled = self._pooled(b)
        triple_for = g.triples(
            torch.cat([pos, neg, neg]), P.encode_cond_images(models, cond),
            torch.cat([pooled["pooled_pos"], pooled["pooled_neg"],
                       pooled["pooled_neg"]]) if pooled else None)

        t = _timestep(g.min_step, g.max_step, generator)
        noise = P._normal(tuple(latents.shape), generator)
        noisy = ddim.add_noise(models.schedule, latents, noise, t)
        with torch.no_grad():
            eps = g._predict_eps_multiview(
                noisy, t, stack_cameras([self.cameras[v] for v in vids]),
                triple_for, b, b, 1, latents.shape[1], latents.shape[2],
                generator)
        target = latents - g.sds_grad(eps, noise, t)

        loss, grads, outs = self.sds_loss_and_grads(vids, target, enc_noise)
        with torch.no_grad():
            goffset = grads.pop("mean2d_offset")
            gparams = O.apply_grad_mask(grads, self.scene.grad_mask,
                                        self.scene.alive)
            params, self.opt_state = self.loop.optimizer.update(
                gparams, self.opt_state, self.scene.params())
            self.scene = self.scene.with_params(params)
            vis = torch.stack([o.visible for o in outs]).any(dim=0)
            radii = torch.stack([o.radii for o in outs]).amax(dim=0)
            cam = self.cameras[vids[0]]
            self.fit_state = F.accumulate_stats(self.fit_state, goffset, vis,
                                                radii, cam.width, cam.height)
        self.scene, self.opt_state, self.fit_state, _ = \
            self.loop.maybe_densify(self.scene, self.opt_state,
                                    self.fit_state, generator)
        return {"loss": loss.item(), "t": t,
                "spill": int(sum(int(o.spill) for o in outs)),
                "spill_parts": torch.stack(
                    [o.spill_parts for o in outs]).sum(dim=0).cpu().numpy()}

    def _pooled(self, n: int) -> Dict[str, torch.Tensor]:
        """The pooled embeddings of ``n`` views as the guidance takes them
        (none for the SD-1.5 editor)."""
        if self.pooled_pos is None:
            return {}
        return {"pooled_pos": self.pooled_pos.expand(n, -1),
                "pooled_neg": self.pooled_neg.expand(n, -1)}

    # ---- checkpoint / resume (capture() / restore() analogs) ----
    def save_state(self, path: str, step: int) -> str:
        return CK.save_checkpoint(
            path, self.scene, self.opt_state, self.fit_state,
            extra={"step": step, "capacity": self.scene.capacity,
                   "max_per_tile": self.loop.max_per_tile,
                   "caps": self.loop.caps})

    def restore_state(self, path: str) -> int:
        """Restore scene, optimiser and fit state and the binning caps;
        returns the step to resume from."""
        self.scene, self.opt_state, self.fit_state, meta = \
            CK.restore_checkpoint(path, self.device)
        caps = meta.get("caps", {"max_per_tile": meta.get(
            "max_per_tile", self.loop.max_per_tile)})
        if any(getattr(self.loop, k) != v for k, v in caps.items()):
            for k, v in caps.items():
                setattr(self.loop, k, v)
            self.loop._rebuild()
        self.cfg.max_per_tile = self.loop.max_per_tile
        return int(meta.get("step", 0))

    # ---- in-training validation (DGE.py:298-361 val grids + video) ----
    def validate(self, val_dir: str, step: int) -> None:
        t0 = time.time()
        # render | edit target side by side only when every view has one
        with_targets = all(v in self.edit_frames for v in self.view_list)
        renders, pairs = [], []
        for vid in self.view_list:
            img = self._render_np(vid)
            renders.append(img)
            pairs.append(np.concatenate([img, self.edit_frames[vid]], axis=1)
                         if with_targets else img)
        saving.save_image_grid(os.path.join(val_dir, f"it{step}-val.png"),
                               pairs, cols=4)
        saving.save_video(os.path.join(val_dir, f"it{step}-val.mp4"),
                          renders, fps=10)
        self.seconds["validate"] += time.time() - t0

    # ---- the edit loop ----
    def run(self, seed: int, steps: Optional[int] = None, log_every=50,
            log_fn=print, start_step: int = 0,
            ckpt_dir: Optional[str] = None, val_dir: Optional[str] = None,
            metrics=None) -> GaussianScene:
        """Steps ``start_step .. steps - 1``; ``metrics`` (a MetricsLogger)
        gets every step's scalars."""
        cfg = self.cfg
        steps = steps or cfg.max_steps
        dev = self.device
        if not self.origin_frames:
            self.render_all_views()
        self.update_mask()
        for step in range(start_step, steps):
            gen = step_generator(seed, step, dev)
            if cfg.use_sds:
                t0 = time.time()
                aux = self.sds_step(gen)
                self.seconds["sds"] += time.time() - t0
            else:
                # re-edit every round boundary, or right after a mid-round
                # resume (edit frames are not checkpointed)
                if (step % cfg.camera_update_per_step == 0
                        or not self.edit_frames):
                    round_start = ((step // cfg.camera_update_per_step)
                                   * cfg.camera_update_per_step)
                    # re-draw the view subset after the first round
                    # (DGE.py:528)
                    self.edit_all_views(
                        step_generator(seed, 1_000_000 + round_start, dev),
                        global_step=round_start,
                        update_camera=round_start > 0)
                    if val_dir:
                        self.validate(val_dir, step)
                    if ckpt_dir:
                        self.save_state(
                            os.path.join(ckpt_dir, f"step_{step}"), step)
                vid = self.view_list[np.random.default_rng((7, step))
                                     .integers(len(self.view_list))]
                t0 = time.time()
                aux = self.fit_step(vid, gen)
                self.seconds["fit"] += time.time() - t0
            # training against truncated tile lists corrupts the scene: grow
            # the caps when the spill persists
            spill = int(aux.get("spill", 0))
            self.total_spill += spill
            self.losses_finite &= math.isfinite(aux["loss"])
            if self.loop.react_to_spill(spill, self.scene.capacity,
                                        aux.get("spill_parts")):
                cfg.max_per_tile = self.loop.max_per_tile
                log_fn(f"step {step}: binning spill persisted — caps now "
                       f"{self.loop.caps}")
            if metrics is not None:
                metrics.log(step, {f"train/{k}": v for k, v in aux.items()
                                   if isinstance(v, (int, float))})
            if step % log_every == 0:
                psnr = f" psnr={aux['psnr']:.2f}" if "psnr" in aux else ""
                log_fn(f"step {step}: loss={aux['loss']:.4f}{psnr}")
        if self.total_spill:
            log_fn(f"total binning spill over run: {self.total_spill} pairs")
        if ckpt_dir:
            self.save_state(os.path.join(ckpt_dir, "last"), steps)
        if val_dir:
            self.validate(val_dir, steps)
        return self.scene

    def check_replicas(self) -> str:
        """A checksum of the scene's buffers, compared over the ranks of the
        process group (raises if two differ; one rank has nothing to
        compare). Returns it."""
        h = hashlib.sha256()
        for k in ("xyz", "features_dc", "features_rest", "opacity",
                  "scaling", "rotation", "alive", "grad_mask"):
            h.update(getattr(self.scene, k).detach().cpu().numpy().tobytes())
        mine = h.hexdigest()[:16]
        if D.world_size() > 1:
            seen = [None] * D.world_size()
            D.dist.all_gather_object(seen, mine)
            if len(set(seen)) != 1:
                raise RuntimeError(f"the ranks' scenes differ: {seen}")
        return mine


def _numpy(x: torch.Tensor) -> np.ndarray:
    """``x`` on the host as float32 (bf16 networks' frames have no numpy
    dtype; a float32 tensor keeps its bits)."""
    return x.float().cpu().numpy()


def _quantize_u8(img: np.ndarray) -> np.ndarray:
    """Round to u8 precision (the edit cache's PNG format) so cached and
    fresh frames are bit-identical."""
    u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return u8.astype(np.float32) / 255.0


def _ring_order(centers: np.ndarray,
                forwards: Optional[np.ndarray] = None) -> List[int]:
    """Reference-exact camera ring ordering (sort_the_cameras_idx,
    DGE.py:588-600): signed angle of each camera's forward vector from the
    leftmost (min world-x centre) camera's forward vector, the rotation
    sign fixed by the second-closest camera. Falls back to an SVD-plane
    angle sort when forward vectors are unavailable or degenerate."""
    if forwards is not None and len(centers) >= 3:
        f = np.asarray(forwards, np.float64)
        norms = np.linalg.norm(f, axis=1, keepdims=True)
        if np.all(norms > 1e-12):
            f = f / norms
            mlv = f[int(np.argmin(centers[:, 0]))]
            # unsigned angular distance picks the second-nearest forward
            # vector that defines the rotation axis (DGE.py:593-595)
            d0 = np.arccos(np.clip(f @ mlv, 0.0, 1.0))
            second = f[np.argsort(d0, kind="stable")[1]]
            ref_axis = np.cross(mlv, second)
            if np.linalg.norm(ref_axis) > 1e-9:
                ang = np.arccos(np.clip(f @ mlv, -1.0, 1.0))
                sign = np.cross(np.broadcast_to(mlv, f.shape), f) @ ref_axis
                signed = np.where(sign >= 0, ang, 2.0 * np.pi - ang)
                return [int(i) for i in np.argsort(signed, kind="stable")]
    rel = centers - centers.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(rel, full_matrices=False)
    uv = rel @ vt[:2].T
    return [int(i) for i in np.argsort(np.arctan2(uv[:, 1], uv[:, 0]))]
