"""DGE guidance: multi-view-consistent InstructPix2Pix editing.

JAX counterpart: ``dge_tpu/systems/guidance.py``. Reference analog:
DGEGuidance (threestudio/models/guidance/dge_guidance.py) — the 20-step
truncated DDIM edit loop with one random pivot per camera batch, extended
attention over the pivots, epipolar-constrained pivot-attention reuse for
the other views (edit_latents :246-374), IP2P 3-way CFG (:362-368) and
plain attention below t=100 (use_normal_unet :237-244).

The UNet takes an attention ``mode``, a ``CrossViewState`` and the pivot
record (a dict this module owns for one step). Closest cameras and epipolar
constraints are computed once per (step, camera batch) outside the network.
``batch_mode="loop"`` runs the reuse pass once per camera batch (the
reference's order, batch 0 with one key); ``"vmap"`` (the name
``configs/dge.yaml`` uses) runs every batch in one batched UNet call;
``"shard"`` splits that call's camera batches into contiguous blocks over
the ranks of the process group (parallel/dist.py) and gathers the noise
predictions in batch order, so every rank holds the same ``eps``. The
SDS mode's eps prediction is ``sds_multiview`` / ``compute_grad_sds``.

The SDXL editor's UNet also takes pooled text embeddings: every entry point
takes them beside the text states (``pooled_pos`` / ``pooled_neg`` [B, P],
or ``pooled`` [3B, P] as (pos, neg, neg)), and the CFG triples carry them
as they carry the states. Cross-view state is built only at the latent
downscales at which the UNet attends (``UNetConfig.attention_downscales``:
SD-1.5's four, SDXL's 2 and 4).

Images are ``[B, H, W, 3]`` in [0, 1] and latents ``[B, h, w, 4]`` at this
module's edges (the JAX layout). With bf16 networks (``build_models(dtype=
torch.bfloat16)``) the dtypes are JAX's: bf16 posterior latents and noise,
f32 latents from ``add_noise`` and every DDIM step, bf16 noise predictions
and edited images. Every random draw goes through ``P._normal``
or ``_pivot_offsets`` with an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

import dge_tpu_torch
from dge_tpu_torch.diffusion import ddim, epipolar
from dge_tpu_torch.diffusion import ip2p as P
from dge_tpu_torch.models.layers import CrossViewState
from dge_tpu_torch.parallel import dist as D
from dge_tpu_torch.parallel.mesh import index_cameras
from dge_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """configs/dge.yaml guidance defaults (dge_guidance.py:34-51)."""

    guidance_scale: float = 7.5
    condition_scale: float = 1.5
    camera_batch_size: int = 5
    diffusion_steps: int = 20
    use_sds: bool = False
    min_step_percent: float = 0.02
    max_step_percent: float = 0.98
    normal_attn_below_t: int = 100
    epipolar_threshold: float = 1.0
    # "banded": 3 line coefficients per query token, distance test evaluated
    # blockwise inside the pivot-reuse gather (nothing S x S materialises);
    # "dense": the reference's full [S, S] violation masks (test oracle)
    epipolar_mode: str = "banded"
    # long-side target of the pre-VAE resize (dge_guidance.py:505-511)
    resize_target: int = 512
    # VAE encode / decode batch
    vae_batch: int = 5
    # "loop": one reuse pass per camera batch, reference semantics (batch 0
    # with one key); "vmap": all batches in one batched reuse pass with a
    # uniform 2-key state (batch 0 duplicates its closest key with blend 1,
    # which equals the 1-key gather); "shard": the vmap pass with its camera
    # batches split over the ranks of the process group
    batch_mode: str = "loop"


def _pivot_offsets(n_batches: int, cbs: int,
                   generator: torch.Generator) -> np.ndarray:
    """One random pivot offset in [0, cbs) per camera batch (the reference's
    per-step draw, edit_latents :305), read on the host."""
    return tracing.host_read(
        torch.randint(0, cbs, (n_batches,), generator=generator,
                      device=generator.device),
        "guidance.pivot_offsets", lambda x: x.cpu().numpy())


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of [B, H, W, 3]; antialiased, which is what
    ``jax.image.resize(..., "bilinear")`` does when it shrinks. Computed in
    f32, returned in ``x``'s dtype."""
    return P.nhwc(F.interpolate(P.nchw(x.float()), size=(h, w),
                                mode="bilinear", align_corners=False,
                                antialias=True)).to(x.dtype)


@torch.no_grad()
def make_cross_view_state(cams_b, key_cams, pivot_in_batch: int,
                          latent_h: int, latent_w: int, n_key: int,
                          threshold: float = 1.0,
                          mode: str = "banded",
                          downscales=(1, 2, 4, 8)) -> CrossViewState:
    """Closest key cameras, the distance blend and the per-resolution
    epipolar constraints of one camera batch (make_dge_block's closest_cam
    search :407-424 and w1 blend :557-566; edit_latents' per-batch mask
    precompute :329-342), the pivot frame's rows cleared (:493-496).

    ``mode="banded"``: normalised epipolar lines [F, n_key, S, 3] per
    resolution, the distance test evaluated blockwise in the gather;
    ``mode="dense"``: [F, n_key, S, S] violation masks (the test oracle).
    ``downscales``: the latent downscales to build them at (the
    resolutions the UNet attends at). A ``guidance.cross_view_state`` span
    (utils/tracing.py)."""
    with tracing.span("guidance.cross_view_state",
                      device=cams_b.campos.device):
        d = epipolar.camera_distances(cams_b.campos, key_cams.campos)  # [F, K]
        closest = torch.argsort(d, dim=-1, stable=True)[:, :n_key]
        dsort = torch.sort(d, dim=-1).values
        if n_key == 2:
            w1 = torch.sigmoid(dsort[:, 1]
                               / (dsort[:, 0] + dsort[:, 1] + 1e-12))
        else:
            w1 = torch.ones(d.shape[0], dtype=torch.float32, device=d.device)
        f = d.shape[0]
        key_fp = key_cams.full_proj[closest.reshape(-1)]  # [F*n_key, 4, 4]
        query_fp = cams_b.full_proj.repeat_interleave(n_key, dim=0)
        is_pivot = (torch.arange(f, device=d.device) == pivot_in_batch)[
            :, None, None, None]
        masks: Dict[int, torch.Tensor] = {}
        lines_d: Dict[int, torch.Tensor] = {}
        pts_d: Dict[int, torch.Tensor] = {}
        for ds in downscales:
            h, w = latent_h // ds, latent_w // ds
            if h < 1 or w < 1:
                continue
            s = h * w
            fm = epipolar.fundamental_from_projections(
                epipolar.pixel_projection(key_fp, h, w),
                epipolar.pixel_projection(query_fp, h, w))
            if mode == "banded":
                ln = epipolar.epipolar_lines(fm, h, w).reshape(f, n_key, s, 3)
                # the pivot frame is unconstrained: zero lines -> distance 0
                lines_d[s] = torch.where(is_pivot, 0.0, ln)
                pts_d[s] = epipolar.pixel_grid(h, w, d.device)
            else:
                m = (epipolar.epipolar_distances(fm, h, w)
                     > threshold).reshape(f, n_key, s, s)
                masks[s] = m & ~is_pivot
        return CrossViewState(closest_cam=closest, blend_w1=w1,
                              epipolar=masks or None,
                              epi_lines=lines_d or None,
                              epi_pts=pts_d or None, n_key=n_key,
                              epi_threshold=threshold)


def _unpack(triple):
    """(text states, conditioning latents, pooled embeddings or None) from
    what a ``triple_for`` gives."""
    te, cl, *pe = triple
    return te, cl, (pe[0] if pe else None)


def _two_keys(cv: CrossViewState) -> CrossViewState:
    """A 1-key state as a 2-key one: the closest key twice, blend 1 (the
    reference's batch 0 in the batched reuse, guidance.py:398-416)."""

    def dup(d):
        return None if d is None else {
            s: torch.stack([m[:, 0], m[:, 0]], dim=1) for s, m in d.items()}

    return dataclasses.replace(
        cv, closest_cam=torch.stack([cv.closest_cam[:, 0]] * 2, dim=1),
        blend_w1=torch.ones_like(cv.blend_w1), epipolar=dup(cv.epipolar),
        epi_lines=dup(cv.epi_lines), n_key=2)


def _cat_states(states) -> CrossViewState:
    """The per-frame states of several camera batches as one state over all
    their frames (each frame keeps its own keys, blend and lines)."""

    def cat(name):
        ds = [getattr(st, name) for st in states]
        return None if ds[0] is None else {
            s: torch.cat([d[s] for d in ds], dim=0) for s in ds[0]}

    first = states[0]
    with tracing.span("guidance.cross_view_state",
                      device=first.blend_w1.device):
        return dataclasses.replace(
            first, closest_cam=torch.cat([st.closest_cam for st in states]),
            blend_w1=torch.cat([st.blend_w1 for st in states]),
            epipolar=cat("epipolar"), epi_lines=cat("epi_lines"))


@dge_tpu_torch.register("dge-guidance")
class DGEGuidance:
    def __init__(self, cfg: GuidanceConfig, models: P.IP2PModels):
        if cfg.batch_mode not in ("loop", "vmap", "shard"):
            raise ValueError(f"unknown batch_mode {cfg.batch_mode!r}")
        self.cfg = cfg
        self.models = models
        n = models.schedule.num_train_timesteps
        self.min_step = int(n * cfg.min_step_percent)
        self.max_step = int(n * cfg.max_step_percent)
        # where the cross-view states are needed (make_cross_view_state's
        # default set is SD-1.5's)
        self.downscales = models.unet.config.attention_downscales()
        self._cv_kw = ({} if self.downscales == (1, 2, 4, 8)
                       else {"downscales": self.downscales})

    @staticmethod
    def triples(text_emb: torch.Tensor, cond_latents: torch.Tensor,
                pooled: Optional[torch.Tensor] = None):
        """``triple_for(idx)``: the CFG triples of a view subset, text
        states [pos, neg, neg], conditioning latents [img, img, zero] and
        pooled embeddings [pos, neg, neg] (None without them; a
        ``triple_for`` may also give the first two alone), from
        ``text_emb`` and ``pooled`` laid out (pos, neg, neg) and
        ``cond_latents`` (img, img, zero) over all views."""
        emb_pos, emb_neg, _ = text_emb.chunk(3, dim=0)
        cond_img, _, cond_zero = cond_latents.chunk(3, dim=0)
        pool_pos, pool_neg = (pooled.chunk(3, dim=0)[:2]
                              if pooled is not None else (None, None))

        def triple_for(idx):
            te = torch.cat([emb_pos[idx], emb_neg[idx], emb_neg[idx]], 0)
            cl = torch.cat([cond_img[idx], cond_img[idx], cond_zero[idx]], 0)
            pe = (torch.cat([pool_pos[idx], pool_neg[idx], pool_neg[idx]], 0)
                  if pool_pos is not None else None)
            return te, cl, pe

        return triple_for

    # ---- the edit loop ----
    @torch.no_grad()
    def edit_latents(self, text_emb: torch.Tensor, latents: torch.Tensor,
                     cond_latents: torch.Tensor, t_start: int, cams,
                     generator: torch.Generator,
                     pooled: Optional[torch.Tensor] = None) -> torch.Tensor:
        """text_emb [3B, S, D] (pos, neg, neg), latents [B, h, w, 4],
        cond_latents [3B, h, w, 4] (img, img, zeros), pooled [3B, P] (pos,
        neg, neg; SDXL) -> edited latents."""
        cfg = self.cfg
        b, lat_h, lat_w = latents.shape[:3]
        cbs = cfg.camera_batch_size
        if b % cbs:
            raise ValueError(f"views {b} must be a multiple of batch {cbs}")
        n_batches = b // cbs
        sched = self.models.schedule._replace(
            num_train_timesteps=max(t_start, cfg.diffusion_steps))
        # drawn in the latents' dtype (guidance.py:268)
        noise = P._normal(tuple(latents.shape), generator).to(latents.dtype)
        latents = ddim.add_noise(sched, latents, noise, t_start)
        triple_for = self.triples(text_emb, cond_latents, pooled)
        for t in ddim.inference_timesteps(sched, cfg.diffusion_steps):
            eps = self._predict_eps_multiview(
                latents, int(t), cams, triple_for, b, cbs, n_batches, lat_h,
                lat_w, generator)
            with tracing.span("guidance.cfg_ddim", device=latents.device):
                latents = ddim.step(sched, eps, int(t), latents,
                                    cfg.diffusion_steps)
        return latents

    def _combine(self, eps_chunks):
        """CFG over per-batch eps triplets [3F, h, w, 4] (with the DDIM step
        after it, the ``guidance.cfg_ddim`` spans)."""
        with tracing.span("guidance.cfg_ddim", device=eps_chunks[0].device):
            parts = [e.chunk(3, dim=0) for e in eps_chunks]
            e_t, e_i, e_u = (torch.cat([p[k] for p in parts], 0)
                             for k in range(3))
            return P.cfg_combine(e_t, e_i, e_u, self.cfg.guidance_scale,
                                 self.cfg.condition_scale)

    def _predict_eps_multiview(self, latents, t, cams, triple_for, b, cbs,
                               n_batches, lat_h, lat_w, generator):
        """One CFG-combined multi-view noise prediction at timestep t (the
        body of the reference's edit_latents, dge_guidance.py:289-371):
        plain attention below t=100, otherwise a pivot pass and an
        epipolar-constrained reuse pass per camera batch."""
        cfg = self.cfg
        dev = latents.device
        if t < cfg.normal_attn_below_t:
            # plain attention per camera batch (use_normal_unet)
            eps_chunks = []
            for i in range(n_batches):
                sl = torch.arange(i * cbs, min((i + 1) * cbs, b), device=dev)
                te, cl, pe = _unpack(triple_for(sl))
                inp = torch.cat([P.triple(latents[sl]), cl], dim=-1)
                eps_chunks.append(P.unet_eps(self.models, inp, t, te, pe))
            return self._combine(eps_chunks)

        # one random pivot per camera batch, then the pivot pass over all
        # key frames (extended attention, recorded)
        piv_off = _pivot_offsets(n_batches, cbs, generator)
        piv = torch.as_tensor(piv_off + np.arange(0, b, cbs), device=dev)
        key_cams = index_cameras(cams, piv)
        te_p, cl_p, pe_p = _unpack(triple_for(piv))
        record: dict = {}
        P.unet_eps(self.models,
                   torch.cat([P.triple(latents[piv]), cl_p], dim=-1), t, te_p,
                   pe_p, mode="pivot_record", pivot=record)

        if cfg.batch_mode in ("vmap", "shard"):
            return self._batched_reuse(latents, cams, key_cams, piv_off, t,
                                       lat_h, lat_w, triple_for, n_batches,
                                       cbs, record)
        eps_chunks = []
        for i in range(n_batches):
            sl = torch.arange(i * cbs, (i + 1) * cbs, device=dev)
            n_key = 1 if i == 0 else 2  # make_dge_block batch_idxs
            cv = make_cross_view_state(
                index_cameras(cams, sl), key_cams, int(piv_off[i]), lat_h,
                lat_w, n_key, cfg.epipolar_threshold, cfg.epipolar_mode,
                **self._cv_kw)
            te_b, cl_b, pe_b = _unpack(triple_for(sl))
            inp_b = torch.cat([P.triple(latents[sl]), cl_b], dim=-1)
            eps_chunks.append(P.unet_eps(
                self.models, inp_b, t, te_b, pe_b, mode="pivot_reuse",
                cross_view=cv, pivot=record))
        return self._combine(eps_chunks)

    def _batched_reuse(self, latents, cams, key_cams, piv_off, t, lat_h,
                       lat_w, triple_for, n_batches, cbs, record):
        """Every camera batch in one reuse pass (the JAX package vmaps the
        UNet over the batches, guidance.py:380-477): the batches' frames
        fold into the UNet's batch as ``[text | image | uncond]`` chunks of
        all ``n_batches * cbs`` frames, and the reuse attention gets one
        cross-view state per frame, the batches' 2-key states laid end to
        end (batch 0's single key duplicated with blend 1). The JAX package
        builds batch 0's state with two keys and keeps the first, which
        fails when there is a single key frame (one camera batch, as in an
        SDS step); the port builds it with one.

        ``"shard"`` (guidance.py:439-457): ``nd``, the largest divisor of
        ``n_batches`` not above the group's size, ranks each take a
        contiguous block of the batches; ranks from ``nd`` on compute
        nothing. The pivot record is the same on every rank (each ran the
        pivot pass); the blocks' noise predictions are gathered in batch
        order. With one rank, or no process group, it is ``"vmap"``."""
        cfg = self.cfg
        dev = latents.device
        nd = 1
        if cfg.batch_mode == "shard":
            nd = max(d for d in range(1, D.world_size() + 1)
                     if n_batches % d == 0)
        per = n_batches // nd
        mine = D.rank() if nd > 1 else 0
        if mine >= nd:  # a rank past the blocks sends a placeholder
            eps = latents.new_zeros((3 * per * cbs,)
                                    + tuple(latents.shape[1:]))
            return self._combine(list(D.all_gather_stack(eps)[:nd]))
        states = []
        for i in range(mine * per, (mine + 1) * per):
            sl = torch.arange(i * cbs, (i + 1) * cbs, device=dev)
            cv = make_cross_view_state(
                index_cameras(cams, sl), key_cams, int(piv_off[i]), lat_h,
                lat_w, 1 if i == 0 else 2, cfg.epipolar_threshold,
                cfg.epipolar_mode, **self._cv_kw)
            states.append(_two_keys(cv) if i == 0 else cv)
        frames = torch.arange(mine * per * cbs, (mine + 1) * per * cbs,
                              device=dev)
        te, cl, pe = _unpack(triple_for(frames))
        eps = P.unet_eps(self.models,
                         torch.cat([P.triple(latents[frames]), cl], dim=-1),
                         t, te, pe, mode="pivot_reuse",
                         cross_view=_cat_states(states), pivot=record)
        if nd == 1:
            return self._combine([eps])
        return self._combine(list(D.all_gather_stack(eps)[:nd]))

    @torch.no_grad()
    def __call__(self, rgb: torch.Tensor, cond_rgb: torch.Tensor,
                 text_emb_pos: torch.Tensor, text_emb_neg: torch.Tensor,
                 cams, generator: torch.Generator,
                 max_step: Optional[int] = None,
                 pooled_pos: Optional[torch.Tensor] = None,
                 pooled_neg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Edit all views (guidance __call__, dge_guidance.py:480-569):
        rgb (current renders) and cond_rgb (original renders) [B, H, W, 3]
        in [0, 1], text embeddings [B, S, D], stacked cameras, pooled
        embeddings [B, P] (SDXL). Returns the
        edited images at the input resolution. A ``guidance.round`` span
        (utils/tracing.py) over the VAE's, the UNet's, the cross-view states'
        and CFG + DDIM's."""
        with tracing.span("guidance.round", device=rgb.device):
            b, h, w, _ = rgb.shape
            rh, rw = P.resize_to_64_multiple(h, w, self.cfg.resize_target)
            if (rh, rw) != (h, w):
                rgb, cond_rgb = (_resize(rgb, rh, rw),
                                 _resize(cond_rgb, rh, rw))
            latents = P.encode_images(self.models, rgb, generator,
                                      chunk=self.cfg.vae_batch)
            cond_latents = P.encode_cond_images(self.models, cond_rgb,
                                                chunk=self.cfg.vae_batch)
            text_emb = torch.cat([text_emb_pos, text_emb_neg, text_emb_neg],
                                 0)
            pooled = (torch.cat([pooled_pos, pooled_neg, pooled_neg], 0)
                      if pooled_pos is not None else None)
            t_start = (max_step if max_step is not None
                       else self.max_step) - 1
            edited = self.edit_latents(text_emb, latents, cond_latents,
                                       t_start, cams, generator, pooled)
            imgs = P.decode_latents(self.models, edited,
                                    chunk=self.cfg.vae_batch)
            if (rh, rw) != (h, w):
                imgs = _resize(imgs, h, w)
            return imgs

    def update_step(self, min_step_percent: Optional[float] = None,
                    max_step_percent: Optional[float] = None) -> None:
        """Anneal the noise-level window (DGEGuidance.update_step,
        dge_guidance.py:571-586). Ported as the reference has it: nothing
        calls it (ROADMAP.md §3)."""
        n = self.models.schedule.num_train_timesteps
        if min_step_percent is not None:
            self.min_step = int(n * min_step_percent)
        if max_step_percent is not None:
            self.max_step = int(n * max_step_percent)

    @torch.no_grad()
    def sds_multiview(self, rgb: torch.Tensor, cond_rgb: torch.Tensor,
                      text_emb_pos: torch.Tensor, text_emb_neg: torch.Tensor,
                      cams, generator: torch.Generator,
                      t: Optional[int] = None,
                      pooled_pos: Optional[torch.Tensor] = None,
                      pooled_neg: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """Multi-view SDS (the use_sds path, dge_guidance.py:548-566, and
        compute_grad_sds :376-475): the latents noised at ``t``, one
        pivot / epipolar-attended eps prediction over the views, ``grad =
        (1 - alpha_bar_t)(eps - noise)`` through ``nan_to_num``,
        and the reference's loss form ``0.5 ||latents - target||^2 / B``
        with ``target = latents - grad``. Draws: the posterior sample, the
        noise, then the pivot offsets."""
        cfg = self.cfg
        models = self.models
        b, h, w, _ = rgb.shape
        rh, rw = P.resize_to_64_multiple(h, w, cfg.resize_target)
        if (rh, rw) != (h, w):
            rgb, cond_rgb = _resize(rgb, rh, rw), _resize(cond_rgb, rh, rw)
        latents = P.encode_images(models, rgb, generator)
        triple_for = self.triples(
            torch.cat([text_emb_pos, text_emb_neg, text_emb_neg], 0),
            P.encode_cond_images(models, cond_rgb),
            torch.cat([pooled_pos, pooled_neg, pooled_neg], 0)
            if pooled_pos is not None else None)
        t = int(t if t is not None else self.max_step - 1)
        noise = P._normal(tuple(latents.shape), generator).to(latents.dtype)
        noisy = ddim.add_noise(models.schedule, latents, noise, t)
        cbs = cfg.camera_batch_size
        eps = self._predict_eps_multiview(
            noisy, t, cams, triple_for, b, cbs, max(b // cbs, 1),
            latents.shape[1], latents.shape[2], generator)
        grad = self.sds_grad(eps, noise, t)
        target = latents - grad
        return {"grad": grad,
                "loss_sds": 0.5 * ((latents - target) ** 2).sum() / b,
                "grad_norm": torch.linalg.vector_norm(grad),
                "latents": latents, "target": target}

    def sds_grad(self, eps: torch.Tensor, noise: torch.Tensor,
                 t: int) -> torch.Tensor:
        """The SDS gradient ``(1 - alpha_bar_t)(eps - noise)`` through
        ``nan_to_num`` (NaN to 0, infinities to the largest finite
        floats), as the JAX package takes it."""
        w_t, diff = ddim.promote(1.0 - self.models.schedule.alphas_cumprod[t],
                                 eps - noise)
        return torch.nan_to_num(w_t * diff)

    @torch.no_grad()
    def compute_grad_sds(self, text_emb: torch.Tensor, latents: torch.Tensor,
                         cond_latents: torch.Tensor, t: int,
                         generator: torch.Generator,
                         pooled: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """The single-pass SDS gradient (compute_grad_sds,
        dge_guidance.py:376-475): text_emb [3B, S, D] (pos, neg, neg),
        latents [B, h, w, 4], cond_latents [3B, h, w, 4] (img, img, zeros),
        pooled [3B, P] (SDXL); plain attention,
        ``(1 - alpha_bar_t)(eps - noise)``."""
        noise = P._normal(tuple(latents.shape), generator).to(latents.dtype)
        noisy = ddim.add_noise(self.models.schedule, latents, noise, t)
        cond_img, _, cond_zero = cond_latents.chunk(3, dim=0)
        inp = torch.cat([P.triple(noisy),
                         torch.cat([cond_img, cond_img, cond_zero], 0)],
                        dim=-1)
        e_t, e_i, e_u = P.unet_eps(self.models, inp, t, text_emb,
                                   pooled).chunk(3, dim=0)
        eps = P.cfg_combine(e_t, e_i, e_u, self.cfg.guidance_scale,
                            self.cfg.condition_scale)
        w_t, diff = ddim.promote(1.0 - self.models.schedule.alphas_cumprod[t],
                                 eps - noise)
        return w_t * diff
