"""Direct 3DGS fitting: the train step and the host-side loop with densify.

JAX counterpart: ``dge_tpu/systems/fit.py``. Reference analogs: the vanilla
trainer (gaussiansplatting/train.py:31-129, L1 + lambda_dssim*(1-SSIM) loss,
densify every interval, opacity reset) and the DGE refit stage
(threestudio/systems/DGE.py:617-699).

One train step is render -> loss -> backward -> masked Adam update ->
densification statistics, run eagerly. On a CUDA device the render backend is
``"cuda_train"``: the forward compositing kernel and the two backward kernels
(ops/pairs_backward.py); on the CPU it is ``"torch"`` (plain autograd).
Nothing is compiled, so a spill-ladder rung or a capacity growth just changes
the numbers the next step runs with.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from dge_tpu_torch import resolve_device
from dge_tpu_torch.ops import binning as B
from dge_tpu_torch.ops import losses as L
from dge_tpu_torch.ops import render as R
from dge_tpu_torch.scene.gaussians import GaussianScene
from dge_tpu_torch.systems import densify as D
from dge_tpu_torch.systems import optim as O


@dataclasses.dataclass
class FitState:
    """Densification statistics (xyz_gradient_accum / denom / max_radii2D,
    gaussian_model.py:330-334, 811-815)."""

    grad_accum: torch.Tensor  # [cap]
    denom: torch.Tensor  # [cap]
    max_radii2d: torch.Tensor  # [cap]
    step: int

    @classmethod
    def create(cls, capacity: int, device="cuda", step: int = 0) -> "FitState":
        dev = resolve_device(device)

        def z():
            return torch.zeros(capacity, dtype=torch.float32, device=dev)

        return cls(grad_accum=z(), denom=z(), max_radii2d=z(), step=step)

    def replace(self, **changes) -> "FitState":
        return dataclasses.replace(self, **changes)


def fit_state_from_numpy(grad_accum, denom, max_radii2d, step,
                         device="cuda") -> FitState:
    """Carry a JAX ``FitState``'s leaves (as numpy) across."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return FitState(f32(grad_accum), f32(denom), f32(max_radii2d), int(step))


def _train_backend(backend: Optional[str], device) -> str:
    """The trainer's backend for a scene on ``device``; a kernel backend on
    CPU tensors is an error, and the plain version is never picked silently
    on a card."""
    want = R.default_train_backend(device)
    backend = backend or want
    if backend.startswith("cuda") and torch.device(device).type != "cuda":
        raise ValueError(f"train backend {backend!r} does not run on a scene "
                         f"on {device} (expected {want!r})")
    return backend


def accumulate_stats(fit_state: FitState, goffset: torch.Tensor,
                     visible: torch.Tensor, radii: torch.Tensor, width: int,
                     height: int) -> FitState:
    """One step's densification statistics (add_densification_stats,
    gaussian_model.py:811-815) from the gradient of the screen-space offset
    ``goffset`` [N, 2], the visibility and the radii. CUDA's viewspace
    gradients are NDC-scale, ours pixel-scale: scaled by (W/2, H/2) to keep
    the reference's threshold (backward.cu:460-461)."""
    g_ndc = torch.stack([goffset[:, 0] * (width * 0.5),
                         goffset[:, 1] * (height * 0.5)], dim=-1)
    gnorm = torch.linalg.vector_norm(g_ndc, dim=-1)
    zero = torch.zeros_like(gnorm)
    return fit_state.replace(
        grad_accum=fit_state.grad_accum + torch.where(visible, gnorm, zero),
        denom=fit_state.denom + visible.float(),
        max_radii2d=torch.maximum(fit_state.max_radii2d,
                                  torch.where(visible, radii, zero)),
        step=fit_state.step + 1)


def make_train_step(
    optimizer: O.Optimizer,
    *,
    lambda_dssim: float = 0.2,
    lambda_l1: float = 1.0,
    perceptual_fn: Optional[Callable] = None,
    lambda_perceptual: float = 0.0,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    max_tiles_per_gaussian: int = 32,
    max_pairs: int = 0,
    big_capacity: int = 0,
    small_slots: int = 4,
    chunk: int = 64,
    backend: Optional[str] = None,
    tight_cull: bool = False,
):
    """Build a (scene, opt_state, fit_state, cam, target, bg) step.

    Loss = lambda_l1 * L1 + lambda_dssim * (1 - SSIM) [vanilla 3DGS,
    train.py:77-79] + lambda_perceptual * perceptual [DGE refit,
    DGE.py:637-683]. ``backend=None`` is ``"cuda_train"`` for a scene on a
    CUDA device and ``"torch"`` for one on the CPU.
    """

    def train_step(scene: GaussianScene, opt_state, fit_state: FitState, cam,
                   target, bg):
        use = _train_backend(backend, scene.device)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in scene.params().items()}
        offset = torch.zeros(scene.capacity, 2, dtype=torch.float32,
                             device=scene.device, requires_grad=True)
        out = R.render(
            scene.with_params(params),
            cam,
            bg,
            tile_px=tile_px,
            max_per_tile=max_per_tile,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            max_pairs=max_pairs,
            big_capacity=big_capacity,
            small_slots=small_slots,
            mean2d_offset=offset,
            chunk=chunk,
            backend=use,
            tight_cull=tight_cull,
        )
        img = out.color
        l1 = lambda_l1 * L.l1_loss(img, target)
        loss = l1
        if lambda_dssim:
            loss = loss + lambda_dssim * (1.0 - L.ssim(img, target))
        if perceptual_fn is not None and lambda_perceptual:
            loss = loss + lambda_perceptual * perceptual_fn(img, target)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names] + [offset])
        with torch.no_grad():
            gparams = O.apply_grad_mask(dict(zip(names, grads[:-1])),
                                        scene.grad_mask, scene.alive)
            goffset = grads[-1]
            new_params, opt_state = optimizer.update(
                gparams, opt_state, {k: v.detach() for k, v in params.items()})
            scene = scene.with_params(new_params)

            fit_state = accumulate_stats(fit_state, goffset, out.visible,
                                         out.radii, cam.width, cam.height)
            aux = {
                "loss": l1.detach(),
                "psnr": L.psnr(img.detach(), target),
                "spill": out.spill,
            }
            if out.spill_parts is not None:
                aux["spill_parts"] = out.spill_parts
        return scene, opt_state, fit_state, aux

    return train_step


def densify_step(
    scene,
    opt_state,
    fit_state,
    generator=None,
    *,
    max_grad: float,
    max_densify_percent: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float,
    generation_num: int = 0,
    noise=None,
):
    """Densify + prune, Adam-state reset for the changed rows, stat reset
    (densification_postfix + densify_and_prune, gaussian_model.py:643-809)."""
    with torch.no_grad():
        scene, info = D.densify_and_prune(
            scene,
            fit_state.grad_accum,
            fit_state.denom,
            fit_state.max_radii2d,
            generator,
            max_grad=max_grad,
            max_densify_percent=max_densify_percent,
            min_opacity=min_opacity,
            extent=extent,
            max_screen_size=max_screen_size,
            percent_dense=percent_dense,
            generation_num=generation_num,
            noise=noise,
        )
        opt_state = O.zero_adam_rows(opt_state, info.changed_rows)
        fit_state = FitState.create(scene.capacity, scene.device,
                                    step=fit_state.step)
    return scene, opt_state, fit_state, info


def _pad_opt_state(opt_state, old_cap: int, new_cap: int):
    """Zero-pad the per-row Adam state on capacity growth (the momentum of
    existing rows is preserved, unlike a fresh init)."""

    def pad(x):
        z = torch.zeros((new_cap - old_cap,) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=x.device)
        return torch.cat([x, z], dim=0)

    return {k: {"mu": pad(st["mu"]), "nu": pad(st["nu"]),
                "count": st["count"]} for k, st in opt_state.items()}


@dataclasses.dataclass
class FitLoop:
    """Host-side fitting loop: steps, periodic densify, capacity growth and
    the spill ladder (the training() loop of gaussiansplatting/train.py:31-129
    without its scaffolding)."""

    cfg: O.OptimConfig
    extent: float = 1.0
    max_densify_percent: float = 1.0
    min_opacity: float = 0.005
    max_screen_size: float = 0.0
    spatial_lr_scale: float = 1.0
    tile_px: int = 32
    max_per_tile: int = 2048
    max_tiles_per_gaussian: int = 32
    max_pairs: int = 0  # 0 = auto (binning scales with capacity)
    big_capacity: int = 0  # 0 = auto (bucketed emission default)
    small_slots: int = 4  # bucketed-emission small/big threshold
    chunk: int = 64
    grow_threshold: float = 0.9
    lambda_l1: float = 1.0
    perceptual_fn: Optional[Callable] = None
    lambda_perceptual: float = 0.0
    backend: Optional[str] = None  # None = cuda_train on a card, torch on CPU
    spill_patience: int = 3  # consecutive spilling steps before caps grow
    # exact tight tile culling: off by default, switched on as the FIRST
    # react_to_spill response (dropping invisible pairs is cheaper than
    # growing caps)
    tight_cull: bool = False

    def __post_init__(self):
        self.optimizer = O.make_optimizer(self.cfg, self.spatial_lr_scale)
        self._spill_streak = 0
        self._rebuild()

    def _rebuild(self):
        """A new train step at the current caps (nothing is compiled)."""
        self.train_step = make_train_step(
            self.optimizer,
            lambda_dssim=self.cfg.lambda_dssim,
            lambda_l1=self.lambda_l1,
            perceptual_fn=self.perceptual_fn,
            lambda_perceptual=self.lambda_perceptual,
            backend=self.backend,
            **self.caps,
        )

    @property
    def caps(self) -> dict:
        return dict(
            tile_px=self.tile_px,
            max_per_tile=self.max_per_tile,
            max_tiles_per_gaussian=self.max_tiles_per_gaussian,
            max_pairs=self.max_pairs,
            big_capacity=self.big_capacity,
            small_slots=self.small_slots,
            chunk=self.chunk,
            tight_cull=self.tight_cull,
        )

    def react_to_spill(self, spill: int, capacity: int, parts=None) -> bool:
        """Adaptive spill ladder: persistent spill means the binning caps no
        longer fit the scene, and training against truncated tile lists
        corrupts it. After ``spill_patience`` consecutive spilling steps:
        (1) enable exact tight tile culling; (2) if spill persists, double
        only the cap classes that ``parts`` ((slot, cap, tile, stream),
        binning.PairBins.spill_parts) attributes the overflow to, each up to
        its ceiling; without ``parts`` every class grows. Returns True when
        anything changed."""
        if spill <= 0:
            self._spill_streak = 0
            return False
        self._spill_streak += 1
        if self._spill_streak < self.spill_patience:
            return False
        self._spill_streak = 0
        if not self.tight_cull:
            self.tight_cull = True
            self._rebuild()
            return True
        if parts is not None:
            pl = [int(x) for x in parts]
            wants = [x > 0 for x in (
                pl if len(pl) == 4 else [pl[0], pl[0], pl[1], pl[2]])]
        else:
            wants = [True] * 4
        grew = False
        want_slot, want_cap, want_tile, want_stream = wants
        if want_slot and self.max_tiles_per_gaussian < 256:
            self.max_tiles_per_gaussian *= 2
            grew = True
        if want_tile and self.max_per_tile < 1 << 15:
            self.max_per_tile *= 2
            grew = True
        auto_pairs = B.default_max_pairs(capacity)
        new_pairs = max(self.max_pairs or auto_pairs, auto_pairs) * 2
        if want_stream and new_pairs <= 1 << 22:
            self.max_pairs = new_pairs
            grew = True
        auto_big = B.default_big_capacity(capacity)
        new_big = max(self.big_capacity or auto_big, auto_big) * 2
        if want_cap and new_big <= capacity:
            self.big_capacity = new_big
            grew = True
        if want_cap and self.small_slots < 32:
            # a flooded big grid usually means the whole population moved up
            # a rect-size class; raising the small/big threshold is cheaper
            # than doubling big_capacity forever
            self.small_slots *= 2
            grew = True
        # no fallback to unrelated classes when the attributed ones are at
        # their ceilings: that spill is irreducible
        if grew:
            self._rebuild()
        return grew

    def init(self, scene: GaussianScene):
        return (self.optimizer.init(scene.params()),
                FitState.create(scene.capacity, scene.device))

    def maybe_housekeep(self, scene, opt_state, fit_state):
        """Periodic non-densify upkeep: opacity reset every
        opacity_reset_interval steps (train.py:97-99) and SH degree step-up
        every 1000 steps (train.py:52-54). Never reset on the final step: the
        reference saves before its reset block, and a run whose max_steps is
        a reset multiple would export a freshly transparent scene."""
        step = fit_state.step
        if step > 0 and step % 1000 == 0:
            scene = scene.one_up_sh_degree()
        if (
            self.cfg.opacity_reset_interval > 0
            and 0 < step < self.cfg.max_steps
            and step % self.cfg.opacity_reset_interval == 0
        ):
            with torch.no_grad():
                scene, rows = D.reset_opacity(scene)
                opt_state = O.zero_adam_rows(opt_state, rows,
                                             fields=("opacity",))
        return scene, opt_state, fit_state

    def maybe_densify(self, scene, opt_state, fit_state, generator=None,
                      generation_num=0, noise=None):
        """Densify and prune every ``densification_interval`` steps inside
        the densify window, but never after the final step: clones and split
        children that no later step optimises only damage the scene that is
        saved (the JAX loop densifies there too; ROADMAP.md §3)."""
        step = fit_state.step
        if (
            step < self.cfg.densify_from_iter
            or step > self.cfg.densify_until_iter
            or step % self.cfg.densification_interval != 0
            or step >= self.cfg.max_steps
        ):
            return scene, opt_state, fit_state, None
        # grow capacity when nearly full
        if scene.n_alive > self.grow_threshold * scene.capacity:
            old_cap = scene.capacity
            new_cap = old_cap * 2
            scene = D.grow_capacity(scene, new_cap)
            opt_state = _pad_opt_state(opt_state, old_cap, new_cap)
            fit_state = FitState.create(new_cap, scene.device,
                                        step=fit_state.step)
        return self._densify(scene, opt_state, fit_state, generator,
                             generation_num, noise)

    def _densify(self, scene, opt_state, fit_state, generator, generation_num,
                 noise=None):
        return densify_step(
            scene,
            opt_state,
            fit_state,
            generator,
            max_grad=self.cfg.densify_grad_threshold,
            max_densify_percent=self.max_densify_percent,
            min_opacity=self.min_opacity,
            extent=self.extent,
            max_screen_size=self.max_screen_size,
            percent_dense=self.cfg.percent_dense,
            generation_num=generation_num,
            noise=noise,
        )
