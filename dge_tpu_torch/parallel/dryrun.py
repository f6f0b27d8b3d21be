"""The multi-rank dry run: five sharded scenarios on tiny shapes, each held
against a single-rank computation of the same thing.

JAX counterpart: ``dryrun_multichip`` of the repo's ``__graft_entry__.py``
(its five scenarios, on tiny shapes: 512 Gaussians in a 4,096 capacity,
32^2 views, tile 16, list cap 256, chunk 32)::

    python -m dge_tpu_torch.parallel.dryrun --world 4 [--cpu] [--backend gloo]

starts ``--world`` local ranks (``dist.spawn_local``; NCCL on cards, one a
card; ``--backend gloo`` lets several ranks share one card; ``--cpu`` runs
gloo on the CPU) and runs on each:

1. the view-sharded train step (one view a rank) against ``reference_step``,
   the single-rank step that sums the same views (parameters within 1e-4,
   ``denom`` and ``max_radii2d`` equal);
2. the view x tile step (``world / 2`` views x 2 bands, SSIM through the
   halo rows) against ``reference_step`` over those views (loss within
   1e-5, parameters within 1e-4);
3. the sharded edit round (``batch_mode="shard"``, tiny networks, 4 views
   in 2 camera batches) against ``"loop"`` (within 2e-4);
4. the depth-slab train step (parameters, Adam state and ``FitState``
   sharded) against the unsharded train step (loss within 1e-5,
   parameters within 1e-4);
5. capacity growth, densify and a spill-ladder rung (a step at twice the
   list cap) under view sharding against ``reference_step`` (within 1e-4,
   the same rows alive).

Rank 0 prints one line a scenario; any failure raises (exit code not 0).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from dge_tpu_torch.ops import losses as L
from dge_tpu_torch.ops import render as R
from dge_tpu_torch.parallel import dist as D
from dge_tpu_torch.parallel import gauss_shard as GS
from dge_tpu_torch.parallel import mesh as M
from dge_tpu_torch.parallel import shard as S
from dge_tpu_torch.parallel import tile_shard as TS
from dge_tpu_torch.scene import gaussians as G
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.scene.cameras import look_at_camera
from dge_tpu_torch.systems import densify as DS
from dge_tpu_torch.systems import fit as F
from dge_tpu_torch.systems import optim as O

KW = dict(tile_px=16, max_per_tile=256, chunk=32)
PARAM_TOL = 1e-4
LOSS_TOL = 1e-5
EDIT_TOL = 2e-4


def synthetic_scene(n: int, device, sh_degree: int = 1, seed: int = 0):
    """``__graft_entry__._synthetic_scene_and_camera``'s Gaussians (the same
    numpy draws), capacity rounded up to 4,096."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    fdc = rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.5
    k_rest = (sh_degree + 1) ** 2 - 1
    frest = rng.normal(size=(n, k_rest, 3)).astype(np.float32) * 0.1
    opacity = rng.uniform(-1.0, 2.0, size=(n, 1)).astype(np.float32)
    scaling = rng.uniform(-4.5, -3.0, size=(n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return G.from_arrays(xyz, fdc, frest, opacity, scaling, rot,
                         max_sh_degree=sh_degree, device=device)


def ring_cameras(n: int, height: int, width: int, device, dist_: float = 3.0):
    """``n`` cameras on a ring around the origin, looking at it."""
    cams = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        eye = np.array([dist_ * math.sin(ang), 0.3, -dist_ * math.cos(ang)])
        cams.append(CameraArrays.from_camera(
            look_at_camera(eye, np.zeros(3), fovx=math.radians(60),
                           height=height, width=width), device=device))
    return cams


def adam_and_stats(optimizer, scene, opt_state, fit_state, params, offset,
                   loss, visible_views, radii, width, height):
    """Gradients of ``loss`` with respect to ``params`` and ``offset``, then
    the sharded steps' masked Adam update and densification statistics
    (``visible_views`` counts the views that see a Gaussian)."""
    names = list(params)
    g = torch.autograd.grad(loss, [params[k] for k in names] + [offset])
    with torch.no_grad():
        scene, opt_state = S.adam_step(optimizer, scene, opt_state,
                                       dict(zip(names, g[:-1])))
        fit_state = S.accumulate_view_stats(fit_state, g[-1], visible_views,
                                            radii, width, height)
    return scene, opt_state, fit_state


def _leaves(scene):
    params = {k: v.detach().requires_grad_(True)
              for k, v in scene.params().items()}
    offset = torch.zeros(scene.capacity, 2, device=scene.device,
                         requires_grad=True)
    return params, offset


def reference_step(optimizer, scene, opt_state, fit_state, cams, targets, bg,
                   *, lambda_dssim: float = 0.2, backend=None, **render_kw):
    """The single-rank counterpart of the view-sharded step: every view's
    gradients summed, one masked Adam update, ``denom`` counting the views
    that see a Gaussian (the JAX dry run's ``ref_step``). Returns (scene,
    opt_state, fit_state, the loss averaged over the views)."""
    use = F._train_backend(backend, scene.device)
    n_views = int(targets.shape[0])
    params, offset = _leaves(scene)
    total = 0.0
    vis, radii = [], []
    for v in range(n_views):
        out = R.render(scene.with_params(params), M.index_cameras(cams, v),
                       bg, mean2d_offset=offset, backend=use, **render_kw)
        loss = L.l1_loss(out.color, targets[v])
        if lambda_dssim:
            loss = loss + lambda_dssim * (1.0 - L.ssim(out.color, targets[v]))
        total = total + loss
        vis.append(out.visible.float())
        radii.append(torch.where(out.visible, out.radii,
                                 torch.zeros_like(out.radii)))
    out = adam_and_stats(optimizer, scene, opt_state, fit_state, params,
                         offset, total, torch.stack(vis).sum(0),
                         torch.stack(radii).amax(0), cams.width, cams.height)
    return out + (float(total.detach()) / n_views,)


def max_diff(a, b) -> float:
    return max(float((getattr(a, k) - getattr(b, k)).abs().max())
               for k in ("xyz", "features_dc", "opacity", "scaling",
                         "rotation"))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _fresh(scene, device):
    opt = O.make_optimizer(O.OptimConfig.scaled(100))
    return (opt, opt.init(scene.params()),
            F.FitState.create(scene.capacity, device))


def scenarios(device) -> list:
    """The five scenarios on this rank → one line each (the same on every
    rank: the replicas hold the same numbers)."""
    world = D.world_size()
    lines = []
    scene = synthetic_scene(512, device)
    cams = ring_cameras(world, 32, 32, device)
    batch = M.stack_cameras(cams)
    targets = torch.zeros(world, 32, 32, 3, device=device)
    bg = torch.zeros(3, device=device)

    # 1. view-sharded step
    opt, st, fs = _fresh(scene, device)
    mesh = M.make_view_mesh(world)
    step = S.make_sharded_train_step(opt, mesh, **KW)
    s2, st2, fs2, aux = step(scene, st, fs, batch, targets, bg)
    ref = reference_step(opt, scene, *_fresh(scene, device)[1:], batch,
                         targets, bg, **KW)
    loss = float(aux["loss"])
    d_step = max_diff(s2, ref[0])
    moved = float((s2.features_dc - scene.features_dc).abs().max())
    _check(math.isfinite(loss) and moved > 0, f"view step: loss {loss}, "
           f"max|dDC| {moved}")
    _check(abs(loss - ref[3]) < LOSS_TOL and d_step < PARAM_TOL,
           f"view step vs one rank: loss {loss} / {ref[3]}, params {d_step}")
    _check(torch.equal(fs2.denom, ref[2].denom)
           and torch.equal(fs2.max_radii2d, ref[2].max_radii2d),
           "view step vs one rank: denom / max_radii2d")
    lines.append(f"dryrun({world}): view-sharded step loss={loss:.5f} "
                 f"max|dDC|={moved:.2e} vs one rank {d_step:.2e} ok")

    # 2. view x tile (SSIM over halo rows)
    if world >= 2 and world % 2 == 0:
        n_view = world // 2
        sub = M.stack_cameras(cams[:n_view])
        opt2, st_b, fs_b = _fresh(scene, device)
        step2 = TS.make_view_tile_train_step(
            opt2, TS.make_view_tile_mesh(n_view, 2), 32, 32, **KW)
        s3, _, fs3, aux2 = step2(scene, st_b, fs_b, sub, targets[:n_view], bg)
        ref2 = reference_step(opt2, scene, *_fresh(scene, device)[1:], sub,
                              targets[:n_view], bg, **KW)
        loss2 = float(aux2["loss"])
        d2 = max_diff(s3, ref2[0])
        _check(abs(loss2 - ref2[3]) < LOSS_TOL and d2 < PARAM_TOL,
               f"view x tile vs one rank: loss {loss2} / {ref2[3]}, "
               f"params {d2}")
        _check(torch.equal(fs3.denom, ref2[2].denom),
               "view x tile: denom counts views")
        lines.append(f"dryrun({world}): view x tile mesh ({n_view}x2) "
                     f"loss={loss2:.5f} vs one rank {d2:.2e} ok")

    # 3. the sharded edit round against the loop
    err = edit_round_vs_loop(device)
    lines.append(f"dryrun({world}): sharded edit round == loop "
                 f"(max|d|={err:.2e}) ok")

    # 4. depth-slab step, parameters / Adam / FitState sharded
    gmesh = GS.make_gauss_mesh(world)
    opt4, st4, fs4 = _fresh(scene, device)
    gstep = GS.make_depth_slab_train_step(opt4, gmesh, 32, 32, **KW)
    blk, st_blk, fs_blk, aux4 = gstep(
        GS.shard_scene(scene, gmesh),
        GS.shard_rows(st4, scene.capacity, gmesh),
        GS.shard_rows(fs4, scene.capacity, gmesh), cams[0], targets[0], bg)
    whole = GS.gather_scene(blk, gmesh)
    opt5, st5, fs5 = _fresh(scene, device)
    one = F.make_train_step(opt5, lambda_dssim=0.0, **KW)
    s5, _, _, aux5 = one(scene, st5, fs5, cams[0], targets[0], bg)
    loss4 = float(aux4["loss"])
    d4 = max_diff(whole, s5)
    _check(abs(loss4 - float(aux5["loss"])) < LOSS_TOL and d4 < PARAM_TOL,
           f"depth-slab step vs unsharded: loss {loss4} / "
           f"{float(aux5['loss'])}, params {d4}")
    lines.append(f"dryrun({world}): gauss-slab sharded step loss="
                 f"{loss4:.5f} spill={int(aux4['spill'])} vs unsharded "
                 f"{d4:.2e} ok")

    # 5. capacity growth + densify + ladder rung under view sharding
    old_cap, new_cap = s2.capacity, 2 * s2.capacity
    rs, rst, rfs = ref[:3]
    s_g, st_g = (DS.grow_capacity(s2, new_cap),
                 F._pad_opt_state(st2, old_cap, new_cap))
    r_g, rst_g = (DS.grow_capacity(rs, new_cap),
                  F._pad_opt_state(rst, old_cap, new_cap))
    fs_g = F.FitState.create(new_cap, device, step=fs2.step)
    rfs_g = F.FitState.create(new_cap, device, step=rfs.step)
    s_g, st_g, fs_g, aux_g = step(s_g, st_g, fs_g, batch, targets, bg)
    r_g, rst_g, rfs_g, _ = reference_step(opt, r_g, rst_g, rfs_g, batch,
                                          targets, bg, **KW)
    d_grow = max_diff(s_g, r_g)
    dense = dict(max_grad=1e-9, max_densify_percent=1.0, min_opacity=0.005,
                 extent=1.0, max_screen_size=0.0, percent_dense=0.01,
                 generation_num=1)

    def gen():
        return torch.Generator(device=device).manual_seed(7)

    s_d, st_d, fs_d, _ = F.densify_step(s_g, st_g, fs_g, gen(), **dense)
    r_d, rst_d, rfs_d, _ = F.densify_step(r_g, rst_g, rfs_g, gen(), **dense)
    _check(torch.equal(s_d.alive, r_d.alive), "densify: rows alive differ")
    added = s_d.n_alive - s_g.n_alive
    _check(added > 0, "densify added nothing")
    wide = dict(KW, max_per_tile=2 * KW["max_per_tile"])
    s_w, _, _, aux_w = S.make_sharded_train_step(opt, mesh, **wide)(
        s_d, st_d, fs_d, batch, targets, bg)
    r_w = reference_step(opt, r_d, rst_d, rfs_d, batch, targets, bg,
                         **wide)[0]
    d_wide = max_diff(s_w, r_w)
    _check(math.isfinite(float(aux_g["loss"]))
           and math.isfinite(float(aux_w["loss"])), "non-finite loss")
    _check(max(d_grow, d_wide) < PARAM_TOL,
           f"growth / ladder rung vs one rank: {d_grow}, {d_wide}")
    lines.append(f"dryrun({world}): capacity {old_cap}->{new_cap} + "
                 f"densify(+{added}) + ladder rung under view sharding == "
                 f"one rank (max|d|={max(d_step, d_grow, d_wide):.2e}) ok")
    return lines


def edit_round_vs_loop(device) -> float:
    """The ``"shard"`` guidance against ``"loop"``: tiny networks, 4 views at
    32^2 in camera batches of 2, 2 DDIM steps, banded epipolar reuse."""
    from dge_tpu_torch.diffusion import ip2p as P
    from dge_tpu_torch.models.clip_text import CLIPTextConfig
    from dge_tpu_torch.models.unet import UNetConfig
    from dge_tpu_torch.models.vae import VAEConfig
    from dge_tpu_torch.systems.guidance import DGEGuidance, GuidanceConfig

    models = P.build_models(UNetConfig.tiny(), VAEConfig.tiny(),
                            CLIPTextConfig.tiny(), seed=0, device=device)
    b = 4
    cams = M.stack_cameras(ring_cameras(b, 32, 32, device))
    rr = np.random.default_rng(5)
    d = models.unet.config.cross_attention_dim

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)

    rgb, cond = t(rr.uniform(size=(b, 32, 32, 3))), t(
        rr.uniform(size=(b, 32, 32, 3)))
    pos, neg = t(rr.normal(size=(b, 7, d))), t(rr.normal(size=(b, 7, d)))

    def edit(mode):
        g = DGEGuidance(GuidanceConfig(
            camera_batch_size=2, diffusion_steps=2, resize_target=64,
            batch_mode=mode, epipolar_mode="banded"), models)
        return g(rgb, cond, pos, neg, cams,
                 torch.Generator(device=device).manual_seed(3), max_step=400)

    loop, shard = edit("loop"), edit("shard")
    _check(bool(torch.isfinite(shard).all()), "sharded edit: non-finite")
    err = float((loop - shard).abs().max())
    _check(err < EDIT_TOL, f"sharded edit vs loop: {err:.3e}")
    return err


def _rank(device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return scenarios(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: nccl on cards, "
                    "gloo on the CPU)")
    args = ap.parse_args(argv)
    out = D.spawn_local(_rank, args.world,
                        device="cpu" if args.cpu else "cuda",
                        backend=args.backend)
    if any(o != out[0] for o in out):
        raise AssertionError(f"the ranks disagree: {out}")
    for line in out[0]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
