"""Rank functions of the multi-rank tests (tests/test_torch_parallel*.py).

``dist.spawn_local`` starts each rank in a fresh interpreter that imports
this module by name, so it imports only ``dge_tpu_torch`` (never JAX):
inputs come in as an ``.npz`` written by the test from numpy seeds and JAX,
results go back as numpy arrays. Every function runs on every rank of its
world and returns what rank 0 (or every rank) holds.
"""

from __future__ import annotations

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
from dge_tpu_torch.systems import fit as F
from dge_tpu_torch.systems import optim as O
from dge_tpu_torch.systems.fit import FitState

SCENE_KEYS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation", "alive")
CAM_KEYS = ("w2c", "full_proj", "campos", "tan_half_fovx", "tan_half_fovy")
# tests/test_parallel.py's binning: 64^2, tile 16, list cap 128, chunk 16
KW = dict(tile_px=16, max_per_tile=128, chunk=16)
# the saturated scene of tests/test_torch_parallel.py spills nothing at 256
KW_SAT = dict(KW, max_per_tile=256)


def scene_from(z, prefix: str, device="cpu"):
    """A scene carried across as ``{prefix}{leaf}`` arrays."""
    return G.from_numpy_params(
        *(z[prefix + k] for k in SCENE_KEYS),
        active_sh_degree=int(z[prefix + "active"]),
        max_sh_degree=int(z[prefix + "max"]), device=device)


def cams_from(z, prefix: str, device="cpu") -> CameraArrays:
    """A (stacked) CameraArrays carried across as ``{prefix}{leaf}``."""
    return CameraArrays(
        *(torch.from_numpy(np.array(z[prefix + k], np.float32)).to(device)
          for k in CAM_KEYS),
        height=int(z[prefix + "h"]), width=int(z[prefix + "w"]))


def scene_np(scene) -> dict:
    return {k: getattr(scene, k).detach().cpu().numpy()
            for k in SCENE_KEYS[:-1]}


def fit_np(fs: FitState) -> dict:
    return {"grad_accum": fs.grad_accum.cpu().numpy(),
            "denom": fs.denom.cpu().numpy(),
            "max_radii2d": fs.max_radii2d.cpu().numpy()}


def _fresh(scene):
    opt = O.make_optimizer(O.OptimConfig.scaled(100))
    return opt, opt.init(scene.params()), FitState.create(scene.capacity,
                                                          scene.device)


def _step_result(scene, fit_state, aux) -> dict:
    return {"scene": scene_np(scene), "fit": fit_np(fit_state),
            "loss": float(aux["loss"]), "spill": int(aux["spill"])}


def world4(device, path: str) -> dict:
    """Every sharded function of the port on 4 ranks, on the list compositor
    (``"torch_tiles"``, the JAX functions' ``"jnp"``) and on the CPU's own
    default backends."""
    z = np.load(path)
    a, b = scene_from(z, "a_", device), scene_from(z, "b_", device)
    cams4, cams2 = cams_from(z, "c4_", device), cams_from(z, "c2_", device)
    cam = M.index_cameras(cams4, 0)
    t4, t2, t1 = (torch.from_numpy(z[k]).to(device)
                  for k in ("t4", "t2", "t1"))
    bg = torch.zeros(3, device=device)
    bg_slab = torch.from_numpy(z["bg_slab"]).to(device)
    out = {}

    # renders: tile bands, gauss x tile, depth slabs, view-sharded
    tmesh = TS.make_tile_mesh(4)
    for be in ("torch_tiles", None):
        fn = TS.make_tile_sharded_render(tmesh, 64, 64, backend=be, **KW)
        out[f"tile_render_{be}"] = [x.numpy() for x in fn(a, cam, bg)]
    gt = TS.make_gauss_tile_mesh(2, 2)
    fn = TS.make_gauss_tile_render(gt, 64, 64, backend="torch_tiles", **KW)
    out["gauss_tile_render"] = [x.numpy() for x in fn(
        GS.shard_scene(a, gt), cam, bg)]
    gm = GS.make_gauss_mesh(4)
    fn = GS.make_depth_slab_render(gm, 64, 64, backend="torch_tiles", **KW)
    out["slab_render"] = [x.numpy() for x in fn(
        GS.shard_scene(b, gm), cam, bg_slab)]
    out["preprocess"] = [x.numpy() for x in GS.sharded_preprocess(
        gm, GS.shard_scene(b, gm), cam)]
    vm = M.make_view_mesh(4)
    fn = S.make_sharded_render(vm, backend="torch_tiles", **KW)
    out["sharded_render"] = [x.numpy() for x in fn(a, cams4, bg)]

    # train steps
    for be in ("torch_tiles", None):
        opt, st, fs = _fresh(a)
        step = S.make_sharded_train_step(opt, vm, backend=be, **KW)
        out[f"view_step_{be}"] = _step_result(*_pick(step(a, st, fs, cams4,
                                                          t4, bg)))
        opt, st, fs = _fresh(a)
        vt = TS.make_view_tile_mesh(2, 2)
        step = TS.make_view_tile_train_step(opt, vt, 64, 64, backend=be,
                                            **KW)
        out[f"view_tile_step_{be}"] = _step_result(*_pick(step(
            a, st, fs, cams2, t2, bg)))
        opt, st, fs = _fresh(b)
        step = GS.make_depth_slab_train_step(opt, gm, 64, 64, backend=be,
                                             **KW)
        sb, _, fb, aux = step(GS.shard_scene(b, gm),
                              GS.shard_rows(st, b.capacity, gm),
                              GS.shard_rows(fs, b.capacity, gm), cam, t1, bg)
        out[f"slab_step_{be}"] = _step_result(
            GS.gather_scene(sb, gm), GS.gather_rows(fb, gm), aux)

    # the saturated scene: the band step and render on the pair-stream
    # backend against the whole image's, the depth-slab step against the
    # unsharded step
    sat = scene_from(z, "s_", device)
    opt, st, fs = _fresh(sat)
    res = S.make_sharded_train_step(opt, vt, **KW_SAT)(sat, st, fs, cams2,
                                                       t2, bg)
    out["sat_view_step"] = dict(_moment_result(*res[:2], res[3]),
                                fit=fit_np(res[2]))
    opt, st, fs = _fresh(sat)
    res = TS.make_view_tile_train_step(opt, vt, 64, 64, **KW_SAT)(
        sat, st, fs, cams2, t2, bg)
    out["sat_view_tile_step"] = dict(_moment_result(*res[:2], res[3]),
                                     fit=fit_np(res[2]))
    fn = TS.make_tile_sharded_render(tmesh, 64, 64, backend="torch",
                                     **KW_SAT)
    out["sat_tile_render_torch"] = [x.numpy() for x in fn(sat, cam, bg)]
    opt, st, fs = _fresh(sat)
    res = F.make_train_step(opt, lambda_dssim=0.0, **KW_SAT)(
        sat, st, fs, cam, t1, bg)
    out["sat_unsharded_step"] = _moment_result(*res[:2], res[3])
    opt, st, fs = _fresh(sat)
    sb, stb, _, aux = GS.make_depth_slab_train_step(opt, gm, 64, 64,
                                                    **KW_SAT)(
        GS.shard_scene(sat, gm), GS.shard_rows(st, sat.capacity, gm),
        GS.shard_rows(fs, sat.capacity, gm), cam, t1, bg)
    out["sat_slab_step"] = _moment_result(GS.gather_scene(sb, gm),
                                          GS.gather_rows(stb, gm), aux)

    out["ssim_halo"] = _ssim_halo(torch.from_numpy(z["img"]).to(device),
                                  torch.from_numpy(z["tgt"]).to(device))
    x = torch.from_numpy(z["gx"][D.rank()]).to(device).requires_grad_(True)
    y = D.all_gather_cat(x)
    (y * torch.from_numpy(z["gw"][D.rank()]).to(device)).sum().backward()
    out["gather_grad"] = D.all_gather_cat(x.grad).numpy()
    m = torch.from_numpy(z["gx"][D.rank(), 0]).to(device)
    out["max"] = D.all_reduce_max(m).numpy()
    return out


def fails_on_rank_1(device):
    if D.rank() == 1:
        raise RuntimeError("rank 1 gives up")
    return 0


def _pick(res):
    """(scene, opt, fit, aux) → (scene, fit, aux)."""
    return res[0], res[2], res[3]


def _ssim_halo(img, tgt):
    """``1 - SSIM`` of ``img`` against ``tgt`` from 4 bands of 16 rows, each
    extended by the halo rows of its neighbours → (loss, gradient of the
    whole image gathered from the bands)."""
    n, pad = D.world_size(), 5
    band = img.shape[0] // n
    y0 = D.rank() * band
    x = img[y0:y0 + band].clone().requires_grad_(True)
    xh = D.halo_rows(x, None, pad)
    t = torch.nn.functional.pad(tgt, (0, 0, 0, 0, pad, pad))
    smap = L.ssim_map(xh, t[y0:y0 + band + 2 * pad])
    loss = (1.0 - smap[pad:pad + band].mean()) / n
    loss.backward()
    return (float(D.all_reduce_sum(loss.detach())),
            D.all_gather_cat(x.grad).numpy())


def world2_edit(device, path: str, weights: str, replay: bool) -> dict:
    """One guidance call in ``"shard"`` mode on 2 ranks with the tiny
    networks (the test's weights), and, with ``replay``, the JAX draws and
    cross-view states of the npz handed over; without it the port's own
    draws from seed 3, and the same call in ``"vmap"`` mode on this rank."""
    from dge_tpu_torch.diffusion import ip2p as P
    from dge_tpu_torch.models.clip_text import CLIPTextConfig
    from dge_tpu_torch.models.unet import UNetConfig
    from dge_tpu_torch.models.vae import VAEConfig
    from dge_tpu_torch.systems import guidance as TG

    z = np.load(path)
    models = P.build_models(UNetConfig.tiny(), VAEConfig.tiny(),
                            CLIPTextConfig.tiny(),
                            params=torch.load(weights), device=device)
    inputs = [torch.from_numpy(z[k]).to(device)
              for k in ("rgb", "cond", "pos", "neg")]
    cams = cams_from(z, "c4_", device)
    if replay:
        _replay(z, P, TG)

    def call(mode):
        g = TG.DGEGuidance(TG.GuidanceConfig(
            camera_batch_size=2, diffusion_steps=2, resize_target=64,
            batch_mode=mode), models)
        return g(*inputs, cams, torch.Generator().manual_seed(3),
                 max_step=400).numpy()

    out = {"shard": call("shard")}
    if not replay:
        out["vmap"] = call("vmap")
    return out


def _replay(z, P, TG):
    """The port's draw helpers and cross-view state replay the JAX ones of
    the npz: ``normal_{i}`` in order, ``offsets_{j}`` per pivot step, and
    the state of (pivot step j, camera batch i) as ``cv_{j}_{i}_*``."""
    from dge_tpu_torch.models.layers import CrossViewState

    normals = [z[f"normal_{i}"] for i in range(int(z["n_normals"]))]
    n_steps = int(z["n_offsets"])
    offsets = [z[f"offsets_{j}"] for j in range(n_steps)]
    centres = z["c4_campos"]
    step = {"j": -1}

    def normal(shape, generator):
        x = normals.pop(0)
        assert tuple(shape) == x.shape, (shape, x.shape)
        return torch.from_numpy(x.copy())

    def pivot_offsets(n, cbs, generator):
        step["j"] += 1
        return offsets[step["j"]]

    def state(cams_b, key_cams, pivot, lh, lw, n_key, thr, mode):
        first = int(np.abs(centres - cams_b.campos[0].numpy()).sum(1)
                    .argmin())
        p = f"cv_{step['j']}_{first // 2}_"
        sizes = [int(s) for s in z[p + "sizes"]]
        return CrossViewState(
            closest_cam=torch.from_numpy(z[p + "closest"]).long(),
            blend_w1=torch.from_numpy(z[p + "blend"]),
            epi_lines={s: torch.from_numpy(z[f"{p}lines_{s}"])
                       for s in sizes},
            epi_pts={s: torch.from_numpy(z[f"{p}pts_{s}"]) for s in sizes},
            n_key=n_key, epi_threshold=thr)

    P._normal = normal
    TG._pivot_offsets = pivot_offsets
    TG.make_cross_view_state = state


def _moment_result(scene, opt_state, aux) -> dict:
    """Parameters, gradients (Adam's first moment after one step from a
    fresh state is (1 - b1)·g), loss and spill of one step."""
    return {"params": scene_np(scene),
            "grads": {k: st["mu"].cpu().numpy() / (1.0 - O.B1)
                      for k, st in opt_state.items()},
            "loss": float(aux["loss"]), "spill": int(aux["spill"])}


def decomposition(device, ply: str, capture: str, views, size: int,
                  tile_px: int) -> dict:
    """The band and depth-slab steps and their whole-image steps on a
    trained scene (tests/decomposition_reading.py), on 4 ranks: the
    view-sharded and the view x tile steps on one 2 x 2 mesh (the first
    along its ``view`` axis), the unsharded step of the first view, the
    4-slab step. The plain CPU backends, caps grown until nothing spills."""
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.utils import saving

    torch.set_num_threads(2)
    scene = G.load_ply(ply, device=device)
    cs = DS.ColmapScene(capture, height=size, width=size)
    cams = [CameraArrays.from_camera(cs.cameras[v], device=device)
            for v in views]
    targets = torch.stack([torch.from_numpy(saving.load_image(
        f"{capture}/images/{cs.cameras[v].image_name}.png"))
        for v in views]).to(device)
    bg = torch.zeros(3, device=device)
    r = R.SpillFreeRenderer(scene, bg, tile_px=tile_px)
    for cam in cams:
        if r.probe(cam):
            raise AssertionError("spill at the ceilings")
    caps = dict(r.caps, tile_px=tile_px, tight_cull=r.tight_cull)
    batch = M.stack_cameras(cams)
    out = {}
    # both meshes first: building one waits for every rank, and a rank
    # still in a step would keep the others waiting past the groups' timeout
    mesh = TS.make_view_tile_mesh(2, 2)
    gm = GS.make_gauss_mesh(4)
    opt, st, fs = _fresh(scene)
    s, st, _, aux = S.make_sharded_train_step(opt, mesh, **caps)(
        scene, st, fs, batch, targets, bg)
    out["views"] = _moment_result(s, st, aux)
    opt, st, fs = _fresh(scene)
    s, st, _, aux = TS.make_view_tile_train_step(opt, mesh, size, size,
                                                 **caps)(
        scene, st, fs, batch, targets, bg)
    out["view_tile"] = _moment_result(s, st, aux)
    opt, st, fs = _fresh(scene)
    s, st, _, aux = F.make_train_step(opt, lambda_dssim=0.0, **caps)(
        scene, st, fs, cams[0], targets[0], bg)
    out["whole"] = _moment_result(s, st, aux)
    opt, st, fs = _fresh(scene)
    sb, stb, _, aux = GS.make_depth_slab_train_step(opt, gm, size, size,
                                                    **caps)(
        GS.shard_scene(scene, gm), GS.shard_rows(st, scene.capacity, gm),
        GS.shard_rows(fs, scene.capacity, gm), cams[0], targets[0], bg)
    out["slabs"] = _moment_result(GS.gather_scene(sb, gm),
                                  GS.gather_rows(stb, gm), aux)
    return out
