"""Synthesise the anisotropic bench capture: a procedural ground-truth
scene, 24 ring cameras at 512², their renders, a noised SfM point init and a
COLMAP model, ready for ``launch --fit``.

JAX counterpart: ``tools/make_bench_capture.py``, whose capture the
committed ``outputs/bench_scene/point_cloud.ply`` was fitted from. The
scene builders, the cameras, the point init, ``cfg.yaml`` and the COLMAP
files are that tool's numpy arithmetic, copied: from the same ``--seed``
both tools write the same ground truth and the same COLMAP files byte for
byte, and images within one level of 255 (the renderers differ in
rounding). What it builds:

1. a ground-truth scene of surface-aligned Gaussians: ``--style aniso``
   (~140k: a textured floor disk, striped spheres and a torus; flat disks
   of aspect 10-20 with high-frequency colour, so a fit keeps and sharpens
   the anisotropy) or ``--style hi_aniso`` (grass blades, wires and twigs,
   p90 aspect above 150);
2. ``--views`` ring cameras at ``--size``², rendered through the
   spill-free ladder (``ops/render.SpillFreeRenderer``, tile 32; on a card
   the pair-stream kernel K1) and saved as ``images/view_NN.png``;
3. ``sparse/0/{cameras,images,points3D}.bin`` (a noised subsample of the
   ground-truth centres as the point init), ``cfg.yaml`` (SH degree 0,
   6,000 steps) and ``gt_scene.ply``.

One departure: the JAX tool probes the caps on view 0 and asserts that
every view renders spill-free at them; this tool grows the caps per view
(``SpillFreeRenderer.__call__``) and asserts that no view spills after its
ladder. ``cfg.yaml`` names the trial ``gpu`` where the JAX tool's says
``tpu``. Runs on the card unless ``--cpu`` is given (the plain version of
the compositor).

Usage:
  python -m dge_tpu_torch.tools.make_bench_capture [--out DIR] \
      [--style aniso|hi_aniso] [--views 24] [--size 512] [--cpu]
  python -m dge_tpu_torch.launch --fit --source DIR --config DIR/cfg.yaml \
      --out outputs/bench_scene_fit
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, NamedTuple

import numpy as np


class CaptureRun(NamedTuple):
    out: str  # the capture directory
    n_gaussians: int  # of the ground-truth scene
    spills: List[int]  # per view, after its ladder (all 0)
    caps: dict  # the renderer's caps at the end
    launches: dict  # kernel launches of the renders
    seconds: float  # host seconds of the renders


def _gt_arrays(xyz, col, scaling, quat, opac) -> Dict[str, np.ndarray]:
    """The ground truth's arrays: centres, colours, log scales, wxyz
    quaternions, opacity logits and SH degree-0 features."""
    fdc = ((col - 0.5) / 0.28209479177387814)[:, None, :]
    return dict(xyz=xyz, col=col, scaling=scaling, quat=quat, opac=opac,
                fdc=fdc, frest=np.zeros((len(xyz), 0, 3), np.float32))


def gt_scene(gt: Dict[str, np.ndarray], device="cuda"):
    """The ground truth as a ``GaussianScene`` (SH degree 0) on ``device``."""
    from dge_tpu_torch.scene import gaussians as G

    return G.from_arrays(gt["xyz"], gt["fdc"], gt["frest"], gt["opac"],
                         gt["scaling"], gt["quat"], max_sh_degree=0,
                         device=device)


def _basis_from_normal(n):
    """[N,3] normals -> [N,3,3] rotation matrices with column 2 = normal."""
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    helper = np.where(
        np.abs(n[:, 2:3]) < 0.9,
        np.tile(np.array([0.0, 0.0, 1.0], np.float32), (len(n), 1)),
        np.tile(np.array([1.0, 0.0, 0.0], np.float32), (len(n), 1)),
    )
    t1 = np.cross(helper, n)
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(n, t1)
    return np.stack([t1, t2, n], axis=2).astype(np.float32)


def _rot_to_quat(R):
    """[N,3,3] -> [N,4] wxyz quaternions (vectorized Shepperd)."""
    w = np.sqrt(np.maximum(0, 1 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2])) / 2
    x = np.sqrt(np.maximum(0, 1 + R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2])) / 2
    y = np.sqrt(np.maximum(0, 1 - R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2])) / 2
    z = np.sqrt(np.maximum(0, 1 - R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2])) / 2
    x = np.copysign(x, R[:, 2, 1] - R[:, 1, 2])
    y = np.copysign(y, R[:, 0, 2] - R[:, 2, 0])
    z = np.copysign(z, R[:, 1, 0] - R[:, 0, 1])
    q = np.stack([w, x, y, z], axis=1).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _surface_patch(rng, pts, normals, color, in_scale=(0.012, 0.035),
                   n_scale=0.002, opacity=(1.5, 4.0)):
    n = len(pts)
    R = _basis_from_normal(normals)
    quat = _rot_to_quat(R)
    s1 = rng.uniform(*in_scale, size=(n, 1))
    s2 = s1 * rng.uniform(0.5, 2.0, size=(n, 1))  # elongated in-plane
    scaling = np.log(
        np.concatenate([s1, s2, np.full((n, 1), n_scale)], axis=1)
    ).astype(np.float32)
    opac = rng.uniform(*opacity, size=(n, 1)).astype(np.float32)
    return pts.astype(np.float32), color.astype(np.float32), scaling, quat, opac


def _needle_patch(rng, pts, dirs, color, length, width_rng=(0.002, 0.004),
                  opacity=(1.5, 4.0)):
    """Extremely elongated Gaussians along ``dirs`` (aspect ~50-250):
    grass blades / wires / twigs. ``length`` is (lo, hi) in world units;
    width sits at the EWA low-pass floor (~0.3-0.6 px at the 512^2 ring
    distance) so the render shows 1-px filaments and a fit has to keep
    the anisotropy to match them."""
    n = len(pts)
    R = _basis_from_normal(dirs)  # column 2 = needle direction
    quat = _rot_to_quat(R)
    L = rng.uniform(*length, size=(n, 1))
    w1 = rng.uniform(*width_rng, size=(n, 1))
    w2 = w1 * rng.uniform(0.8, 1.3, size=(n, 1))
    scaling = np.log(
        np.concatenate([w1, w2, L], axis=1)
    ).astype(np.float32)
    opac = rng.uniform(*opacity, size=(n, 1)).astype(np.float32)
    return (pts.astype(np.float32), color.astype(np.float32), scaling,
            quat, opac)


def build_gt_scene_hi_aniso(seed=0):
    """Needle/wire/foliage GT scene: p90 scale-aspect >= 150 by
    construction, the regime of strongly anisotropic trained scenes that
    the ``aniso`` style (p90 ~24) does not reach."""
    rng = np.random.default_rng(seed)
    parts = []

    # sparse dark floor so the filaments dominate the pixel budget
    n_f = 36_000
    r = 2.4 * np.sqrt(rng.uniform(size=n_f))
    th = rng.uniform(0, 2 * math.pi, size=n_f)
    x, z = r * np.cos(th), r * np.sin(th)
    pts = np.stack([x, np.full(n_f, -1.0) + rng.normal(0, 0.003, n_f), z], 1)
    base = np.array([[0.18, 0.16, 0.13]])
    col = np.clip(base + rng.normal(0, 0.04, (n_f, 3)), 0, 1)
    normals = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n_f, 1))
    normals += rng.normal(0, 0.02, (n_f, 3))
    parts.append(_surface_patch(rng, pts, normals, col,
                                in_scale=(0.015, 0.04)))

    # grass field: one long Gaussian per blade, tilted mostly upward
    n_b = 58_000
    r = 2.2 * np.sqrt(rng.uniform(size=n_b))
    th = rng.uniform(0, 2 * math.pi, size=n_b)
    bx, bz = r * np.cos(th), r * np.sin(th)
    L = rng.uniform(0.22, 0.5, size=n_b)
    dirs = np.stack([rng.normal(0, 0.35, n_b),
                     np.ones(n_b),
                     rng.normal(0, 0.35, n_b)], 1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = np.stack([bx, np.full(n_b, -1.0), bz], 1) + dirs * (L / 2)[:, None]
    green = np.stack([rng.uniform(0.1, 0.35, n_b),
                      rng.uniform(0.45, 0.85, n_b),
                      rng.uniform(0.1, 0.3, n_b)], 1)
    parts.append(_needle_patch(rng, pts, dirs, green,
                               length=(0.15, 0.4),
                               width_rng=(0.0012, 0.0025)))

    # hanging wires: catenaries between 4 pole pairs, chained segments
    for k in range(4):
        a = np.array([2.0 * math.cos(k * math.pi / 2 + 0.4), 0.9,
                      2.0 * math.sin(k * math.pi / 2 + 0.4)])
        b = np.array([2.0 * math.cos((k + 1.3) * math.pi / 2), 1.1,
                      2.0 * math.sin((k + 1.3) * math.pi / 2)])
        n_s = 1_600
        t = np.linspace(0, 1, n_s)
        sag = 0.65 * np.sin(math.pi * t) ** 1.2
        p = a[None, :] * (1 - t)[:, None] + b[None, :] * t[:, None]
        p[:, 1] -= sag
        d = np.gradient(p, axis=0)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        seg = np.linalg.norm(b - a) / n_s * 3.0
        col = np.tile(np.array([[0.85, 0.8, 0.55]]), (n_s, 1)) \
            + rng.normal(0, 0.03, (n_s, 3))
        parts.append(_needle_patch(
            rng, p + rng.normal(0, 0.001, p.shape), d, np.clip(col, 0, 1),
            length=(seg * 0.9, seg * 1.4), width_rng=(0.0018, 0.003),
            opacity=(3.0, 5.0)))

    # twiggy shrubs: random-walk branch segments
    for cx, cz, hgt, c in [(-0.9, 0.4, 1.0, [0.45, 0.3, 0.2]),
                           (0.8, -0.7, 0.8, [0.5, 0.35, 0.22]),
                           (0.1, 1.0, 0.9, [0.4, 0.28, 0.18])]:
        n_t = 5_000
        t = rng.uniform(0, 1, n_t)
        ang = rng.uniform(0, 2 * math.pi, n_t)
        rad = 0.45 * t * (1 + 0.3 * rng.normal(size=n_t))
        pts = np.stack([cx + rad * np.cos(ang),
                        -1.0 + hgt * t,
                        cz + rad * np.sin(ang)], 1)
        dirs = np.stack([np.cos(ang) * 0.6 + rng.normal(0, 0.3, n_t),
                         np.ones(n_t) * 0.9,
                         np.sin(ang) * 0.6 + rng.normal(0, 0.3, n_t)], 1)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        col = np.clip(np.array([c]) + rng.normal(0, 0.05, (n_t, 3)), 0, 1)
        parts.append(_needle_patch(rng, pts, dirs, col,
                                   length=(0.12, 0.28),
                                   width_rng=(0.0015, 0.003)))

    xyz = np.concatenate([p[0] for p in parts])
    col = np.concatenate([p[1] for p in parts])
    scaling = np.concatenate([p[2] for p in parts])
    quat = np.concatenate([p[3] for p in parts])
    opac = np.concatenate([p[4] for p in parts])
    sc = np.exp(scaling)
    asp = np.sort(sc, axis=1)
    aspect = asp[:, 2] / asp[:, 0]
    print(f"GT hi-aniso aspect: p50={np.percentile(aspect, 50):.0f} "
          f"p90={np.percentile(aspect, 90):.0f} "
          f"p99={np.percentile(aspect, 99):.0f}", flush=True)
    return _gt_arrays(xyz, col, scaling, quat, opac)


def build_gt_scene(seed=0):
    rng = np.random.default_rng(seed)
    parts = []

    # textured floor disk (y=-1, radius 2.2): checker + noise
    n_f = 62_000
    r = 2.2 * np.sqrt(rng.uniform(size=n_f))
    th = rng.uniform(0, 2 * math.pi, size=n_f)
    x, z = r * np.cos(th), r * np.sin(th)
    pts = np.stack([x, np.full(n_f, -1.0) + rng.normal(0, 0.003, n_f), z], 1)
    checker = ((np.floor(x * 4) + np.floor(z * 4)) % 2)[:, None]
    base = np.array([[0.72, 0.62, 0.45]]) * checker \
        + np.array([[0.25, 0.30, 0.38]]) * (1 - checker)
    col = np.clip(base + rng.normal(0, 0.08, (n_f, 3)), 0, 1)
    normals = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n_f, 1))
    normals += rng.normal(0, 0.02, (n_f, 3))
    parts.append(_surface_patch(rng, pts, normals, col))

    # striped spheres
    spheres = [
        ((-0.8, -0.55, 0.3), 0.45, [0.85, 0.25, 0.2], [0.95, 0.9, 0.75]),
        ((0.7, -0.62, -0.5), 0.38, [0.2, 0.45, 0.8], [0.9, 0.85, 0.3]),
        ((0.2, -0.7, 0.9), 0.30, [0.2, 0.65, 0.35], [0.95, 0.95, 0.95]),
        ((-0.3, -0.75, -0.9), 0.25, [0.6, 0.3, 0.7], [0.2, 0.2, 0.25]),
    ]
    for (cx, cy, cz), rad, c1, c2 in spheres:
        n_s = 16_000
        v = rng.normal(size=(n_s, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts = np.array([cx, cy, cz]) + rad * v
        stripes = ((np.floor((v[:, 1] + 1) * 8) % 2))[:, None]
        col = np.clip(
            np.array([c1]) * stripes + np.array([c2]) * (1 - stripes)
            + rng.normal(0, 0.05, (n_s, 3)), 0, 1,
        )
        parts.append(_surface_patch(
            rng, pts, v.copy(), col, in_scale=(0.008, 0.022), n_scale=0.0015))

    # torus (major 0.55, minor 0.16) at the back
    n_t = 18_000
    u = rng.uniform(0, 2 * math.pi, n_t)
    w = rng.uniform(0, 2 * math.pi, n_t)
    cx, cy, cz = 0.9, -0.25, 0.75
    major, minor = 0.55, 0.16
    ring = np.stack([np.cos(u), np.zeros(n_t), np.sin(u)], 1)
    nrm = (np.cos(w)[:, None] * ring
           + np.sin(w)[:, None] * np.array([[0.0, 1.0, 0.0]]))
    pts = np.array([cx, cy, cz]) + major * ring + minor * nrm
    swirl = ((np.floor((u * 6 + w * 2) / math.pi) % 2))[:, None]
    col = np.clip(
        np.array([[0.95, 0.55, 0.15]]) * swirl
        + np.array([[0.3, 0.25, 0.5]]) * (1 - swirl)
        + rng.normal(0, 0.05, (n_t, 3)), 0, 1,
    )
    parts.append(_surface_patch(
        rng, pts, nrm, col, in_scale=(0.008, 0.02), n_scale=0.0015))

    xyz = np.concatenate([p[0] for p in parts])
    col = np.concatenate([p[1] for p in parts])
    scaling = np.concatenate([p[2] for p in parts])
    quat = np.concatenate([p[3] for p in parts])
    opac = np.concatenate([p[4] for p in parts])
    return _gt_arrays(xyz, col, scaling, quat, opac)


def ring_cameras(n_views=24, h=512, w=512):
    from dge_tpu_torch.scene.cameras import look_at_camera

    cams = []
    for i in range(n_views):
        ang = 2 * math.pi * i / n_views
        ey = 0.35 + 0.55 * (0.5 + 0.5 * math.sin(3 * ang))
        eye = np.array([3.3 * math.sin(ang), ey, -3.3 * math.cos(ang)])
        cams.append(look_at_camera(
            eye, np.array([0.0, -0.45, 0.0]), fovx=math.radians(60),
            height=h, width=w,
        ))
    return cams


def write_colmap(cams, h: int, w: int, sparse: str) -> None:
    """cameras.bin (one PINHOLE camera, 60° FoV) and images.bin (one image
    a view, ``view_NN.png``)."""
    from dge_tpu_torch.scene import colmap as CM
    from dge_tpu_torch.scene.cameras import rotmat2qvec

    focal = (w / 2) / math.tan(math.radians(60) / 2)
    colmap_cams = {1: CM.ColmapCamera(
        1, "PINHOLE", w, h, np.array([focal, focal, w / 2, h / 2]))}
    colmap_images = {
        i + 1: CM.ColmapImage(i + 1, rotmat2qvec(cam.R.T), cam.T, 1,
                              f"view_{i:02d}.png")
        for i, cam in enumerate(cams)}
    CM.write_cameras_binary(colmap_cams, os.path.join(sparse, "cameras.bin"))
    CM.write_images_binary(colmap_images, os.path.join(sparse, "images.bin"))


def write_point_init(gt, init_points: int, seed: int, sparse: str) -> None:
    """points3D.bin: ``init_points`` ground-truth centres drawn without
    replacement, each moved by N(0, 0.01), with their colours."""
    from dge_tpu_torch.scene import colmap as CM

    xyz, col = gt["xyz"], gt["col"]
    rng = np.random.default_rng(seed + 1)
    idx = rng.choice(len(xyz), size=min(init_points, len(xyz)),
                     replace=False)
    pts = xyz[idx] + rng.normal(0, 0.01, (len(idx), 3))
    CM.write_points3d_binary(pts.astype(np.float32),
                             col[idx].astype(np.float32),
                             os.path.join(sparse, "points3D.bin"))


def main(argv=None) -> CaptureRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="bench_capture")
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--init_points", type=int, default=60_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--style", choices=["aniso", "hi_aniso"],
                    default="aniso",
                    help="aniso: surface disks (p90 aspect ~20); hi_aniso: "
                         "needle/wire/foliage filaments (p90 aspect >150)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the plain compositor)")
    args = ap.parse_args(argv)

    import torch

    from dge_tpu_torch import resolve_device
    from dge_tpu_torch.ops.cuda_build import launch_counts
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.utils import saving

    device = resolve_device("cpu" if args.cpu else "cuda")
    h = w = args.size
    builder = (build_gt_scene_hi_aniso if args.style == "hi_aniso"
               else build_gt_scene)
    gt = builder(args.seed)
    scene = gt_scene(gt, device)
    print(f"GT scene: {int(scene.n_alive)} gaussians", flush=True)
    cams = ring_cameras(args.views, h, w)

    out = os.path.abspath(args.out)
    sparse = os.path.join(out, "sparse", "0")
    images_dir = os.path.join(out, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)

    # the JAX tool's starting caps; the ladder grows them per view
    renderer = R.SpillFreeRenderer(
        scene, torch.zeros(3, device=device), tile_px=32, max_per_tile=4096,
        max_tiles_per_gaussian=32, small_slots=4, max_pairs=1 << 20,
        big_capacity=8192, log=lambda m: print(m, flush=True))
    before = dict(launch_counts)
    t0 = time.time()
    spills = []
    for i, cam in enumerate(cams):
        ca = CameraArrays.from_camera(cam, device=device)
        if i == 0:
            renderer.probe(ca)
        img, sp = renderer(ca)
        assert sp == 0, f"view {i} still spills {sp} pairs"
        spills.append(sp)
        saving.save_image(os.path.join(images_dir, f"view_{i:02d}.png"),
                          img.cpu().numpy())
        print(f"rendered view {i}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {k: v - before[k] for k, v in launch_counts.items()}
    write_colmap(cams, h, w, sparse)
    write_point_init(gt, args.init_points, args.seed, sparse)

    with open(os.path.join(out, "cfg.yaml"), "w") as f:
        f.write(
            f"name: benchscene_{args.style}\ntag: gpu\ndata:\n"
            f"  height: {h}\n  width: {w}\nsystem:\n  sh_degree: 0\n"
            "trainer:\n  max_steps: 6000\n"
        )
    G.save_ply(scene, os.path.join(out, "gt_scene.ply"))
    print(f"capture written to {out}", flush=True)
    print(f"fit with: python -m dge_tpu_torch.launch --fit --source {out} "
          f"--config {out}/cfg.yaml --out outputs/bench_scene_fit")
    return CaptureRun(out, int(scene.n_alive), spills, renderer.caps,
                      launches, seconds)


if __name__ == "__main__":
    main()
