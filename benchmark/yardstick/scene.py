"""The benchmark's scene and cameras, made from a seed in numpy.

The ground-truth scene is a copy of the "aniso" generator of
``dge_tpu_torch/tools/make_bench_capture.py`` (a textured floor disk, four
striped spheres and a torus of surface-aligned flat Gaussians, 144,000 in
all), with seeded higher spherical-harmonic bands added, so that colour is
view dependent at SH degree 3. The cameras are plain pinhole matrices in the
column-vector convention of the upstream 3DGS scene layer
(``getWorld2View2``, ``getProjectionMatrix``). Nothing here imports the
program: the benchmark hands the same arrays to the program and to the plain
reference.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

SH_C0 = 0.28209479177387814
SCENE_TARGET = np.array([0.0, -0.45, 0.0])


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


def aniso_parts(seed: int, scale: float = 1.0):
    """The "aniso" ground truth (make_bench_capture.build_gt_scene) with
    every part's count multiplied by ``scale`` (1.0: 144,000 Gaussians;
    the CPU tests use a small fraction). Returns (xyz, col, scaling, quat,
    opacity logits)."""
    rng = np.random.default_rng(seed)
    parts = []

    def count(n):
        return max(8, int(round(n * scale)))

    # textured floor disk (y=-1, radius 2.2): checker + noise
    n_f = count(62_000)
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
        n_s = count(16_000)
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
    n_t = count(18_000)
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
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(5))


def gt_scene(seed: int, sh_degree: int = 3, sh_rest_std: float = 0.04,
             scale: float = 1.0) -> Dict[str, np.ndarray]:
    """The ground truth as raw 3DGS parameters (f32): ``xyz`` [N,3],
    ``features_dc`` [N,1,3], ``features_rest`` [N,K-1,3] (seeded higher
    bands, normal of std ``sh_rest_std`` over the band index), ``opacity``
    [N,1] logits, ``scaling`` [N,3] log scales, ``rotation`` [N,4] wxyz."""
    xyz, col, scaling, quat, opac = aniso_parts(seed, scale)
    n = len(xyz)
    k = (sh_degree + 1) ** 2 - 1
    rng = np.random.default_rng([seed, 1])
    band = np.floor(np.sqrt(np.arange(1, k + 1))).astype(np.float32)
    rest = rng.normal(0.0, 1.0, (n, k, 3)) * (sh_rest_std / band)[None, :,
                                                                   None]
    return dict(
        xyz=xyz.astype(np.float32),
        features_dc=((col - 0.5) / SH_C0)[:, None, :].astype(np.float32),
        features_rest=rest.astype(np.float32),
        opacity=opac.astype(np.float32),
        scaling=scaling.astype(np.float32),
        rotation=quat.astype(np.float32),
    )


# ---- cameras (column-vector convention, upstream graphics_utils.py) ----

def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """getProjectionMatrix (graphics_utils.py:67-87)."""
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 1.0 / math.tan(fovx / 2.0)
    P[1, 1] = 1.0 / math.tan(fovy / 2.0)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def look_at(eye, target, height: int, width: int,
            fovx: float = math.radians(60.0)) -> Dict[str, object]:
    """A pinhole camera from ``eye`` to ``target`` (+z forward, y down):
    ``w2c`` and ``full_proj`` [4,4] f32, ``campos`` [3], the half-angle
    tangents and the size."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rw2c = np.stack([right, down, fwd], axis=0)
    w2c = np.eye(4)
    w2c[:3, :3] = rw2c
    w2c[:3, 3] = -rw2c @ eye
    w2c = w2c.astype(np.float32)
    focal = width / (2.0 * math.tan(fovx / 2.0))
    fovy = 2.0 * math.atan(height / (2.0 * focal))
    full = (projection_matrix(0.01, 100.0, fovx, fovy)
            @ w2c.astype(np.float64)).astype(np.float32)
    campos = np.linalg.inv(w2c.astype(np.float64))[:3, 3].astype(np.float32)
    return dict(w2c=w2c, full_proj=full, campos=campos,
                tan_half_fovx=math.tan(fovx / 2.0),
                tan_half_fovy=math.tan(fovy / 2.0),
                height=int(height), width=int(width))


def orbit_cameras(n: int, height: int, width: int, radius: float = 3.3,
                  fovx: float = math.radians(60.0)) -> List[dict]:
    """``n`` fixed poses of a closed orbit whose height rises and falls
    three times a turn (make_bench_capture.ring_cameras' path)."""
    cams = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        ey = 0.35 + 0.55 * (0.5 + 0.5 * math.sin(3 * ang))
        eye = np.array([radius * math.sin(ang), ey, -radius * math.cos(ang)])
        cams.append(look_at(eye, SCENE_TARGET, height, width, fovx))
    return cams


def cameras_extent(cams: List[dict]) -> float:
    """getNerfppNorm's radius (scene/dataset_readers.py): 1.1 times the
    largest distance of a camera centre from their mean."""
    c = np.stack([cam["campos"] for cam in cams]).astype(np.float64)
    return float(1.1 * np.linalg.norm(c - c.mean(0), axis=1).max())
