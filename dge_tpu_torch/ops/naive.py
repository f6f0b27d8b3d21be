"""Naive per-pixel reference rasterizer (test oracle).

JAX counterpart: ``dge_tpu/ops/naive.py``. Implements the sequential
semantics of renderCUDA (cuda_rasterizer/forward.cu:261-379) in slow numpy:
per pixel, walk all visible Gaussians in depth order, apply the skip rules
and the HARD break at ``T·(1-α) < 1e-4``. The pair-stream compositor
differs from it by design at pixels where a refused pair is followed by a
later block (see ops/pairs_composite.py). Only for small scenes in tests.
"""

from __future__ import annotations

import numpy as np

from dge_tpu_torch.ops import projection


def render_naive(scene, cam, bg=None, tile_px: int = 32) -> dict:
    bg = np.zeros(3, np.float32) if bg is None else np.asarray(bg, np.float32)
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
    )
    mean2d, depth, conic, rgb, op, vis, rad = (
        t.detach().cpu().numpy()
        for t in (prep.mean2d, prep.depth, prep.conic, prep.rgb, prep.opacity,
                  prep.visible, prep.radius)
    )

    order = np.argsort(np.where(vis, depth, np.inf), kind="stable")
    h, w = cam.height, cam.width
    color = np.zeros((h, w, 3), np.float32)
    dimg = np.zeros((h, w), np.float32)
    timg = np.ones((h, w), np.float32)

    tiles_x = -(-w // tile_px)
    tiles_y = -(-h // tile_px)

    def rect(i):
        x0 = min(max(int(np.floor((mean2d[i, 0] - rad[i]) / tile_px)), 0), tiles_x)
        y0 = min(max(int(np.floor((mean2d[i, 1] - rad[i]) / tile_px)), 0), tiles_y)
        x1 = min(
            max(int((mean2d[i, 0] + rad[i] + tile_px - 1) // tile_px), 0), tiles_x
        )
        y1 = min(
            max(int((mean2d[i, 1] + rad[i] + tile_px - 1) // tile_px), 0), tiles_y
        )
        return x0, x1, y0, y1

    ids = [i for i in order if vis[i]]
    rects = {i: rect(i) for i in ids}
    for y in range(h):
        for x in range(w):
            tx, ty = x // tile_px, y // tile_px
            # visited only if the Gaussian's tile rect covers this tile
            # (getRect, auxiliary.h:45-56)
            seq = [i for i in ids
                   if rects[i][0] <= tx < rects[i][1]
                   and rects[i][2] <= ty < rects[i][3]]
            c, d, t = walk_pixel(mean2d[seq], conic[seq], op[seq], rgb[seq],
                                 depth[seq], x, y)
            color[y, x] = c + t * bg
            dimg[y, x] = d
            timg[y, x] = t
    return {"color": color, "depth": dimg, "final_T": timg}


def walk_pixel(mean2d, conic, op, rgb, depth, x, y):
    """One pixel's sequential front-to-back walk over depth-ordered
    Gaussians with the hard break. Returns (rgb [3], depth, T)."""
    t = 1.0
    c = np.zeros(3, np.float32)
    d = 0.0
    for i in range(len(op)):
        dx = mean2d[i, 0] - x
        dy = mean2d[i, 1] - y
        power = (
            -0.5 * (conic[i, 0] * dx * dx + conic[i, 2] * dy * dy)
            - conic[i, 1] * dx * dy
        )
        if power > 0.0:
            continue
        alpha = min(0.99, op[i] * np.exp(power))
        if alpha < 1.0 / 255.0:
            continue
        test_t = t * (1 - alpha)
        if test_t < 1e-4:
            break
        c += rgb[i] * alpha * t
        d += depth[i] * alpha * t
        t = test_t
    return c, d, t
