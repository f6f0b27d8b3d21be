"""Render a turntable orbit of a 3DGS PLY: PNG frames, and a video where
imageio is installed.

JAX counterpart: ``tools/orbit_video.py``.

Usage:
  python -m dge_tpu_torch.tools.orbit_video scene.ply out.mp4 --frames 120

Frames go to ``<out without extension>_frames/NNNN.png``. Runs on the GPU
unless ``--cpu`` is given. Returns the frames.
"""

from __future__ import annotations

import argparse
import math
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ply")
    p.add_argument("out", help="output .mp4/.gif")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--dist", type=float, default=None,
                   help="orbit radius (default: 2.5x scene std)")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--elevation", type=float, default=15.0, help="degrees")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dge_tpu_torch import resolve_device
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.scene.cameras import look_at_camera
    from dge_tpu_torch.utils import saving

    device = resolve_device("cpu" if args.cpu else "cuda")
    scene = G.load_ply(args.ply, device=device)
    xyz = scene.xyz[scene.alive].cpu().numpy()
    center = xyz.mean(axis=0)
    dist = args.dist or float(2.5 * xyz.std())
    el = math.radians(args.elevation)

    # an evaluation path: probe-and-grow the caps so that trained scenes do
    # not render truncated
    renderer = R.SpillFreeRenderer(
        scene, torch.zeros(3, device=device), tile_px=32,
        log=lambda m: print(f"[orbit] {m}", flush=True))

    frames_dir = os.path.splitext(args.out)[0] + "_frames"
    frames = []
    for i in range(args.frames):
        ang = 2 * math.pi * i / args.frames
        eye = center + dist * np.array(
            [math.sin(ang) * math.cos(el), math.sin(el),
             -math.cos(ang) * math.cos(el)])
        cam = look_at_camera(eye, center, fovx=math.radians(60),
                             height=args.height, width=args.width)
        color, _ = renderer(CameraArrays.from_camera(cam, device=device))
        frames.append(color.cpu().numpy())
        saving.save_image(os.path.join(frames_dir, f"{i:04d}.png"),
                          frames[-1])
        if i % 20 == 0:
            print(f"frame {i}/{args.frames}", flush=True)
    out = saving.save_video(args.out, frames, fps=args.fps, log=print)
    print("wrote", out or frames_dir)
    return frames


if __name__ == "__main__":
    main()
