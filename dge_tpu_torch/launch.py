"""CLI of the PyTorch/CUDA port.

JAX counterpart: the repo's ``launch.py`` (``--render``, launch.py:151-198).
This slice has the render mode only:

    python -m dge_tpu_torch.launch --render --gs_source scene.ply \\
        --source capture_dir --out outputs [--cpu] [--config cfg.yaml] \\
        data.height=256 data.width=256

It loads the PLY and the COLMAP capture, probes the spill-free binning caps
on view 0 (tile_px 32), renders every view and writes
``<out>/<name>/<tag>@<time>/renders/NNNN.png``, ``cmd.txt`` and
``parsed.yaml``. It runs on the GPU unless ``--cpu`` is given; without a
card and without ``--cpu`` it raises. Dotted overrides apply with or without
``--config``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, NamedTuple

import numpy as np
import torch

log = logging.getLogger("dge_tpu_torch")


class RenderRun(NamedTuple):
    frames: List[np.ndarray]  # [H, W, 3] float32 renders, one per view
    image_names: List[str]  # capture image stem of each view
    spill: int  # pairs still dropped after the ladder (0 = spill-free)
    caps: dict  # binning caps in effect at the end
    tight_cull: bool
    trial_dir: str


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dge_tpu_torch launcher")
    p.add_argument("--config", type=str, help="experiment YAML")
    p.add_argument("--render", action="store_true",
                   help="render a pretrained PLY for every capture view")
    p.add_argument("--gs_source", type=str, default=None, help="pretrained PLY")
    p.add_argument("--source", type=str, default=None, help="COLMAP scene dir")
    p.add_argument("--out", type=str, default="outputs")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    return p.parse_args(argv)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    from dge_tpu_torch import resolve_device
    from dge_tpu_torch.utils import config as C
    from dge_tpu_torch.utils import saving

    if not args.render:
        log.error("choose a mode: --render")
        sys.exit(2)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = C.load_config(args.config, args.overrides)
    trial_dir = C.make_trial_dir(args.out, cfg.get("name", "dge"),
                                 cfg.get("tag", "run"))
    saving.save_run_info(trial_dir, ["dge_tpu_torch.launch"] + argv, cfg)
    log.info("trial dir: %s", trial_dir)

    gs_source = args.gs_source or cfg.get("system", {}).get("gs_source")
    source = args.source or cfg.get("data", {}).get("source")
    return run_render(cfg, gs_source, source, trial_dir, device)


def run_render(cfg, gs_source, source, trial_dir, device) -> RenderRun:
    """Render a pretrained PLY for every camera and save the frames
    (gaussiansplatting/render.py analog)."""
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.utils import saving

    data_cfg = cfg.get("data", {})
    h = int(data_cfg.get("height", 512))
    w = int(data_cfg.get("width", 512))
    scene = G.load_ply(gs_source, device=device)
    cs = DS.ColmapScene(source, height=h, width=w)
    cams = [CameraArrays.from_camera(c, device=device) for c in cs.cameras]
    log.info("loaded %d gaussians, %d cameras on %s", scene.n_alive,
             len(cams), device)

    bg = torch.zeros(3, device=device)
    # evaluation must not truncate: probe-and-grow the caps until spill == 0
    renderer = R.SpillFreeRenderer(scene, bg, tile_px=32, log=log.info)
    renderer.probe(cams[0])
    out_dir = os.path.join(trial_dir, "renders")
    frames = []
    total_spill = 0
    for i, cam in enumerate(cams):
        color, sp = renderer(cam)
        img = color.cpu().numpy()
        total_spill += sp
        saving.save_image(os.path.join(out_dir, f"{i:04d}.png"), img)
        frames.append(img)
    if total_spill:
        log.warning("binning still dropped %d (tile, gaussian) pairs after "
                    "cap growth — renders are truncated", total_spill)
    saving.save_video(os.path.join(trial_dir, "renders.mp4"), frames,
                      log=log.info)
    log.info("wrote %d renders to %s", len(frames), out_dir)
    return RenderRun(frames, [c.image_name for c in cs.cameras], total_spill,
                     renderer.caps, renderer.tight_cull, trial_dir)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s] %(asctime)s %(message)s")
    main()
