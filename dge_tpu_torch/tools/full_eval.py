"""Evaluation over scene lists: for each (ply, capture) pair, render
every view spill-free and score PSNR / SSIM against the captured images.

JAX counterpart: ``tools/full_eval.py``; reference analogs
gaussiansplatting/full_eval.py:15-18 and metrics.py:71-86.

Usage:
  python -m dge_tpu_torch.tools.full_eval --pairs a.ply:captureA b.ply:captureB
  python -m dge_tpu_torch.tools.full_eval --mipnerf360 /data/m360 --models /out
      # expands the standard scene lists: capture=<dir>/<scene>,
      # ply=<models>/<scene>/point_cloud/iteration_30000/point_cloud.ply

Writes ``<out>/<scene>/renders/<image>.png`` and ``<out>/results.json``
(psnr, ssim, lpips, n_views, n_gaussians, spill per scene) and returns the
results. LPIPS is the VGG16 distance of ``dge_tpu_torch/models/lpips.py``:
with ``--vgg_checkpoint`` (a local torchvision VGG16 state dict) its convs
are that file's, else they are random (seed 0), a structural distance and
not calibrated LPIPS; it is then not the JAX tool's random number either,
since the two packages draw their weights differently. ``--no_lpips``
reports it as null. On a card the VGG convs run with cuDNN's TF32 off.
Runs on the GPU unless ``--cpu`` is given. ``--backend`` picks the render
backend (default: the device's own, the pair-stream kernel on a card).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def expand_scene_lists(args):
    """Expand --mipnerf360/--tanksandtemples/--deepblending dirs into
    ply:capture pairs using the reference's directory conventions."""
    pairs = []
    for root, scenes in (
        (args.mipnerf360, MIPNERF360_OUTDOOR + MIPNERF360_INDOOR),
        (args.tanksandtemples, TANKS_AND_TEMPLES),
        (args.deepblending, DEEP_BLENDING),
    ):
        if not root:
            continue
        for scene in scenes:
            capture = os.path.join(root, scene)
            if not os.path.isdir(capture):
                print(f"skipping {scene}: no capture at {capture}")
                continue
            ply = os.path.join(
                args.models or root, scene, "point_cloud",
                f"iteration_{args.iteration}", "point_cloud.ply")
            if not os.path.exists(ply):
                print(f"skipping {scene}: no PLY at {ply}")
                continue
            pairs.append(f"{ply}:{capture}")
    return pairs


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full float32 (they default to TF32 on a card),
    as the JAX reference computes them."""
    import torch

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def make_lpips(args, device):
    """The LPIPS function the flags ask for, or None with ``--no_lpips``."""
    if args.no_lpips:
        return None
    import torch

    from dge_tpu_torch.models import lpips as LP

    params = None
    if args.vgg_checkpoint and os.path.exists(args.vgg_checkpoint):
        params = LP.params_from_torchvision(torch.load(
            args.vgg_checkpoint, map_location="cpu", weights_only=True))
    fn, _ = LP.make_perceptual_fn(params=params, device=device)
    if params is None:
        print("[full_eval] LPIPS: no VGG checkpoint"
              + (f" at {args.vgg_checkpoint}" if args.vgg_checkpoint else "")
              + " - using random-init features (structural distance, not "
              "calibrated LPIPS)", flush=True)
    return fn


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", nargs="*", default=[],
                   help="ply:capture_dir pairs")
    p.add_argument("--mipnerf360", default=None,
                   help="MipNeRF360 dataset root (expands the scene list)")
    p.add_argument("--tanksandtemples", default=None)
    p.add_argument("--deepblending", default=None)
    p.add_argument("--models", default=None,
                   help="trained-model root for scene-list expansion")
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--out", default="eval_out")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--backend", default=None,
                   help="render backend (default: the device's own)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--vgg_checkpoint", default=None,
                   help="torchvision VGG16 state dict (a local file) for "
                   "calibrated LPIPS")
    p.add_argument("--no_lpips", action="store_true")
    args = p.parse_args(argv)

    pairs = list(args.pairs) + expand_scene_lists(args)
    if not pairs:
        p.error("no scenes: pass --pairs or a dataset root")

    import numpy as np
    import torch

    from dge_tpu_torch import resolve_device
    from dge_tpu_torch.ops import losses as L
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.utils import saving

    device = resolve_device("cpu" if args.cpu else "cuda")
    lpips_fn = make_lpips(args, device)

    results = {}
    for pair in pairs:
        ply, capture = pair.split(":")
        name = os.path.basename(capture.rstrip("/"))
        scene = G.load_ply(ply, device=device)
        cs = DS.ColmapScene(capture, height=args.height, width=args.width)
        cams = [CameraArrays.from_camera(c, device=device)
                for c in cs.cameras]
        bg = torch.zeros(3, device=device)

        # evaluation must not truncate: probe the first camera and grow the
        # caps until spill == 0, re-growing on any denser later view
        renderer = R.SpillFreeRenderer(
            scene, bg, tile_px=32, backend=args.backend,
            log=lambda m: print(f"[full_eval] {m}", flush=True))
        residual = renderer.probe(cams[0])
        if residual:
            print(f"[full_eval] WARNING: cap-growth probe for '{name}' exited "
                  f"with spill still nonzero ({residual}) at {renderer.caps} "
                  "- the metrics below are computed on TRUNCATED renders",
                  file=sys.stderr, flush=True)

        psnrs, ssims, lpipss = [], [], []
        total_spill = 0
        out_dir = os.path.join(args.out, name, "renders")
        for cam, ca in zip(cs.cameras, cams):
            img, sp = renderer(ca)
            if sp > 0:
                print(f"[full_eval] WARNING: view {cam.image_name} still "
                      f"spills {sp} after re-probing - scored truncated",
                      file=sys.stderr, flush=True)
            total_spill += sp
            saving.save_image(os.path.join(out_dir, cam.image_name + ".png"),
                              img.cpu().numpy())
            gt_path = saving.find_image(cs.images_dir, cam.image_name)
            if os.path.exists(gt_path):
                gt = torch.from_numpy(saving.load_image(
                    gt_path, size=(args.height, args.width))).to(device)
                psnrs.append(float(L.psnr(img, gt)))
                ssims.append(float(L.ssim(img, gt)))
                if lpips_fn is not None:
                    with _no_tf32():
                        lpipss.append(float(lpips_fn(img, gt)))
        results[name] = {
            "psnr": float(np.mean(psnrs)) if psnrs else None,
            "ssim": float(np.mean(ssims)) if ssims else None,
            "lpips": float(np.mean(lpipss)) if lpipss else None,
            "n_views": len(cs.cameras),
            "n_gaussians": scene.n_alive,
            "spill": total_spill,  # nonzero = some view still truncated
        }
        print(name, results[name], flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
