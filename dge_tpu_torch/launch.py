"""CLI of the PyTorch/CUDA port.

JAX counterpart: the repo's ``launch.py`` (``--render`` / ``--test``,
launch.py:151-198; ``--validate`` and ``--export``, launch.py:201-229;
``--fit``, launch.py:232-307). Five modes (``--train``, the DGE edit, is not
ported yet):

    python -m dge_tpu_torch.launch --render --gs_source scene.ply \\
        --source capture_dir --out outputs [--cpu] [--config cfg.yaml] \\
        [--backend cuda_tiles] data.height=256 data.width=256

    python -m dge_tpu_torch.launch --validate --gs_source scene.ply \\
        --source capture_dir --out outputs data.height=256 data.width=256

    python -m dge_tpu_torch.launch --export --gs_source scene.ply \\
        --out outputs [export.frames=120]

    python -m dge_tpu_torch.launch --fit --source capture_dir --out outputs \\
        [--cpu] [--seed 0] data.height=256 data.width=256 \\
        system.sh_degree=3 trainer.max_steps=7000

``--render`` loads the PLY and the COLMAP capture, probes the spill-free
binning caps on view 0 (tile_px 32), renders every view and writes
``<out>/<name>/<tag>@<time>/renders/NNNN.png``; ``--test`` is the same
mode. ``--validate`` renders every view the same way and scores PSNR / SSIM
/ LPIPS against the capture's images into ``eval/results.json``
(tools/full_eval.py). ``--export`` writes a turntable orbit
(``orbit_frames/NNNN.png``, ``orbit.mp4`` where imageio is installed) and a
copy of the scene as ``scene.ply``. ``--fit`` initialises a scene
from the capture's COLMAP points and fits it to the capture's images (vanilla
3DGS: L1 + SSIM, densify, opacity reset, SH step-up, spill ladder), writing
``point_cloud.ply`` and ``metrics.jsonl`` (TensorBoard events too with
``trainer.tensorboard=true``). Capture images may be PNG or JPEG at any size:
they are area-resized to ``data.height`` x ``data.width``. Every mode writes
``cmd.txt`` and ``parsed.yaml``, runs on the GPU unless ``--cpu`` is given,
and raises without a card and without ``--cpu``. Dotted overrides apply with or without
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


class ValidateRun(NamedTuple):
    results: dict  # scene name -> {psnr, ssim, lpips, n_views, ...}
    eval_dir: str  # holds results.json and <scene>/renders/
    trial_dir: str


class ExportRun(NamedTuple):
    frames: List[np.ndarray]  # the orbit's [H, W, 3] float32 frames
    scene_ply: str  # the copy of the scene
    trial_dir: str


class FitRun(NamedTuple):
    ply_path: str  # the fitted scene
    steps: int
    last_psnr: float  # mean train PSNR over the last (up to) 100 steps
    losses_finite: bool  # every step's L1 loss was finite
    n_alive: int
    caps: dict  # binning caps in effect at the end (FitLoop.caps)
    launches: dict  # kernel launch counts of this run
    seconds: float  # wall time of the training loop
    trial_dir: str


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dge_tpu_torch launcher")
    p.add_argument("--config", type=str, help="experiment YAML")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--render", action="store_true",
                      help="render a pretrained PLY for every capture view")
    mode.add_argument("--test", action="store_true",
                      help="the same as --render")
    mode.add_argument("--validate", action="store_true",
                      help="render every capture view and write PSNR/SSIM/"
                      "LPIPS to eval/results.json")
    mode.add_argument("--export", action="store_true",
                      help="turntable orbit frames and a copy of the scene")
    mode.add_argument("--fit", action="store_true",
                      help="fit a 3DGS scene to the capture's images")
    p.add_argument("--backend", type=str, default=None,
                   help="render backend of --render/--test/--validate "
                   "(default: the device's own)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gs_source", type=str, default=None, help="pretrained PLY")
    p.add_argument("--source", type=str, default=None, help="COLMAP scene dir")
    p.add_argument("--out", type=str, default="outputs")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    # intermixed: dotted overrides may stand anywhere among the options
    return p.parse_intermixed_args(argv)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    from dge_tpu_torch import resolve_device
    from dge_tpu_torch.utils import config as C
    from dge_tpu_torch.utils import saving

    if not (args.render or args.test or args.validate or args.export
            or args.fit):
        log.error("choose a mode: --render / --test / --validate / "
                  "--export / --fit")
        sys.exit(2)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = C.load_config(args.config, args.overrides)
    trial_dir = C.make_trial_dir(args.out, cfg.get("name", "dge"),
                                 cfg.get("tag", "run"))
    saving.save_run_info(trial_dir, ["dge_tpu_torch.launch"] + argv, cfg)
    log.info("trial dir: %s", trial_dir)

    gs_source = args.gs_source or cfg.get("system", {}).get("gs_source")
    source = args.source or cfg.get("data", {}).get("source")
    if args.fit:
        return run_fit(cfg, source, trial_dir, args.seed, device)
    if args.validate:
        return run_validate(cfg, gs_source, source, trial_dir, device,
                            args.backend)
    if args.export:
        return run_export(cfg, gs_source, trial_dir, device)
    return run_render(cfg, gs_source, source, trial_dir, device, args.backend)


def _size(cfg):
    data_cfg = cfg.get("data", {})
    return int(data_cfg.get("height", 512)), int(data_cfg.get("width", 512))


def run_validate(cfg, gs_source, source, trial_dir, device,
                 backend=None) -> ValidateRun:
    """Render every capture view and write PSNR / SSIM / LPIPS to
    eval/results.json (gaussiansplatting/metrics.py:36-93 analog for one
    scene)."""
    from dge_tpu_torch.tools import full_eval

    h, w = _size(cfg)
    eval_dir = os.path.join(trial_dir, "eval")
    argv = ["--pairs", f"{gs_source}:{source}", "--out", eval_dir,
            "--height", str(h), "--width", str(w)]
    if backend:
        argv += ["--backend", backend]
    if device.type == "cpu":
        argv.append("--cpu")
    return ValidateRun(full_eval.main(argv), eval_dir, trial_dir)


def run_export(cfg, gs_source, trial_dir, device) -> ExportRun:
    """Artifact export from a PLY: turntable orbit and a copy of the scene
    (the viewer-free --export analog)."""
    import shutil

    from dge_tpu_torch.tools import orbit_video

    h, w = _size(cfg)
    argv = [gs_source, os.path.join(trial_dir, "orbit.mp4"),
            "--height", str(h), "--width", str(w),
            "--frames", str(int(cfg.get("export", {}).get("frames", 120)))]
    if device.type == "cpu":
        argv.append("--cpu")
    frames = orbit_video.main(argv)
    scene_ply = os.path.join(trial_dir, "scene.ply")
    shutil.copy(gs_source, scene_ply)
    log.info("exported %d orbit frames and scene.ply to %s", len(frames),
             trial_dir)
    return ExportRun(frames, scene_ply, trial_dir)


def run_render(cfg, gs_source, source, trial_dir, device,
               backend=None) -> RenderRun:
    """Render a pretrained PLY for every camera and save the frames
    (gaussiansplatting/render.py analog)."""
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.utils import saving

    h, w = _size(cfg)
    scene = G.load_ply(gs_source, device=device)
    cs = DS.ColmapScene(source, height=h, width=w)
    cams = [CameraArrays.from_camera(c, device=device) for c in cs.cameras]
    log.info("loaded %d gaussians, %d cameras on %s", scene.n_alive,
             len(cams), device)

    bg = torch.zeros(3, device=device)
    # evaluation must not truncate: probe-and-grow the caps until spill == 0
    renderer = R.SpillFreeRenderer(scene, bg, tile_px=32, log=log.info,
                                   backend=backend)
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


def run_fit(cfg, source, trial_dir, seed, device) -> FitRun:
    """Vanilla 3DGS fitting against the capture's images
    (gaussiansplatting/train.py analog)."""
    import time

    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.systems import fit as F
    from dge_tpu_torch.systems import optim as O
    from dge_tpu_torch.utils import saving
    from dge_tpu_torch.utils.logger import MetricsLogger

    h, w = _size(cfg)
    cs = DS.ColmapScene(source, height=h, width=w)
    pts, cols = cs.point_cloud()
    # sh_degree=3 is the vanilla-3DGS default (train.py); DGE edits fit with
    # sh_degree=0 (DGE.py configure)
    sh_deg = int(cfg.get("system", {}).get("sh_degree", 3))
    scene = G.create_from_pcd(pts, cols, max_sh_degree=sh_deg, device=device)
    cams = [CameraArrays.from_camera(c, device=device) for c in cs.cameras]
    targets = [
        torch.from_numpy(saving.load_image(
            saving.find_image(cs.images_dir, c.image_name),
            size=(h, w))).to(device)
        for c in cs.cameras]

    ocfg = O.OptimConfig.scaled(
        int(cfg.get("trainer", {}).get("max_steps", 7000)))
    loop = F.FitLoop(ocfg, extent=cs.cameras_extent,
                     spatial_lr_scale=cs.cameras_extent)
    opt_state, fit_state = loop.init(scene)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bg = torch.zeros(3, device=device)
    metrics = MetricsLogger(
        trial_dir,
        tensorboard=bool(cfg.get("trainer", {}).get("tensorboard", False)))
    log.info("fitting %d gaussians to %d views on %s for %d steps",
             scene.n_alive, len(cams), device, ocfg.max_steps)
    before = dict(PC.launch_counts)
    psnrs, losses = [], []
    t0 = time.time()
    for step in range(ocfg.max_steps):
        i = int(rng.integers(len(cams)))
        scene, opt_state, fit_state, aux = loop.train_step(
            scene, opt_state, fit_state, cams[i], targets[i], bg)
        scene, opt_state, fit_state, _ = loop.maybe_densify(
            scene, opt_state, fit_state, gen)
        scene, opt_state, fit_state = loop.maybe_housekeep(
            scene, opt_state, fit_state)
        # one host sync per step: training against truncated tile lists
        # corrupts the scene, so the spill is read every step
        spill = int(aux["spill"])
        if loop.react_to_spill(spill, scene.capacity, aux.get("spill_parts")):
            log.warning("step %d: binning spill persisted: caps now %s",
                        step, loop.caps)
        psnrs.append(aux["psnr"])
        losses.append(aux["loss"])
        if step % 10 == 0:
            metrics.log(step, {
                "train/loss": float(aux["loss"]),
                "train/psnr": float(aux["psnr"]),
                "train/n_alive": scene.n_alive,
                "train/spill": spill,
            })
        if step % 100 == 0:
            log.info("step %d loss %.4f psnr %.2f n=%d spill %d", step,
                     float(aux["loss"]), float(aux["psnr"]), scene.n_alive,
                     spill)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t0
    metrics.close()
    ply = os.path.join(trial_dir, "point_cloud.ply")
    G.save_ply(scene, ply)
    last = torch.stack(psnrs[-100:]).mean() if psnrs else torch.zeros(())
    finite = bool(torch.isfinite(torch.stack(losses)).all()) if losses else True
    log.info("saved %d gaussians to %s (last train PSNR %.2f dB, %.1f s)",
             scene.n_alive, ply, float(last), seconds)
    return FitRun(ply, ocfg.max_steps, float(last), finite, scene.n_alive,
                  loop.caps,
                  {k: v - before[k] for k, v in PC.launch_counts.items()},
                  seconds, trial_dir)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s] %(asctime)s %(message)s")
    main()
