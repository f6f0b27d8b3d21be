"""CLI of the PyTorch/CUDA port.

JAX counterpart: the repo's ``launch.py`` (``--render`` / ``--test``,
launch.py:151-198; ``--validate`` and ``--export``, launch.py:201-229;
``--fit``, launch.py:232-307; ``--train``, launch.py:317-485). Six modes:

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

    python -m dge_tpu_torch.launch --train --gs_source scene.ply \\
        --source capture_dir --out outputs [--smoke] [--resume ckpt] \\
        [--config configs/dge.yaml] system.ip2p_checkpoint=DIR \\
        system.prompt="..." [system.editor=sdxl768] [system.model_size=tiny] \\
        [system.vgg_checkpoint=vgg16.pth] [system.clip_checkpoint=DIR] \\
        [system.seg_prompt=object system.segmentor=precomputed \\
         system.mask_dir=DIR] [system.seg_prompt=object \\
         system.segmentor=sam2 system.seg_box=[x0,y0,z0,x1,y1,z1] \\
         system.sam2_checkpoint=sam2.1_hiera_large.pt] \\
         [system.edit.use_sds=true] \\
        [system.guidance.camera_batch_size=5] [system.edit.max_steps=1000] \\
        [data.max_view_num=20] data.height=512 data.width=512

``--render`` loads the PLY and the capture (COLMAP ``sparse/``, or a
Blender ``transforms_train.json``: ``scene/dataset.load_scene``), probes the
spill-free binning caps on view 0 (tile_px 32), renders every view and
writes ``<out>/<name>/<tag>@<time>/renders/NNNN.png``; ``--test`` is the
same mode. The other modes read a COLMAP capture only (they need its point
cloud or its images directory) and refuse a Blender one. ``--validate``
renders every view the same way and scores PSNR / SSIM
/ LPIPS against the capture's images into ``eval/results.json``
(tools/full_eval.py). ``--export`` writes a turntable orbit
(``orbit_frames/NNNN.png``, ``orbit.mp4`` where imageio is installed) and a
copy of the scene as ``scene.ply``. ``--fit`` initialises a scene
from the capture's COLMAP points and fits it to the capture's images (vanilla
3DGS: L1 + SSIM, densify, opacity reset, SH step-up, spill ladder), writing
``point_cloud.ply`` and ``metrics.jsonl`` (TensorBoard events too with
``trainer.tensorboard=true``). ``--train`` is the DGE edit
(systems/edit.DGESystem): the PLY and up to ``data.max_view_num`` capture
views, the InstructPix2Pix models from ``system.ip2p_checkpoint`` (a local
diffusers directory, or the cache ``dge_tpu_torch.tools.ingest_checkpoint``
wrote from one; ``--smoke`` or ``system.allow_random_weights`` runs
random weights instead and writes ``SMOKE_ONLY.txt``), multi-view edit
rounds and the L1 + LPIPS refit (``system.guidance.batch_mode``:
``loop``, or ``vmap``, the batched reuse ``configs/dge.yaml`` names), or
with ``system.edit.use_sds=true`` score distillation every step; with
``system.seg_prompt`` a local edit whose mask the segmentor gives and the
spill-free lift installs (``system.segmentor=sam2``: SAM 2.1 Hiera-L over
the working views in batches of ``system.edit.camera_batch_size``, each
prompted with the scene-space box ``system.seg_box`` projected into it, on
the weights of ``system.sam2_checkpoint`` or, without one, weights drawn
from ``--seed``; ``system.model_size=tiny`` builds its small test
network); with ``system.clip_checkpoint`` (a local
transformers ``CLIPModel`` directory or its ingest cache)
``clip_metrics.json``; writing
``val/``, ``ckpts/``, the edit cache under ``<out>/edit_cache/`` and
``last.ply``;
``system.editor`` picks the edit networks (``ip2p.preset_configs``):
``sd15`` (the default, timbrooks/instruct-pix2pix) or ``sdxl768``
(diffusers/sdxl-instructpix2pix-768: the SDXL UNet, two text towers and
tokenizers, ``tokenizer/`` and ``tokenizer_2/``);
``system.model_size=tiny`` builds the editor's small test networks.
``--distributed`` joins the process group torchrun describes (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--cpu``) and logs rank, world, device and
backend; ``--train`` with ``system.guidance.batch_mode=shard`` then splits
the edit round's camera batches over the ranks. Every rank runs the edit
alike and only rank 0 writes files: with more than one rank no rank reads
the edit cache, and after the run the ranks compare a checksum of their
scenes. The other modes run on rank 0 alone::

    python -m torch.distributed.run --standalone --nproc_per_node=2 \
        -m dge_tpu_torch.launch --train --distributed --gs_source scene.ply \
        --source capture_dir --out outputs system.guidance.batch_mode=shard

Capture images may be PNG or JPEG at any size:
they are area-resized to ``data.height`` x ``data.width``. Every mode writes
``cmd.txt`` and ``parsed.yaml``, runs on the GPU unless ``--cpu`` is given,
and raises without a card and without ``--cpu``. With
``trainer.trace=true`` a mode runs with tracing on (utils/tracing.py) and
writes ``trace.json`` into the trial directory: its spans and counters in
Chrome's trace-event format, on the epoch clock of a ``torch.profiler``
trace of the same run (Perfetto opens it). Dotted overrides apply with
or without ``--config``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, NamedTuple, Optional

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


class TrainRun(NamedTuple):
    ply_path: Optional[str]  # last.ply, the edited scene (None: no writer)
    steps: int
    edit_frames: dict  # view index -> [H, W, 3] float32 edited frame
    losses_finite: bool  # every step's loss was finite
    spill: int  # refit binning spill over the run (0 = spill-free)
    render_spill: int  # binning spill of the view renders
    caps: dict  # binning caps in effect at the end (FitLoop.caps)
    seconds: dict  # host seconds by stage (DGESystem.seconds) and "run"
    launches: dict  # kernel launch counts of the run
    trial_dir: Optional[str]  # None on a rank that writes nothing
    clip_metrics: Optional[dict]  # clip_metrics.json, None without CLIP
    # the DGESystem after the run: its scene (grad mask), fit state,
    # lift_spill / lift_caps and the guidance's models
    system: object
    scene_checksum: str  # the same on every rank (DGESystem.check_replicas)


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
    mode.add_argument("--train", action="store_true",
                      help="the DGE edit: multi-view edit rounds and refit")
    p.add_argument("--smoke", action="store_true",
                   help="allow --train with random diffusion weights "
                   "(outputs are noise)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint (from <trial>/ckpts) to resume --train "
                   "from")
    p.add_argument("--backend", type=str, default=None,
                   help="render backend of --render/--test/--validate "
                   "(default: the device's own)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gs_source", type=str, default=None, help="pretrained PLY")
    p.add_argument("--source", type=str, default=None,
                   help="capture dir (COLMAP; Blender for --render / --test)")
    p.add_argument("--out", type=str, default="outputs")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--distributed", action="store_true",
                   help="join the torchrun process group (NCCL on "
                   "cuda:LOCAL_RANK, gloo with --cpu)")
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    # intermixed: dotted overrides may stand anywhere among the options
    return p.parse_intermixed_args(argv)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    from dge_tpu_torch import resolve_device

    if not (args.render or args.test or args.validate or args.export
            or args.fit or args.train):
        log.error("choose a mode: --render / --test / --validate / "
                  "--export / --fit / --train")
        sys.exit(2)
    if args.distributed:
        from dge_tpu_torch.parallel import dist as D

        device = D.init_from_env(cpu=args.cpu)
        rank = D.rank()
        log.info("distributed: rank %d / world %d, device %s, backend %s",
                 rank, D.world_size(), device, D.dist.get_backend())
        try:
            if rank == 0 or args.train:
                return _run_mode(args, argv, device, writer=rank == 0)
            log.info("rank %d: only rank 0 runs this mode", rank)
            return None
        finally:
            D.dist.destroy_process_group()
    return _run_mode(args, argv, resolve_device("cpu" if args.cpu else "cuda"))


def _run_mode(args, argv, device, writer: bool = True):
    """The chosen mode; only a ``writer`` makes the trial directory."""
    from dge_tpu_torch.utils import config as C
    from dge_tpu_torch.utils import saving

    cfg = C.load_config(args.config, args.overrides)
    trial_dir = None
    if writer:
        trial_dir = C.make_trial_dir(args.out, cfg.get("name", "dge"),
                                     cfg.get("tag", "run"))
        saving.save_run_info(trial_dir, ["dge_tpu_torch.launch"] + argv, cfg)
        log.info("trial dir: %s", trial_dir)

    if not (trial_dir and cfg.get("trainer", {}).get("trace", False)):
        return _dispatch(args, cfg, trial_dir, device)
    from dge_tpu_torch.utils import tracing

    with tracing.recording():
        try:
            return _dispatch(args, cfg, trial_dir, device)
        finally:
            log.info("trace: %s", tracing.write_chrome_trace(
                os.path.join(trial_dir, "trace.json"), tracing.take()))


def _dispatch(args, cfg, trial_dir, device):
    gs_source = args.gs_source or cfg.get("system", {}).get("gs_source")
    source = args.source or cfg.get("data", {}).get("source")
    if args.fit:
        return run_fit(cfg, source, trial_dir, args.seed, device)
    if args.train:
        return run_train(cfg, gs_source, source, trial_dir, args.seed, device,
                         smoke=args.smoke, resume=args.resume,
                         out_root=args.out)
    if args.validate:
        return run_validate(cfg, gs_source, source, trial_dir, device,
                            args.backend)
    if args.export:
        return run_export(cfg, gs_source, trial_dir, device)
    return run_render(cfg, gs_source, source, trial_dir, device, args.backend)


def _colmap_only(source, mode: str) -> None:
    """Refuse a Blender capture in a mode that needs COLMAP's point cloud or
    images directory."""
    if (source and not os.path.isdir(os.path.join(source, "sparse"))
            and os.path.exists(os.path.join(source,
                                            "transforms_train.json"))):
        raise ValueError(
            f"{mode} reads a COLMAP capture (sparse/ and images/); {source} "
            "is a Blender capture, which only --render / --test read")


def _size(cfg):
    data_cfg = cfg.get("data", {})
    return int(data_cfg.get("height", 512)), int(data_cfg.get("width", 512))


def run_validate(cfg, gs_source, source, trial_dir, device,
                 backend=None) -> ValidateRun:
    """Render every capture view and write PSNR / SSIM / LPIPS to
    eval/results.json (gaussiansplatting/metrics.py:36-93 analog for one
    scene)."""
    from dge_tpu_torch.tools import full_eval

    _colmap_only(source, "--validate")
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
    cs = DS.load_scene(source, height=h, width=w)
    cams = [CameraArrays.from_camera(c, device=device) for c in cs.cameras]
    log.info("loaded %d gaussians, %d cameras (%s) on %s", scene.n_alive,
             len(cams), type(cs).__name__, device)

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

    from dge_tpu_torch.ops.cuda_build import launch_counts
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.systems import fit as F
    from dge_tpu_torch.systems import optim as O
    from dge_tpu_torch.utils import saving
    from dge_tpu_torch.utils.logger import MetricsLogger

    _colmap_only(source, "--fit")
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
    before = dict(launch_counts)
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
                  {k: v - before[k] for k, v in launch_counts.items()},
                  seconds, trial_dir)


def run_train(cfg, gs_source, source, trial_dir, seed, device, smoke=False,
              resume=None, out_root="outputs") -> TrainRun:
    """The DGE edit loop (BASELINE.md config 4): render -> multi-view edit
    -> refit. ``trial_dir`` None: a rank of a group that writes nothing."""
    import hashlib
    import time

    from dge_tpu_torch.diffusion import ip2p
    from dge_tpu_torch.diffusion import tokenizer as T
    from dge_tpu_torch.diffusion import weights as W
    from dge_tpu_torch.models import lpips
    from dge_tpu_torch.ops.cuda_build import launch_counts
    from dge_tpu_torch.parallel import dist as D
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.systems.edit import DGESystem, EditConfig
    from dge_tpu_torch.systems.guidance import DGEGuidance, GuidanceConfig
    from dge_tpu_torch.systems.prompts import PromptConfig, PromptProcessor
    from dge_tpu_torch.utils.config import parse_structured
    from dge_tpu_torch.utils.logger import MetricsLogger

    sys_cfg = cfg.get("system", {})
    _colmap_only(source, "--train")
    h, w = _size(cfg)
    scene = G.load_ply(gs_source, device=device)
    cs = DS.ColmapScene(source, height=h, width=w)
    sub = DS.subsample_views(cs.cameras,
                             int(cfg.get("data", {}).get("max_view_num", 20)))
    cams = [CameraArrays.from_camera(c, device=device) for c in sub]

    ckpt_dir = sys_cfg.get("ip2p_checkpoint")
    params = None
    if ckpt_dir and os.path.isdir(ckpt_dir):
        log.info("loading IP2P weights from %s", ckpt_dir)
        params = W.load_checkpoint(ckpt_dir, W.load_ip2p_checkpoint)
    elif smoke or sys_cfg.get("allow_random_weights", False):
        log.warning("SMOKE RUN: no IP2P checkpoint configured "
                    "(system.ip2p_checkpoint): RANDOM weights, the edits are "
                    "noise; outputs are marked smoke-only")
        if trial_dir:
            with open(os.path.join(trial_dir, "SMOKE_ONLY.txt"), "w") as f:
                f.write("this trial ran with random diffusion weights: "
                        "edit outputs are noise, usable only for pipeline "
                        "smoke testing\n")
    else:
        log.error("--train needs real diffusion weights: set "
                  "system.ip2p_checkpoint to a local diffusers "
                  "timbrooks/instruct-pix2pix directory, or pass --smoke to "
                  "run the pipeline with random weights (noise output)")
        sys.exit(2)
    editor = sys_cfg.get("editor", "sd15")
    tiny = sys_cfg.get("model_size", "full") == "tiny"
    unet_cfg, vae_cfg, text_cfg, text_cfg_2 = ip2p.preset_configs(editor,
                                                                  tiny)
    models = ip2p.build_models(unet_cfg, vae_cfg, text_cfg, params=params,
                               device=device, text_cfg_2=text_cfg_2)
    subs = ("tokenizer",) + (("tokenizer_2",) if text_cfg_2 else ())
    if tiny:
        # the small test networks: the whole edit path runs on the CPU
        toks = [T.HashTokenizer(vocab_size=text_cfg.vocab_size,
                                max_length=text_cfg.max_length)
                for _ in subs]
    else:
        toks = [T.load_tokenizer(os.path.join(ckpt_dir, sub)
                                 if ckpt_dir else None) for sub in subs]
        if any(isinstance(t, T.HashTokenizer) for t in toks):
            log.warning("no tokenizer vocabulary: HashTokenizer ids are "
                        "meaningless (smoke only)")

    # the refit's perceptual loss (DGE.py:637-683): VGG16 from
    # system.vgg_checkpoint (a torchvision state dict), random otherwise
    vgg_ckpt = sys_cfg.get("vgg_checkpoint")
    if vgg_ckpt and os.path.exists(vgg_ckpt):
        log.info("loading VGG16 weights from %s", vgg_ckpt)
        perceptual_fn, _ = lpips.make_perceptual_fn(
            lpips.params_from_torchvision(W.load_state_dict_file(vgg_ckpt)),
            device=device)
    else:
        perceptual_fn, _ = lpips.make_perceptual_fn(
            generator=torch.Generator().manual_seed(7), device=device)
    prompt = sys_cfg.get("prompt", "")
    po = PromptProcessor(
        lambda texts: [t(texts) for t in toks],
        lambda ids: ip2p.encode_text(models, *ids),
        cache_dir=trial_dir and os.path.join(trial_dir, "text_cache"),
        cfg=PromptConfig(prompt=prompt,
                         negative_prompt=sys_cfg.get("negative_prompt", "")),
    )()
    guidance = DGEGuidance(
        parse_structured(GuidanceConfig, sys_cfg.get("guidance", {})), models)
    # configs/dge.yaml sets seg_prompt at the system level, where the JAX
    # launcher never reads it; system.edit.seg_prompt still wins
    e_cfg = parse_structured(EditConfig, {
        "seg_prompt": sys_cfg.get("seg_prompt", ""),
        "seg_box": sys_cfg.get("seg_box"),
        **sys_cfg.get("edit", {})})
    seg = _segmentor(sys_cfg, tiny, device, seed)
    # the cross-trial edit cache keyed by (gs_source, prompt, #views, an
    # editor other than SD-1.5 and the sam2 segmentor's box): a re-run with
    # the same key skips the edit rounds unless system.edit.cache_overwrite
    # is set (DGE.py:96-99)
    sam2_key = (f"|sam2|{list(e_cfg.seg_box or ())}"
                if sys_cfg.get("segmentor") == "sam2" else "")
    cache_key = hashlib.md5(
        (f"{os.path.abspath(gs_source)}|{prompt}|{len(cams)}"
         + ("" if editor == "sd15" else f"|{editor}") + sam2_key).encode()
    ).hexdigest()[:16]
    cache_dir = os.path.join(out_root, "edit_cache", cache_key)
    log.info("edit cache: %s", cache_dir)
    if D.world_size() > 1:
        # ranks that read the cache at different moments could take
        # different paths through the collectives: none reads it, and
        # only the writer fills it
        log.info("%d ranks: the edit cache is not read", D.world_size())
        e_cfg.cache_overwrite = True
        cache_dir = cache_dir if trial_dir else None
    system = DGESystem(
        e_cfg, scene, cams, guidance=guidance,
        text_emb_pos=torch.from_numpy(po.cond).to(device),
        text_emb_neg=torch.from_numpy(po.uncond).to(device),
        pooled_pos=_pooled(po.cond_pooled, device),
        pooled_neg=_pooled(po.uncond_pooled, device),
        perceptual_fn=perceptual_fn, cameras_extent=cs.cameras_extent,
        cache_dir=cache_dir, segmentor=seg)
    start_step = 0
    if resume:
        start_step = system.restore_state(resume)
        log.info("resumed from %s at step %d", resume, start_step)
    metrics = trial_dir and MetricsLogger(
        trial_dir,
        tensorboard=bool(cfg.get("trainer", {}).get("tensorboard", False)))
    before = dict(launch_counts)
    t0 = time.time()
    final = system.run(seed, log_fn=log.info, start_step=start_step,
                       ckpt_dir=trial_dir and os.path.join(trial_dir, "ckpts"),
                       val_dir=trial_dir and os.path.join(trial_dir, "val"),
                       metrics=metrics)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = dict(system.seconds, run=time.time() - t0)
    launches = {k: v - before[k] for k, v in launch_counts.items()}
    log.info("kernel launches: %s", launches)
    if device.type == "cuda":
        log.info("peak memory %.3f GiB on %s",
                 torch.cuda.max_memory_allocated(device) / 2 ** 30, device)
    checksum = system.check_replicas()
    log.info("scene checksum %s (rank %d of %d)", checksum, D.rank(),
             D.world_size())
    ply = clip = None
    if trial_dir:
        metrics.close()
        ply = os.path.join(trial_dir, "last.ply")
        G.save_ply(final, ply)
        log.info("saved edited scene to %s", ply)
        # CLIP edit-quality metrics (clip_metrics.py:33-50): the original
        # and the edited scene's renders against the source and edit prompts
        clip = _clip_edit_metrics(sys_cfg, system, trial_dir, device)
    return TrainRun(
        ply, e_cfg.max_steps, dict(system.edit_frames),
        system.losses_finite, system.total_spill,
        system.render_spill, system.loop.caps, seconds, launches, trial_dir,
        clip, system, checksum)


def _segmentor(sys_cfg: dict, tiny: bool, device, seed: int):
    """The local edit's segmentor, ``system.segmentor`` (``fallback`` by
    default). ``sam2`` builds SAM 2.1 Hiera-L (its tiny preset with
    ``tiny``) on ``device`` from ``system.sam2_checkpoint``, or from weights
    drawn from ``seed`` without one."""
    from dge_tpu_torch.models.sam2 import Sam2Config
    from dge_tpu_torch.systems.segmentation import build_segmentor

    kind = sys_cfg.get("segmentor", "fallback")
    if kind != "sam2":
        return build_segmentor(kind, sys_cfg.get("mask_dir", ""))
    ckpt = sys_cfg.get("sam2_checkpoint")
    if ckpt and not os.path.exists(ckpt):
        raise FileNotFoundError(f"system.sam2_checkpoint: no file {ckpt}")
    if not ckpt:
        log.warning("no SAM 2.1 checkpoint (system.sam2_checkpoint): "
                    "RANDOM segmenter weights, the masks are noise")
    return build_segmentor(
        "sam2", cfg=Sam2Config.tiny() if tiny else Sam2Config.hiera_large(),
        device=device, checkpoint=ckpt, seed=seed)


def _pooled(x, device):
    """A prompt's pooled embedding [1, P] on ``device`` (None: SD-1.5)."""
    return None if x is None else torch.from_numpy(x)[None].to(device)


def _clip_edit_metrics(sys_cfg, system, trial_dir, device) -> Optional[dict]:
    """``clip_metrics.json`` (the four similarity means and ``n_views``) of
    the origin frames against the edited scene's renders, with the CLIP
    towers of the local transformers ``CLIPModel`` directory
    ``system.clip_checkpoint`` (tokenizer files from its ``tokenizer/``
    subdirectory or itself); without one it logs that it skips, since
    scores from random towers mean nothing. Returns the metrics or None."""
    ckpt = sys_cfg.get("clip_checkpoint")
    if not (ckpt and os.path.isdir(ckpt)):
        log.info("no CLIP checkpoint (system.clip_checkpoint): skipping the "
                 "CLIP edit metrics (scores from random towers are "
                 "meaningless)")
        return None
    from dge_tpu_torch.diffusion import tokenizer as T
    from dge_tpu_torch.diffusion import weights as W
    from dge_tpu_torch.models.clip_vision import build_clip_similarity
    from dge_tpu_torch.utils import saving

    ck = W.load_checkpoint(ckpt, W.load_clip_checkpoint)
    tok_dir = os.path.join(ckpt, "tokenizer")
    tok = T.load_tokenizer(tok_dir if os.path.isdir(tok_dir) else ckpt,
                           max_length=ck["text_config"].max_length)
    sim = build_clip_similarity(
        ck, None if isinstance(tok, T.HashTokenizer) else tok,
        ck["vision_config"], ck["text_config"], device=device)
    vids = sorted(system.origin_frames)
    src = np.stack([system.origin_frames[v] for v in vids])
    edited = np.stack([system._render_np(v) for v in vids])
    s_src, s_edit, s_dir, s_img = sim(
        src, edited, [sys_cfg.get("source_prompt", "a photo")] * len(vids),
        [sys_cfg.get("prompt", "")] * len(vids))
    out = {"clip_sim_source": float(np.mean(s_src)),
           "clip_sim_edit": float(np.mean(s_edit)),
           "clip_sim_direction": float(np.mean(s_dir)),
           "clip_sim_image": float(np.mean(s_img)),
           "n_views": len(vids)}
    saving.save_json(os.path.join(trial_dir, "clip_metrics.json"), out)
    log.info("CLIP edit metrics: %s", out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s] %(asctime)s %(message)s")
    main()
