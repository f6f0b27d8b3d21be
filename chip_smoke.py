#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dge_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Builds the hand-written CUDA kernel from the checkout's sources and runs:

1. kernel vs plain: the pair-stream compositing kernel against its plain
   PyTorch version on the block-boundary fixture and on a seeded random
   scene (tolerances: colour 1e-4, depth 1e-3, final T 2e-4); phases 2 and
   3 hold it against the plain version on their streams too;
2. the main path: ``dge_tpu_torch.launch --render`` of the quality-gate
   scene over the committed 16-view capture at 256^2, in-process, with the
   kernel's launch counter set to 0 just before and read just after; spill
   must be 0 after the cap ladder and the mean PSNR of the float renders
   against the capture at least 41.5 dB;
3. full width: the trained bench scene spill-free at 512^2 and at
   1920x1080, timed with CUDA events (whole render, its stages, kernel
   alone, plain version).

It prints one JSON line per kernel, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Any failure raises: the
exit code is then not 0 and no result line is printed. Without a CUDA
device, or outside the repository, it fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_PLY = os.path.join(ROOT, "outputs", "bench_scene", "point_cloud.ply")
QUALITY_PLY = os.path.join(
    ROOT, "outputs", "quality_gate", "20260821-064841", "fitdemo",
    "tpu@20260821-064841", "point_cloud.ply")
CAPTURE = os.path.join(ROOT, "outputs", "fit_capture")
TOL = {"color": 1e-4, "depth": 1e-3, "trans": 2e-4}
PSNR_MIN = 41.5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
FLOPS_PER_PAIR_PIXEL = 25  # one exp + ~12 FMAs per (pair, pixel)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms over ``reps`` calls (CUDA events,
    after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(pairs: int, num_tiles: int, tile_px: int):
    """Least time of the compositing on this card: bytes (stream read once,
    [T, 5, P] written once) over HBM rate vs operations over f32 rate."""
    p = tile_px * tile_px
    t_bytes = (pairs * 10 * 4 + num_tiles * p * 5 * 4) / HBM_BYTES_PER_S
    t_ops = pairs * p * FLOPS_PER_PAIR_PIXEL / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare(got, want, what: str) -> float:
    """Max abs error of kernel output [T, 5, P] vs plain; raises beyond the
    tolerances."""
    err = (got - want).abs()
    e_col = float(err[:, 0:3].max()) if err.numel() else 0.0
    e_dep = float(err[:, 3].max()) if err.numel() else 0.0
    e_t = float(err[:, 4].max()) if err.numel() else 0.0
    log(f"  {what}: max|err| colour {e_col:.3e} depth {e_dep:.3e} "
        f"T {e_t:.3e}")
    if not (e_col <= TOL["color"] and e_dep <= TOL["depth"]
            and e_t <= TOL["trans"]):
        raise AssertionError(f"{what}: kernel disagrees with plain version "
                             f"({e_col}, {e_dep}, {e_t}) > {TOL}")
    return max(e_col, e_t)


def stream_stages(scene, cam, caps, tight_cull, tile_px):
    """render()'s stages for one frame as separate calls: (preprocess,
    binning, assembly) closures, each taking the previous one's output."""
    from dge_tpu_torch.ops import binning as B
    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.ops import projection as P

    def preprocess():
        return P.preprocess(scene.xyz, scene.get_scaling, scene.get_rotation,
                            scene.get_opacity, scene.get_features,
                            scene.alive, cam, scene.active_sh_degree,
                            scene.max_sh_degree)

    def binning(prep):
        return B.bin_gaussians_pairs(
            prep.mean2d, prep.depth, prep.radius, prep.visible,
            height=cam.height, width=cam.width, tile_px=tile_px,
            conic=prep.conic if tight_cull else None,
            opacity=prep.opacity if tight_cull else None, **caps)

    def assembly(prep, pb):
        return PC.assemble_stream_data(pb.pair_ids, prep.mean2d, prep.conic,
                                       prep.rgb, prep.depth, prep.opacity)

    return preprocess, binning, assembly


def stream_inputs(scene, cam, caps, tight_cull, tile_px, chunk):
    """The kernel's inputs for one frame, as render() forms them."""
    preprocess, binning, assembly = stream_stages(scene, cam, caps,
                                                  tight_cull, tile_px)
    prep = preprocess()
    pb = binning(prep)
    return dict(data=assembly(prep, pb), starts=pb.starts.contiguous(),
                counts=pb.counts.contiguous(), tiles_x=pb.tiles_x,
                tiles_y=pb.tiles_y, pairs=int(pb.counts.sum()),
                chunk=max(chunk, 128), tile_px=tile_px)


def stage_ms(scene, cam, caps, tight_cull, tile_px) -> dict:
    """Device time of each of render()'s stages before the kernel."""
    preprocess, binning, assembly = stream_stages(scene, cam, caps,
                                                  tight_cull, tile_px)
    prep = preprocess()
    pb = binning(prep)
    return dict(preprocess_ms=cuda_ms(preprocess),
                binning_ms=cuda_ms(lambda: binning(prep)),
                assembly_ms=cuda_ms(lambda: assembly(prep, pb)))


def kernel_vs_plain(inp, what: str) -> float:
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC

    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"],
              chunk=inp["chunk"])
    before = PC.launch_counts["pairs_composite"]
    got = PC.composite_pairs_stream(inp["data"], inp["starts"], inp["counts"],
                                    **kw)
    torch.cuda.synchronize()
    if PC.launch_counts["pairs_composite"] != before + 1:
        raise AssertionError("launch counter did not advance")
    want = PC.composite_pairs_reference(inp["data"], inp["starts"],
                                        inp["counts"], **kw)
    return compare(got, want, what)


def boundary_fixture(dev):
    """One 16x16 tile: alpha 0.99, 0.5, 0.99 in slots 0-2, 0.5 in slot 128
    (chunk 128); the stream runs a block past the tile's range."""
    import torch

    total = 384
    feat = torch.zeros(10, total)
    feat[0:2] = 8.0  # mean at pixel (8, 8); conic 0: alpha = opacity
    feat[5, [0, 1, 2, 128]] = torch.tensor([0.99, 0.5, 0.99, 0.5])
    feat[6] = 1.0  # red
    feat[9] = 1.0  # depth
    return dict(data=feat.to(dev).contiguous(),
                starts=torch.zeros(1, dtype=torch.int32, device=dev),
                counts=torch.full((1,), 129, dtype=torch.int32, device=dev),
                tiles_x=1, tiles_y=1, pairs=129, chunk=128, tile_px=16)


def random_scene(rng, n, device):
    """A seeded random Gaussian cloud around the origin (numpy seed)."""
    import numpy as np

    from dge_tpu_torch.scene import gaussians as G

    rot = rng.normal(size=(n, 4)).astype(np.float32)
    return G.from_arrays(
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.5,
        rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.1,
        rng.uniform(-1.0, 3.0, size=(n, 1)).astype(np.float32),
        rng.uniform(-3.5, -2.0, size=(n, 3)).astype(np.float32),
        rot / np.linalg.norm(rot, axis=1, keepdims=True),
        max_sh_degree=1, device=device)


def bench_camera(height, width, device):
    import numpy as np

    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.scene.cameras import look_at_camera

    cam = look_at_camera(np.array([2.3, 0.9, -2.3]),
                         np.array([0.0, -0.45, 0.0]), fovx=math.radians(60),
                         height=height, width=width)
    return CameraArrays.from_camera(cam, device=device)


def full_width_cell(name, scene, cam, bg, *, chunk=64, **start):
    """Probe a spill-free renderer, then time the whole render, the kernel
    alone and the plain version on the frame's stream."""
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.ops import render as R

    r = R.SpillFreeRenderer(scene, bg, tile_px=32, chunk=chunk,
                            log=lambda m: log(f"  [{name}] {m}"), **start)
    if r.probe(cam) != 0:
        raise AssertionError(f"{name}: spill after the ladder")
    out = r.render(cam)
    if int(out.spill) != 0 or not bool(torch.isfinite(out.color).all()):
        raise AssertionError(f"{name}: spill or non-finite colour")
    inp = stream_inputs(scene, cam, r.caps, r.tight_cull, 32, chunk)
    err = kernel_vs_plain(inp, f"{name} kernel vs plain")
    kw = dict(tiles_x=inp["tiles_x"], tile_px=32, chunk=inp["chunk"])
    args = (inp["data"], inp["starts"], inp["counts"])
    render_ms = cuda_ms(lambda: r.render(cam), reps=10)
    kernel_ms = cuda_ms(lambda: PC.composite_pairs_stream(*args, **kw),
                        reps=20)
    plain_ms = cuda_ms(lambda: PC.composite_pairs_reference(*args, **kw),
                       reps=3, warmup=1)
    stages = stage_ms(scene, cam, r.caps, r.tight_cull, 32)
    b_ms, b_by = bound_ms(inp["pairs"], inp["starts"].shape[0], 32)
    cell = dict(cell=name, render_ms=render_ms, **stages, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                pairs=inp["pairs"], tiles=int(inp["starts"].shape[0]),
                chunk=inp["chunk"], caps=r.caps, tight_cull=r.tight_cull,
                max_abs_err=err)
    log(f"  {name}: render {render_ms:.3f} ms/frame, kernel {kernel_ms:.3f} "
        f"ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"pairs {inp['pairs']}, caps {r.caps}, tight_cull {r.tight_cull}")
    log(f"  {name} stages: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in stages.items()))
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dge_tpu_torch import launch
    from dge_tpu_torch.ops import losses as L
    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.utils import saving

    # parity: no TF32 anywhere (the render path itself has no matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    lib = PC.build_library()
    log(f"built {os.path.relpath(lib, ROOT)} in {time.time() - t0:.1f} s")
    with open(lib + ".ptxas.txt") as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # ---- phase 1: kernel vs plain --------------------------------------
    log("phase 1: kernel vs plain")
    errs = []
    fx = boundary_fixture(dev)
    errs.append(kernel_vs_plain(fx, "block-boundary fixture"))
    got = PC.composite_pairs_stream(fx["data"], fx["starts"], fx["counts"],
                                    tiles_x=1, tile_px=16, chunk=128)
    c, t = float(got[0, 0].mean()), float(got[0, 4].mean())
    log(f"  fixture colour {c:.6f} T {t:.6f} (block rule: 0.9975, 0.0025; "
        "hard break: 0.995, 0.005)")
    if abs(c - 0.9975) > 1e-6 or abs(t - 0.0025) > 1e-7:
        raise AssertionError("block-boundary fixture: wrong block semantics")

    rng = np.random.default_rng(0)
    rscene = random_scene(rng, 4000, dev)
    rcam = bench_camera(256, 256, dev)
    for chunk in (128, 256):
        inp = stream_inputs(rscene, rcam, {}, False, 32, chunk)
        errs.append(kernel_vs_plain(inp, f"random scene chunk {chunk}"))
    before = PC.launch_counts["pairs_composite"]
    ko = R.render(rscene, rcam, tile_px=32, max_per_tile=4096)
    po = R.render(rscene, rcam, tile_px=32, max_per_tile=4096,
                  backend="torch")
    if PC.launch_counts["pairs_composite"] != before + 1:
        raise AssertionError("cuda_stream render did not launch the kernel")
    for a, b, tol, what in ((ko.color, po.color, TOL["color"], "colour"),
                            (ko.depth, po.depth, TOL["depth"], "depth"),
                            (ko.alpha, po.alpha, TOL["trans"], "alpha")):
        e = float((a - b).abs().max())
        log(f"  random scene render {what}: max|err| {e:.3e}")
        if e > tol:
            raise AssertionError(f"random scene render {what} {e} > {tol}")

    # ---- phase 2: the main path ----------------------------------------
    log("phase 2: main path (dge_tpu_torch.launch --render, quality-gate "
        "scene over fit_capture at 256^2)")
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="  [%(name)s] %(message)s")
    with tempfile.TemporaryDirectory() as tmp:
        PC.reset_launch_counts()
        run = launch.main(["--render", "--gs_source", QUALITY_PLY,
                           "--source", CAPTURE, "--out", tmp,
                           "data.height=256", "data.width=256"])
        main_launches = dict(PC.launch_counts)
        n_png = len(os.listdir(os.path.join(run.trial_dir, "renders")))
    log(f"  launches during the main path: {main_launches}")
    if main_launches["pairs_composite"] < len(run.frames) + 1:
        raise AssertionError("main path did not go through the kernel")
    if run.spill != 0:
        raise AssertionError(f"main path spill {run.spill} after the ladder")
    if n_png != len(run.frames) or len(run.frames) != 16:
        raise AssertionError(f"expected 16 renders, got {n_png}")
    psnrs = []
    for img, name in zip(run.frames, run.image_names):
        if img.shape != (256, 256, 3) or not np.isfinite(img).all():
            raise AssertionError(f"render {name}: bad shape or non-finite")
        gt = saving.load_image(os.path.join(CAPTURE, "images", name + ".png"))
        psnrs.append(float(L.psnr(torch.from_numpy(img),
                                  torch.from_numpy(gt))))
    mean_psnr = float(np.mean(psnrs))
    log(f"  mean PSNR {mean_psnr:.4f} dB over {len(psnrs)} views "
        f"(min {min(psnrs):.4f}), caps {run.caps}, tight_cull "
        f"{run.tight_cull}")
    if mean_psnr < PSNR_MIN:
        raise AssertionError(f"mean PSNR {mean_psnr} < {PSNR_MIN}")
    # the kernel at the main path's shapes: view 0 of the capture
    qscene = G.load_ply(QUALITY_PLY, device=dev)
    cs = DS.ColmapScene(CAPTURE, height=256, width=256)
    qcam = CameraArrays.from_camera(cs.cameras[0], device=dev)
    inp = stream_inputs(qscene, qcam, run.caps, run.tight_cull, 32, 64)
    errs.append(kernel_vs_plain(inp, "main path view 0"))
    kw = dict(tiles_x=inp["tiles_x"], tile_px=32, chunk=inp["chunk"])
    margs = (inp["data"], inp["starts"], inp["counts"])
    main_ms = cuda_ms(lambda: PC.composite_pairs_stream(*margs, **kw), reps=20)
    main_plain = cuda_ms(lambda: PC.composite_pairs_reference(*margs, **kw),
                         reps=5, warmup=1)
    main_bound, main_by = bound_ms(inp["pairs"], inp["starts"].shape[0], 32)
    log(f"  main path view 0: kernel {main_ms:.4f} ms, plain "
        f"{main_plain:.4f} ms, bound {main_bound:.5f} ms ({main_by}), "
        f"pairs {inp['pairs']}")

    # ---- phase 3: full width -------------------------------------------
    log("phase 3: full width (bench scene; each cell also holds the kernel "
        "against the plain version)")
    bench = G.load_ply(BENCH_PLY, device=dev)
    bg = torch.zeros(3, device=dev)
    cells = [full_width_cell("512x512", bench, bench_camera(512, 512, dev),
                             bg)]
    cam1080 = bench_camera(1080, 1920, dev)
    cells.append(full_width_cell(
        "1920x1080", bench, cam1080, bg, chunk=256, tight_cull=True,
        max_per_tile=2048, max_tiles_per_gaussian=64, small_slots=16,
        max_pairs=3 << 18, big_capacity=16384))
    errs += [c["max_abs_err"] for c in cells]

    kernels = [{
        "name": "pairs_composite",
        "route": "cuda",
        "source": "dge_tpu_torch/csrc/pairs_composite.cu",
        "replaces": "dge_tpu/ops/pallas_composite.py:232",
        "launches": main_launches["pairs_composite"],
        "max_abs_err": max(errs),
        "ms": main_ms,
        "plain_ms": main_plain,
        "bound_ms": main_bound,
        "bound_by": main_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "cells": cells,
    }]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    result = {"kernels": kernels, "psnr_mean_db": mean_psnr,
              "psnr_views_db": psnrs, "card": smi,
              "seconds": time.time() - t_start}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log('kernels: ["pairs_composite"]')
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
