"""Times of the per-tile-list kernel K2 (``tiles_composite.
composite_tiles_kernel``) on one card, at the three operating points of the
list path: the quality-gate scene at 256^2 (capture view 0, the
``--validate --backend cuda_tiles`` path) and the bench scene at 512^2 and
1920x1080, each at the caps a spill-free ``cuda_tiles`` renderer settles on.

    python dge_tpu_torch/tools/list_kernel_times.py [--root DIR] [--json PATH]

``--root`` names the checkout whose ``dge_tpu_torch`` is timed (default: the
one this file is in), so that two trees are compared in one run on one card
(run the file by its path: the package is imported from ``--root``). Per
cell it prints the entries, the CUDA-event median of one wrapper call and,
from a ``torch.profiler`` trace, the device time of every CUDA kernel the
call launches, summed and by name (no host time). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ROOT = os.path.dirname(os.path.dirname(HERE))


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms."""
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


def device_ms(fn, calls: int = 10) -> dict:
    """Device time per call of every CUDA kernel ``fn`` launches, in ms,
    from a torch.profiler trace: the sum and each kernel by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        by_name[e.key[:70]] = (us / calls / 1e3, e.count / calls)
    return dict(total=sum(ms for ms, _ in by_name.values()),
                kernels=dict(sorted(by_name.items(), key=lambda kv: -kv[1][0])))


def list_inputs(scene, cam, caps, tight_cull, chunk):
    """K2's inputs for one frame at tile 32, as render(backend="cuda_tiles")
    forms them."""
    from dge_tpu_torch.ops import binning as B
    from dge_tpu_torch.ops import projection as P
    from dge_tpu_torch.ops import tiles_composite as TT

    prep = P.preprocess(scene.xyz, scene.get_scaling, scene.get_rotation,
                        scene.get_opacity, scene.get_features, scene.alive,
                        cam, scene.active_sh_degree, scene.max_sh_degree)
    bins = B.bin_gaussians(
        prep.mean2d, prep.depth, prep.radius, prep.visible, height=cam.height,
        width=cam.width, tile_px=32, max_per_tile=caps["max_per_tile"],
        max_tiles_per_gaussian=caps["max_tiles_per_gaussian"],
        conic=prep.conic if tight_cull else None,
        opacity=prep.opacity if tight_cull else None)
    if int(bins.spill) != 0:
        raise AssertionError(f"list binning spills at {caps}")
    return dict(feat=TT.feature_table(prep.mean2d, prep.conic, prep.rgb,
                                      prep.depth, prep.opacity),
                lists=bins.lists.contiguous(), counts=bins.counts.contiguous(),
                tiles_x=bins.tiles_x, chunk=max(chunk, 128))


def scenes(dev) -> dict:
    """What the timing tools render: the quality-gate scene, the committed
    capture (its path) and its view 0 at 256^2, the bench scene, and
    ``bench_cam(h, w)``, the bench scene's camera at any size."""
    import numpy as np

    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.scene.cameras import look_at_camera

    outputs = os.path.join(DEFAULT_ROOT, "outputs")
    capture = os.path.join(outputs, "fit_capture")

    def bench_cam(h, w):
        return CameraArrays.from_camera(look_at_camera(
            np.array([2.3, 0.9, -2.3]), np.array([0.0, -0.45, 0.0]),
            fovx=math.radians(60), height=h, width=w), device=dev)

    return dict(
        quality=G.load_ply(os.path.join(
            outputs, "quality_gate", "20260821-064841", "fitdemo",
            "tpu@20260821-064841", "point_cloud.ply"), device=dev),
        capture=capture,
        cam0=CameraArrays.from_camera(DS.ColmapScene(
            capture, height=256, width=256).cameras[0], device=dev),
        bench=G.load_ply(os.path.join(outputs, "bench_scene",
                                      "point_cloud.ply"), device=dev),
        bench_cam=bench_cam)


def pair_stream(scene, cam, r, tile_px: int = 32):
    """One frame's pair binning at the spill-free renderer ``r``'s caps and
    K1's stream features over it, as render() forms them → (bins, data)."""
    from dge_tpu_torch.ops import binning as B
    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.ops import projection as P

    prep = P.preprocess(scene.xyz, scene.get_scaling, scene.get_rotation,
                        scene.get_opacity, scene.get_features, scene.alive,
                        cam, scene.active_sh_degree, scene.max_sh_degree)
    caps = {k: v for k, v in r.caps.items() if k != "tight_cull"}
    pb = B.bin_gaussians_pairs(
        prep.mean2d, prep.depth, prep.radius, prep.visible,
        height=cam.height, width=cam.width, tile_px=tile_px,
        conic=prep.conic if r.tight_cull else None,
        opacity=prep.opacity if r.tight_cull else None, **caps)
    return pb, PC.assemble_stream_data(pb.pair_ids, prep.mean2d, prep.conic,
                                       prep.rgb, prep.depth, prep.opacity)


def cells(dev):
    """(name, scene, camera, renderer chunk, renderer start) of each cell."""
    s = scenes(dev)
    return [
        ("256x256 view 0", s["quality"], s["cam0"], 64, {}),
        ("512x512", s["bench"], s["bench_cam"](512, 512), 64,
         dict(tight_cull=True, max_tiles_per_gaussian=256)),
        ("1920x1080", s["bench"], s["bench_cam"](1080, 1920), 256,
         dict(tight_cull=True, max_per_tile=2048,
              max_tiles_per_gaussian=256))]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT,
                    help="checkout whose dge_tpu_torch is timed")
    ap.add_argument("--json", default=None, help="also write the results")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("list_kernel_times: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.ops import tiles_composite as TT

    import dge_tpu_torch
    dev = torch.device("cuda")
    out = dict(root=os.path.abspath(args.root),
               package=os.path.dirname(dge_tpu_torch.__file__),
               card=torch.cuda.get_device_name(0), cells={})
    for name, scene, cam, chunk, start in cells(dev):
        r = R.SpillFreeRenderer(scene, torch.zeros(3, device=dev), tile_px=32,
                                chunk=chunk, backend="cuda_tiles", **start)
        if r.probe(cam) != 0:
            raise AssertionError(f"{name}: spill after the ladder")
        inp = list_inputs(scene, cam, r.caps, r.tight_cull, chunk)

        def call():
            return TT.composite_tiles_kernel(
                inp["feat"], inp["lists"], inp["counts"], None,
                tiles_x=inp["tiles_x"], tile_px=32, chunk=inp["chunk"])

        dev_times = device_ms(call)
        cell = dict(entries=int(inp["counts"].sum()),
                    fullest_tile=int(inp["counts"].max()),
                    list_width=int(inp["lists"].shape[1]), chunk=inp["chunk"],
                    event_ms=event_ms(call), device_ms=dev_times["total"],
                    device_kernels=dev_times["kernels"])
        out["cells"][name] = cell
        print(f"{name}: {json.dumps(cell)}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
