"""Times of the ordered fold (``pairs_backward.fold_to_gaussians``) and of
the 512^2 train step on one card: the quality-gate scene at 256^2 (capture
view 0) and the bench scene at 512^2, each at the caps a spill-free
renderer settles on.

    python dge_tpu_torch/tools/fold_times.py [--root DIR] [--json PATH]

``--root`` names the checkout whose ``dge_tpu_torch`` is timed (default: the
one this file is in), so that two trees are compared in one run on one card
(run the file by its path: the package is imported from ``--root``). A tree
whose binning hands the fold its layout (``PairBins.fold_layout``) gets it;
an older tree's fold sorts the pair ids itself. Per cell it prints the
pairs, the CUDA-event median of one fold call and, from a
``torch.profiler`` trace, the device time and launches of every CUDA kernel
the call launches, and the same of ``index_add_`` over the same inputs. The
512^2 train step: the CUDA-event median of a step, and from a trace of 10
steps the device ms and launches a step. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ROOT = os.path.dirname(os.path.dirname(HERE))
TILE_PX = 32
CHUNK = 64  # the renderer's; the stream kernels run at max(chunk, 128)


def stream_grads(scene, cam, r, dev):
    """The binning of one frame at ``r``'s caps and the pass-2 gradients of
    a seeded random cotangent over it, as the ``cuda_train`` backward forms
    them → (bins, pair_grads, used)."""
    import torch

    from dge_tpu_torch.ops import binning as B
    from dge_tpu_torch.ops import pairs_backward as PB
    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.ops import projection as P

    prep = P.preprocess(scene.xyz, scene.get_scaling, scene.get_rotation,
                        scene.get_opacity, scene.get_features, scene.alive,
                        cam, scene.active_sh_degree, scene.max_sh_degree)
    caps = {k: v for k, v in r.caps.items() if k != "tight_cull"}
    pb = B.bin_gaussians_pairs(
        prep.mean2d, prep.depth, prep.radius, prep.visible,
        height=cam.height, width=cam.width, tile_px=TILE_PX,
        conic=prep.conic if r.tight_cull else None,
        opacity=prep.opacity if r.tight_cull else None, **caps)
    data = PC.assemble_stream_data(pb.pair_ids, prep.mean2d, prep.conic,
                                   prep.rgb, prep.depth, prep.opacity)
    starts, counts = pb.starts.contiguous(), pb.counts.contiguous()
    chunk = max(CHUNK, 128)
    kw = dict(tiles_x=pb.tiles_x, tile_px=TILE_PX, chunk=chunk)
    gen = torch.Generator(device="cpu").manual_seed(0)
    cot = torch.randn(starts.shape[0], 5, TILE_PX ** 2, generator=gen).to(dev)
    blk_off, row_tile, n_rows = PB.block_rows(starts, counts, chunk,
                                              data.shape[1])
    fwd, bt = PC.composite_pairs_stream(data, starts, counts,
                                        boundary_rows=(blk_off, n_rows), **kw)
    _, suf = PB.pairs_pass1(data, starts, counts, blk_off, n_rows, cot,
                            boundary_t=bt, row_tile=row_tile, **kw)
    grads = PB.pairs_pass2(data, starts, counts, blk_off, row_tile, cot, fwd,
                           bt, suf, **kw)
    return pb, grads, (starts + counts).max()


def fold_cell(scene, cam, r, dev) -> dict:
    import torch

    from dge_tpu_torch.ops import pairs_backward as PB
    from dge_tpu_torch.tools.list_kernel_times import device_ms, event_ms

    pb, grads, used = stream_grads(scene, cam, r, dev)
    n = scene.capacity
    layout = ({"layout": pb.fold_layout()} if hasattr(pb, "fold_layout")
              else {})

    def fold():
        return PB.fold_to_gaussians(grads, pb.pair_ids, n, used, **layout)

    def index_add():
        return torch.zeros(10, n, device=dev).index_add_(
            1, pb.pair_ids.long(), grads)

    fold_dev, lib_dev = device_ms(fold), device_ms(index_add)
    return dict(pairs=int(pb.counts.sum()), used=int(used), gaussians=n,
                caps=r.caps, fold_event_ms=event_ms(fold),
                fold_device_ms=per_call_ms(fold_dev),
                fold_launches=sum(c for _, c in fold_dev["kernels"].values()),
                fold_kernels=fold_dev["kernels"],
                index_add_event_ms=event_ms(index_add),
                index_add_device_ms=per_call_ms(lib_dev))


def per_call_ms(times: dict) -> float:
    """Device ms of one call from ``device_ms``'s listing: each kernel's
    time per launch times its launches a call, rounded (the card's profiler
    may drop a few records of a trace, which would bias the plain sum)."""
    return sum(ms / c * max(1, round(c)) for ms, c in
               times["kernels"].values() if c > 0)


def train_step_cell(scene, cam, r, dev) -> dict:
    """The 512^2 train step of ``chip_smoke.py`` phase 5 (seeded random
    target, lambda_dssim=0): event ms a step, device ms and launches a step
    from a trace of 10 steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dge_tpu_torch.systems import fit as F
    from dge_tpu_torch.systems import optim as O
    from dge_tpu_torch.tools.list_kernel_times import event_ms

    target = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(cam.height, cam.width, 3)).astype(np.float32)).to(dev)
    bg = torch.zeros(3, device=dev)
    optimizer = O.make_optimizer(O.OptimConfig.scaled(1500))
    params = {k: v.detach() for k, v in scene.params().items()}
    step = F.make_train_step(optimizer, lambda_dssim=0.0, tile_px=TILE_PX,
                             chunk=CHUNK, tight_cull=r.tight_cull,
                             **{k: v for k, v in r.caps.items()
                                if k != "tight_cull"})
    state = [scene, optimizer.init(params),
             F.FitState.create(scene.capacity, dev)]

    def one_step():
        s, o, f, aux = step(*state, cam, target, bg)
        state[:] = [s, o, f]
        return aux

    for _ in range(3):
        one_step()
    ms = event_ms(one_step, reps=10, warmup=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            one_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
                  for e in kernels)
    return dict(step_event_ms=ms, device_ms_per_step=busy_us / 10 / 1e3,
                launches_per_step=sum(e.count for e in kernels) / 10,
                launches_by_kernel={e.key[:70]: e.count / 10
                                    for e in kernels})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT,
                    help="checkout whose dge_tpu_torch is timed")
    ap.add_argument("--json", default=None, help="also write the results")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fold_times: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    import math

    import dge_tpu_torch
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.scene.cameras import look_at_camera

    dev = torch.device("cuda")
    outputs = os.path.join(DEFAULT_ROOT, "outputs")
    quality = G.load_ply(os.path.join(
        outputs, "quality_gate", "20260821-064841", "fitdemo",
        "tpu@20260821-064841", "point_cloud.ply"), device=dev)
    cs = DS.ColmapScene(os.path.join(outputs, "fit_capture"), height=256,
                        width=256)
    bench = G.load_ply(os.path.join(outputs, "bench_scene",
                                    "point_cloud.ply"), device=dev)
    cam512 = CameraArrays.from_camera(look_at_camera(
        np.array([2.3, 0.9, -2.3]), np.array([0.0, -0.45, 0.0]),
        fovx=math.radians(60), height=512, width=512), device=dev)
    out = dict(root=os.path.abspath(args.root),
               package=os.path.dirname(dge_tpu_torch.__file__),
               card=torch.cuda.get_device_name(0), cells={})
    for name, scene, cam in (
            ("256x256 view 0", quality,
             CameraArrays.from_camera(cs.cameras[0], device=dev)),
            ("512x512", bench, cam512)):
        r = R.SpillFreeRenderer(scene, torch.zeros(3, device=dev),
                                tile_px=TILE_PX, chunk=CHUNK)
        if r.probe(cam) != 0:
            raise AssertionError(f"{name}: spill after the ladder")
        cell = fold_cell(scene, cam, r, dev)
        if name == "512x512":
            cell["train_step"] = train_step_cell(scene, cam, r, dev)
        out["cells"][name] = cell
        print(f"{name}: {json.dumps(cell)}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
