"""A/B of two formulations of the pair-stream forward kernel on one stream:
the production kernel (running product of ``1 - alpha`` inside a block) and
the log-space arm (running SUM of ``log(1 - alpha)``, one ``exp`` per pair).

JAX counterpart: ``tools/proto_logdot.py`` (``_pairs_kernel_v2``, mode
``logdot``), which forms the prefix as ``exp(L @ log(1 - alpha))`` with a
lower-triangular ones matrix on the TPU's matrix unit. A prefix sum is a
product with a triangular matrix, which tensor cores can take; a prefix
product is not: this arm is the formulation to weigh when the production
kernel is redesigned. The tool's other two modes (``roll``, ``two_level``)
are two ways to form the same cumprod on the TPU and have no kernel of their
own here: on this card ``pairs_composite.cu`` already is that function.

The log-space kernels are ``dge_tpu_torch/csrc/pairs_logdot.cu`` (K1's row
+ combine split in log space, ``pair_rows_forward.cuh``);
``composite_pairs_logdot`` is their wrapper (CUDA tensors: the kernels or an
error; CPU tensors: the plain version) and
``composite_pairs_logdot_reference`` its plain PyTorch version; the plain
versions of each kernel alone are ``pairs_composite.rows_forward_reference``
and ``rows_combine_reference`` with ``log_space=True``.

Usage:
  python -m dge_tpu_torch.tools.proto_logdot [--ply scene.ply]
      [--height 512 --width 512] [--chunk 128] [--cpu]

renders the scene's stream at spill-free caps through both kernels, prints
their CUDA-event times and max|dcolor|, and returns the numbers. With
``--cpu`` both wrappers take their plain versions and no time is reported.
"""

from __future__ import annotations

import argparse
import math
import os
import statistics

import torch

from dge_tpu_torch.ops import pairs_composite as PC

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_PLY = os.path.join(_REPO, "outputs", "bench_scene", "point_cloud.ply")
# agreement with the production kernel and with the plain version
TOL = {"color": 1e-4, "depth": 1e-3, "trans": 2e-4}


def composite_pairs_logdot_reference(data, starts, counts, *, tiles_x: int,
                                     tile_px: int, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of the log-space kernel → [T, 5, P]: the
    production kernel's plain version with ``exp(cumsum(log(1-eff)))`` in
    place of ``cumprod(1-eff)``."""
    return PC.composite_pairs_reference(data, starts, counts, tiles_x=tiles_x,
                                        tile_px=tile_px, chunk=chunk,
                                        log_prefix=True)


def composite_pairs_logdot(data, starts, counts, *, tiles_x: int,
                           tile_px: int, chunk: int) -> torch.Tensor:
    """The log-space kernels' wrapper → [T, 5, P], with the contract of
    ``pairs_composite.composite_pairs_stream``: on CUDA tensors it launches
    K5's row kernel and its combine kernel or raises, and never falls back;
    on CPU tensors it takes the plain version."""
    on_cpu = PC.check_rows("composite_pairs_logdot", (
        ("data", data, torch.float32, None),
        ("starts", starts, torch.int32, None),
        ("counts", counts, torch.int32, None)), data, starts.shape[0],
        tile_px, chunk)
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    if on_cpu:
        return composite_pairs_logdot_reference(data, starts, counts, **kw)
    return PC.composite_rows(data, starts, counts, log_space=True, **kw)


def _cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events)."""
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ply", default=BENCH_PLY)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    import numpy as np

    from dge_tpu_torch import resolve_device
    from dge_tpu_torch.ops import binning, projection
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.scene.cameras import look_at_camera

    device = resolve_device("cpu" if args.cpu else "cuda")
    scene = G.load_ply(args.ply, device=device)
    cam = CameraArrays.from_camera(look_at_camera(
        np.array([2.3, 0.9, -2.3]), np.array([0.0, -0.45, 0.0]),
        fovx=math.radians(60), height=args.height, width=args.width),
        device=device)
    renderer = R.SpillFreeRenderer(
        scene, None, tile_px=32, chunk=args.chunk,
        log=lambda m: print(f"[proto_logdot] {m}", flush=True))
    if renderer.probe(cam) != 0:
        raise RuntimeError("spill after the cap ladder: the two kernels "
                           "would be compared on a truncated stream")
    with torch.no_grad():
        prep = projection.preprocess(
            scene.xyz, scene.get_scaling, scene.get_rotation,
            scene.get_opacity, scene.get_features, scene.alive, cam,
            scene.active_sh_degree, scene.max_sh_degree)
        cull = renderer.tight_cull
        pb = binning.bin_gaussians_pairs(
            prep.mean2d, prep.depth, prep.radius, prep.visible,
            height=cam.height, width=cam.width, tile_px=32,
            conic=prep.conic if cull else None,
            opacity=prep.opacity if cull else None, **renderer.caps)
        data = PC.assemble_stream_data(pb.pair_ids, prep.mean2d, prep.conic,
                                       prep.rgb, prep.depth, prep.opacity)
    args_k = (data, pb.starts.contiguous(), pb.counts.contiguous())
    kw = dict(tiles_x=pb.tiles_x, tile_px=32, chunk=max(args.chunk, 128))
    old = PC.composite_pairs_stream(*args_k, **kw)
    new = composite_pairs_logdot(*args_k, **kw)
    diff = (new - old).abs()
    res = dict(
        pairs=int(pb.counts.sum()), tiles=int(pb.starts.shape[0]),
        chunk=kw["chunk"], device=str(device),
        max_dcolor=float(diff[:, 0:3].max()),
        mean_dcolor=float(diff[:, 0:3].mean()),
        max_ddepth=float(diff[:, 3].max()),
        max_dtrans=float(diff[:, 4].max()),
        k1_ms=None, k5_ms=None)
    if device.type == "cuda":
        res["k1_ms"] = _cuda_ms(
            lambda: PC.composite_pairs_stream(*args_k, **kw))
        res["k5_ms"] = _cuda_ms(lambda: composite_pairs_logdot(*args_k, **kw))
        print(f"old (running product): {res['k1_ms']:.3f} ms", flush=True)
        print(f"new (logdot): {res['k5_ms']:.3f} ms", flush=True)
    print(f"logdot: max|dcolor| = {res['max_dcolor']:.3e}, mean = "
          f"{res['mean_dcolor']:.3e}, max|ddepth| = {res['max_ddepth']:.3e}, "
          f"max|dT| = {res['max_dtrans']:.3e} over {res['pairs']} pairs",
          flush=True)
    if not (res["max_dcolor"] <= TOL["color"]
            and res["max_ddepth"] <= TOL["depth"]
            and res["max_dtrans"] <= TOL["trans"]):
        raise AssertionError(f"logdot disagrees with the production kernel "
                             f"beyond {TOL}: {res}")
    return res


if __name__ == "__main__":
    main()
