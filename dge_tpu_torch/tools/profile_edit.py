"""Edit-round roofline decomposition on one CUDA card.

JAX counterpart: ``tools/profile_edit.py``. Breaks one edit round of the
guidance at the JAX package's measured workload (20 views at 512^2, the
full-width SD-1.5 InstructPix2Pix networks in bf16 on random weights,
camera batches of 5, banded epipolar; configs/dge.yaml:36,54,75-76) into
its stages and gives for each: CUDA-event ms (median of ``--iters`` calls
after one warm-up), GFLOP (``torch.utils.flop_counter.FlopCounterMode``
over one call: matrix products, convolutions and attention; elementwise
work counts nothing, so the DDIM update and the cross-view state show 0),
achieved TFLOP/s, a bound and how many times its bound the stage takes.

Stage structure of one 20-step round (systems/guidance.py):
  enc (VAE sample + cond) + 18 pivot-path steps x [4x cross-view state +
  pivot pass (12) + 1x reuse n_key=1 (15) + 3x reuse n_key=2 (15) + DDIM]
  + 2 plain steps x [4x plain pass (15) + DDIM] + dec.

Bound = the larger of the stage's FLOPs at the card's peak for the
networks' dtype (989 TFLOP/s dense bf16, 67 TFLOP/s f32: TF32 stays off, as
everywhere in the port) and its bytes at 3.35 TB/s (the stage's inputs and
outputs and the weights of the networks it runs, each read or written
once). For bf16 networks it is a lower bound. For f32 networks the reuse
match runs on the bf16 tensor cores (three bf16 products a product,
``layers.bf16_terms``) while its FLOPs count at the f32 rate.

    python -m dge_tpu_torch.tools.profile_edit [--dtype bfloat16|float32]
        [--iters 3] [--out outputs/profile_edit_cuda.md]

prints the table with the card's ``nvidia-smi`` name and power limit and
writes it to ``--out`` (the JAX tool's TPU table is
``outputs/profile_edit.md``). ``--tiny --cpu`` runs the tiny networks at 64^2
(4 views, camera batches of 2) on the CPU as a plumbing check: its times
are the host clock's, not a device's.
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import subprocess
import time

import numpy as np
import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# the round's counts (the JAX tool's; --tiny keeps them): 20 DDIM steps,
# 18 of them at t >= 100 in a round from t = 979, 4 camera batches a step
STEPS = 20
PIVOT_STEPS = 18
BATCHES = 4
T_MID = 541


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in ``obj`` (tensors, containers, dataclasses
    of tensors)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v) for v in obj)
    if hasattr(obj, "__dataclass_fields__"):
        return sum(tensor_bytes(getattr(obj, k))
                   for k in obj.__dataclass_fields__)
    return 0


def timed(fn, iters: int, device: torch.device):
    """(median ms, the last call's output): CUDA events on a card, the host
    clock on the CPU."""
    out = fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def flops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--out", default="outputs/profile_edit_cuda.md")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny networks at 64^2 (plumbing check)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (host-clock times)")
    args = ap.parse_args(argv)

    from dge_tpu_torch import resolve_device
    from dge_tpu_torch.diffusion import ddim
    from dge_tpu_torch.diffusion import ip2p as P
    from dge_tpu_torch.parallel.mesh import index_cameras, stack_cameras
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.scene.cameras import look_at_camera
    from dge_tpu_torch.systems.guidance import (GuidanceConfig,
                                                make_cross_view_state)

    device = resolve_device("cpu" if args.cpu else "cuda")
    dtype = getattr(torch, args.dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tiny:
        from dge_tpu_torch.models.clip_text import CLIPTextConfig
        from dge_tpu_torch.models.unet import UNetConfig
        from dge_tpu_torch.models.vae import VAEConfig

        b, h, w, cbs, s_txt = 4, 64, 64, 2, 7
        cfgs = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny())
    else:
        b, h, w, cbs, s_txt = 20, 512, 512, 5, 77
        cfgs = ()
    card = card_line() if device.type == "cuda" else "cpu (host clock)"
    print(f"[profile_edit] building {'tiny' if args.tiny else 'full-size'} "
          f"networks in {args.dtype} on {card}", flush=True)
    models = P.build_models(*cfgs, seed=0, device=device, dtype=dtype)
    n_batches = b // cbs
    gcfg = GuidanceConfig(camera_batch_size=cbs, epipolar_mode="banded")
    ucfg = models.unet.config
    unet_w = tensor_bytes(list(models.unet.parameters()))
    vae_w = tensor_bytes(list(models.vae.parameters()))

    cams = []
    for i in range(b):
        ang = 2 * math.pi * i / b
        eye = np.array([3.5 * math.sin(ang), 0.3, -3.5 * math.cos(ang)])
        cams.append(CameraArrays.from_camera(look_at_camera(
            eye, np.zeros(3), fovx=math.radians(60), height=h, width=w),
            device))
    cam_batch = stack_cameras(cams)

    r = np.random.default_rng(2)
    rgb = torch.from_numpy(r.uniform(size=(b, h, w, 3)).astype(
        np.float32)).to(device)
    cond = torch.from_numpy(r.uniform(size=(b, h, w, 3)).astype(
        np.float32)).to(device)
    emb = torch.from_numpy((r.normal(size=(
        b, s_txt, ucfg.cross_attention_dim)) * 0.02).astype(
        np.float32)).to(device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(3)
    rows = []
    peak = PEAK_FLOPS[dtype]

    def stage(name, count, fn, inputs, weights=0):
        """Time ``fn``, count its FLOPs and bytes, add its row."""
        ms, out = timed(fn, args.iters, device)
        fl = flops(fn)
        nbytes = tensor_bytes(inputs) + tensor_bytes(out) + weights
        t_ops, t_bytes = fl / peak, nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes)
        rows.append(dict(
            stage=name, count=count, ms=ms, gflop=fl / 1e9,
            tflops=fl / (ms * 1e-3) / 1e12 if ms else 0.0,
            bound_ms=bound * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            ratio=ms / (bound * 1e3) if bound else float("nan")))
        print(f"[profile_edit] {name}: {ms:.3f} ms, {fl / 1e9:.1f} GFLOP, "
              f"bound {bound * 1e3:.3f} ms", flush=True)
        return out

    # ---- VAE encode ----
    latents = stage("VAE encode sample", 1, lambda: P.encode_images(
        models, rgb, gen, chunk=5), rgb, vae_w)
    cond_lat = stage("VAE encode cond", 1, lambda: P.encode_cond_images(
        models, cond, chunk=5), cond, vae_w)
    lat_h, lat_w = latents.shape[1], latents.shape[2]
    cond_img, _, cond_zero = cond_lat.chunk(3, dim=0)

    def triple_for(idx):
        return (torch.cat([emb[idx], emb[idx], emb[idx]], 0),
                torch.cat([cond_img[idx], cond_img[idx], cond_zero[idx]], 0))

    noise = torch.randn(latents.shape, generator=gen, device=device).to(
        latents.dtype)
    noisy = ddim.add_noise(models.schedule, latents, noise, T_MID)

    # ---- cross-view state (banded epipolar), one camera batch ----
    piv_off = (np.arange(n_batches) * 2 + 1) % cbs
    pivotal = torch.as_tensor(piv_off + np.arange(0, b, cbs), device=device)
    key_cams = index_cameras(cam_batch, pivotal)
    sl0 = torch.arange(cbs, 2 * cbs, device=device)
    cams_b = index_cameras(cam_batch, sl0)
    cv = stage("cross-view state", BATCHES * PIVOT_STEPS,
               lambda: make_cross_view_state(
                   cams_b, key_cams, int(piv_off[1]), lat_h, lat_w, 2,
                   gcfg.epipolar_threshold, gcfg.epipolar_mode),
               (cams_b, key_cams))

    # ---- pivot pass: n_batches pivots x 3 CFG chunks ----
    te_p, cl_p = triple_for(pivotal)
    inp_p = torch.cat([P.triple(noisy[pivotal]), cl_p], dim=-1)
    record: dict = {}
    stage("UNet pivot pass", PIVOT_STEPS, lambda: P.unet_eps(
        models, inp_p, T_MID, te_p, mode="pivot_record", pivot=record),
        (inp_p, te_p), unet_w)

    # ---- reuse pass, 2 keys (3 of the 4 batches a step) ----
    te_b, cl_b = triple_for(sl0)
    inp_b = torch.cat([P.triple(noisy[sl0]), cl_b], dim=-1)
    stage("UNet reuse pass (2-key)", (BATCHES - 1) * PIVOT_STEPS,
          lambda: P.unet_eps(models, inp_b, T_MID, te_b, mode="pivot_reuse",
                             cross_view=cv, pivot=record),
          (inp_b, te_b, cv, record), unet_w)

    # ---- reuse pass, 1 key (batch 0) ----
    sl1 = torch.arange(0, cbs, device=device)
    cv1 = make_cross_view_state(
        index_cameras(cam_batch, sl1), key_cams, int(piv_off[0]), lat_h,
        lat_w, 1, gcfg.epipolar_threshold, gcfg.epipolar_mode)
    te_1, cl_1 = triple_for(sl1)
    inp_1 = torch.cat([P.triple(noisy[sl1]), cl_1], dim=-1)
    stage("UNet reuse pass (1-key)", PIVOT_STEPS, lambda: P.unet_eps(
        models, inp_1, T_MID, te_1, mode="pivot_reuse", cross_view=cv1,
        pivot=record), (inp_1, te_1, cv1, record), unet_w)

    # ---- plain pass (the t < 100 tail) ----
    stage("UNet plain pass", BATCHES * (STEPS - PIVOT_STEPS),
          lambda: P.unet_eps(models, inp_b, 50, te_b), (inp_b, te_b),
          unet_w)

    # ---- DDIM update ----
    sched = models.schedule._replace(num_train_timesteps=979)
    eps = (noisy * 0.1).to(dtype)  # any [b, h, w, 4] eps: timing only
    stage("DDIM update", STEPS, lambda: ddim.step(sched, eps, T_MID, noisy,
                                                  STEPS), (eps, noisy))

    # ---- VAE decode ----
    stage("VAE decode", 1, lambda: P.decode_latents(models, latents,
                                                    chunk=5),
          latents, vae_w)

    total = sum(rw["ms"] * rw["count"] for rw in rows) / 1e3
    timing = ("CUDA events" if device.type == "cuda"
              else "the host clock (CPU plumbing check, not a device time)")
    lines = [
        f"# Edit-round roofline decomposition ({card})",
        "",
        f"Workload: {b} views {h}x{w}, {args.dtype} "
        f"{'tiny' if args.tiny else 'SD-1.5'} UNet (8ch in), camera batches "
        f"of {cbs}, banded epipolar; {PIVOT_STEPS} pivot-path + "
        f"{STEPS - PIVOT_STEPS} plain DDIM steps. Times: {timing}, median of "
        f"{args.iters}.",
        "",
        "| stage | x/round | ms | GFLOP | achieved TFLOP/s | bound ms "
        "| bound by | x bound |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for rw in rows:
        lines.append(
            f"| {rw['stage']} | {rw['count']} | {rw['ms']:.3f} | "
            f"{rw['gflop']:.1f} | {rw['tflops']:.2f} | {rw['bound_ms']:.3f} "
            f"| {rw['bound_by']} | {rw['ratio']:.2f} |")
    lines += [
        "",
        f"Reconstructed round = sum(stage ms x count) = **{total:.3f} s**.",
        "",
        f"Bound: FLOPs (FlopCounterMode) at {peak / 1e12:.0f} TFLOP/s "
        f"({args.dtype}), or bytes (inputs, outputs, weights once) at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, whichever is larger.",
    ]
    table = "\n".join(lines)
    print(table, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(table + "\n")
    print(f"[profile_edit] wrote {args.out}", flush=True)
    return dict(rows=rows, round_s=total, card=card, dtype=args.dtype,
                views=b, size=h, camera_batch=cbs)


if __name__ == "__main__":
    main()
