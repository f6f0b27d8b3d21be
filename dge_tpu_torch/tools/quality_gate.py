"""Standing quality gate: fit a capture, validate the fit, gate its PSNR.

JAX counterpart: ``tools/quality_gate.py``. It runs ``launch --fit``
(6,000 steps with densification by default) on the committed 16-view
capture ``outputs/fit_capture`` (or ``--source``, with its ``cfg.yaml``),
then ``launch --validate`` (every view rendered spill-free, PSNR / SSIM /
LPIPS), and exits 1 if the evaluation PSNR falls below ``--min-psnr``
(40 dB) or any view still spills. ``--quick`` is the per-round tripwire: 1,500 steps, gate
28 dB. ``--local`` adds the local-editing gate: a short masked edit
(``--train --smoke`` with the tiny networks, centre-disk masks, geometry
learning rates near zero) whose renders outside the mask must match the
original scene (``--local-min-psnr``, 35 dB) while the masked region
changes; ``--ply`` runs it on an existing fit, ``--local-eval ORIG EDITED``
re-scores an existing pair. Reference analog of the scores:
gaussiansplatting/metrics.py:36-93.

Both steps run in this process through ``dge_tpu_torch.launch.main`` (the
JAX tool's ``--inproc`` existed for its TPU's one-process chip claim and is
not needed here). Dotted overrides (``data.height=64``) reach both steps;
``--cpu`` runs them on the CPU. The summary is one JSON line: the
evaluation's ``psnr`` / ``ssim`` / ``lpips`` / ``n_gaussians`` / ``spill``,
``steps``, ``fit_s``, the fit's ``fit_steps_per_s``, ``train_psnr`` (mean
of its last 100 steps), ``n_alive``, ``peak_mem_gib`` on a card, the gate,
and ``pass``.

Usage:
  python -m dge_tpu_torch.tools.quality_gate [--steps 6000] [--min-psnr 40] \\
      [--quick] [--local] [--source DIR] [--cpu] \\
      [--out DIR] [key=value ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIT_CAPTURE = os.path.join(REPO, "outputs", "fit_capture")


def _run_launch(argv):
    """``launch.main(argv)`` in this process → (exit code, its result)."""
    from dge_tpu_torch import launch

    print("[quality_gate] launch", " ".join(argv), flush=True)
    try:
        return 0, launch.main(argv)
    except SystemExit as e:  # launch.main exits on usage errors
        return int(e.code or 0), None


def _disk_mask(h, w, frac=0.28):
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = (yy - h / 2) ** 2 + (xx - w / 2) ** 2
    return (r2 <= (frac * min(h, w)) ** 2).astype(np.float32)


def run_local_gate(args, ply: str, out_root: str) -> dict:
    """The local-editing gate: a short masked edit (precomputed centre-disk
    masks, ``--smoke`` tiny networks, geometry learning rates near zero:
    the shape of the reference's local-editing recipes), then
    ``local_eval`` of the original against the edited scene."""
    from dge_tpu_torch.utils import saving

    h = w = 256
    masks_dir = os.path.join(out_root, "masks")
    disk = _disk_mask(h, w)
    for vid in range(16):
        saving.save_image(os.path.join(masks_dir, f"{vid:04d}.png"),
                          np.repeat(disk[..., None], 3, -1))
    cfg_path = os.path.join(out_root, "local_cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"""name: localedit
tag: gpu
data:
  height: {h}
  width: {w}
  max_view_num: 8
system:
  model_size: tiny
  prompt: "make the object red"
  segmentor: precomputed
  mask_dir: {masks_dir}
  guidance:
    resize_target: 64
    diffusion_steps: 5
    camera_batch_size: 4
  edit:
    seg_prompt: "object"
    mask_thres: 0.8
    max_steps: 200
    camera_update_per_step: 100
    camera_batch_size: 4
    max_view_num: 8
    densify_until: 0
    gs_lr_scaler: 1.0e-4
    gs_final_lr_scaler: 1.0e-4
    scaling_lr_scaler: 1.0e-4
    rotation_lr_scaler: 1.0e-4
    opacity_lr_scaler: 1.0e-4
    color_lr_scaler: 3.0
""")
    edit_args = ["--train", "--smoke", "--gs_source", ply, "--source",
                 FIT_CAPTURE, "--out", out_root, "--config", cfg_path]
    if args.cpu:
        edit_args.append("--cpu")
    rc, run = _run_launch(edit_args)
    if rc != 0 or run is None:
        sys.exit("[quality_gate] local edit FAILED")
    return local_eval(args, ply, run.ply_path)


def local_eval(args, ply: str, edited_ply: str) -> dict:
    """Spill-free renders of the original and the edited scene on 4 views
    of the capture, compared outside (PSNR, the worst view) and inside (mean
    absolute change, the largest view) the centre disk."""
    import torch

    from dge_tpu_torch import resolve_device
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays

    device = resolve_device("cpu" if args.cpu else "cuda")
    h = w = 256
    dm = _disk_mask(h, w) > 0.5
    orig = G.load_ply(ply, device=device)
    edited = G.load_ply(edited_ply, device=device)
    cams = DS.ColmapScene(FIT_CAPTURE, height=h, width=w).cameras
    bg = torch.zeros(3, device=device)
    r_orig = R.SpillFreeRenderer(orig, bg, tile_px=32)
    r_edit = R.SpillFreeRenderer(edited, bg, tile_px=32)
    probe = CameraArrays.from_camera(cams[0], device=device)
    assert r_orig.probe(probe) == 0, "orig render still spills"
    assert r_edit.probe(probe) == 0, "edited render still spills"
    un_psnrs, in_deltas = [], []
    for cam in cams[::4][:4]:
        ca = CameraArrays.from_camera(cam, device=device)
        a_img, sp_a = r_orig(ca)
        b_img, sp_b = r_edit(ca)
        assert sp_a == 0 and sp_b == 0, (sp_a, sp_b)
        a, b = a_img.cpu().numpy(), b_img.cpu().numpy()
        out_mse = float((((a - b) ** 2).mean(-1))[~dm].mean())
        un_psnrs.append(-10.0 * np.log10(max(out_mse, 1e-12)))
        in_deltas.append(float(np.abs(a - b).mean(-1)[dm].mean()))
    un_psnr, in_delta = float(min(un_psnrs)), float(max(in_deltas))
    res = {
        "local_unmasked_psnr_db": round(un_psnr, 2),
        "local_masked_mean_delta": round(in_delta, 4),
        "local_edited_ply": os.path.abspath(edited_ply),
        "local_pass": bool(un_psnr >= args.local_min_psnr
                           and in_delta >= 0.005),
    }
    print(json.dumps(res))
    verdict = "PASS" if res["local_pass"] else "FAIL"
    print(f"[quality_gate] LOCAL {verdict}: unmasked {un_psnr:.1f} dB (gate "
          f"{args.local_min_psnr}), masked delta {in_delta:.4f} (gate "
          "0.005)", file=sys.stderr)
    return res


def _peak_mem_gib():
    import torch

    if not torch.cuda.is_available():
        return None
    return round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--min-psnr", type=float, default=40.0)
    ap.add_argument("--local", action="store_true",
                    help="also run the local-editing gate (masked edit; "
                    "the unmasked region must match the original, the "
                    "masked region must change)")
    ap.add_argument("--local-min-psnr", type=float, default=35.0)
    ap.add_argument("--ply", default=None,
                    help="reuse a fitted PLY (skip fit + validate; only "
                    "meaningful with --local)")
    ap.add_argument("--local-eval", nargs=2, metavar=("ORIG", "EDITED"),
                    default=None,
                    help="re-score an existing local-edit pair (spill-free "
                    "renders) without re-running the edit")
    ap.add_argument("--quick", action="store_true",
                    help="per-round tripwire: 1,500 steps, gate 28 dB")
    ap.add_argument("--source", default=FIT_CAPTURE,
                    help="COLMAP capture to fit (default: the committed "
                    "outputs/fit_capture)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out", default=os.path.join(REPO, "outputs",
                                                  "quality_gate"))
    ap.add_argument("overrides", nargs="*",
                    help="dotted key=value overrides for fit and validate")
    args = ap.parse_intermixed_args(argv)
    if args.quick:
        args.steps = min(args.steps, 1500)
        args.min_psnr = min(args.min_psnr, 28.0)

    out_root = os.path.join(args.out, time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(out_root, exist_ok=True)
    if args.local_eval:
        res = local_eval(args, *args.local_eval)
        return 0 if res["local_pass"] else 1
    if args.local and args.ply:
        res = run_local_gate(args, args.ply, out_root)
        return 0 if res["local_pass"] else 1

    common = ["--source", args.source, "--out", out_root, "--config",
              os.path.join(args.source, "cfg.yaml")]
    common += ["--cpu"] if args.cpu else []
    rc, fit = _run_launch(["--fit", *common,
                           f"trainer.max_steps={args.steps}",
                           *args.overrides])
    if rc != 0 or fit is None:
        sys.exit("[quality_gate] fit FAILED")
    rc, val = _run_launch(["--validate", "--gs_source", fit.ply_path,
                           *common, *args.overrides])
    if rc != 0 or val is None:
        sys.exit("[quality_gate] validate FAILED")
    (res,) = val.results.values()
    results_path = os.path.join(val.eval_dir, "results.json")

    spill = int(res.get("spill", 0))
    summary = {
        "psnr": round(res["psnr"], 3),
        "ssim": round(res["ssim"], 4),
        "lpips": None if res["lpips"] is None else round(res["lpips"], 6),
        "n_gaussians": res["n_gaussians"],
        "steps": args.steps,
        "fit_s": round(fit.seconds, 1),
        "fit_steps_per_s": round(fit.steps / max(fit.seconds, 1e-9), 2),
        "train_psnr": round(fit.last_psnr, 3),
        "n_alive": fit.n_alive,
        "peak_mem_gib": _peak_mem_gib(),
        "min_psnr": args.min_psnr,
        "spill": spill,
        # a truncated evaluation (spill > 0) must not pass: its score is
        # not the scene's
        "pass": bool(res["psnr"] >= args.min_psnr and spill == 0),
        "results_json": results_path,
    }
    if args.local:
        local_res = run_local_gate(args, fit.ply_path, out_root)
        summary.update(local_res)
        summary["pass"] = bool(summary["pass"] and local_res["local_pass"])
    print(json.dumps(summary))
    if not summary["pass"]:
        print(f"[quality_gate] FAIL: PSNR {res['psnr']:.2f} (gate "
              f"{args.min_psnr}), eval spill {spill} (gate 0)",
              file=sys.stderr)
        return 1
    print(f"[quality_gate] PASS: PSNR {res['psnr']:.2f} >= {args.min_psnr}, "
          "spill 0", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s] %(asctime)s %(message)s")
    sys.exit(main())
