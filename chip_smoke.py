#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dge_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--phases 1,2,3,4,5,6,7,8,9,10]

Builds the hand-written CUDA kernels from the checkout's sources (one nvcc
process per source, started together) and runs:

1. kernels vs plain: K1, the pair-stream compositing as a row kernel and
   a combine kernel (with the ``boundary_T`` the combine stores for the
   backward), and its log-space arm K5 in the same two forms, each kernel
   alone against its plain PyTorch version (``rows_forward_reference``,
   ``rows_combine_reference``) and the two together against the plain
   forward, on the block-boundary fixture, on a saturation fixture where
   every case of the combine fires (the counts are printed) and on a seeded
   random scene at tile 8, 16 and 32 and chunk 128, 256 and 512; a NaN
   colour, and a forward launch the card refuses; the backward kernels
   (pass 1 = K3: row totals from a handed-over ``boundary_T`` and without
   one; the suffix kernel; pass 2 = K4) against their plain versions on the
   same streams (tolerances: colour 1e-4, depth 1e-3, final T, boundary T
   and the row kernel's prefixes 2e-4; totals, suffix and per-pair
   gradients 2e-3·max + 1e-7: the pixel sums run in another order); two
   launches of every row and combine kernel and of pass 2 give
   bit-identical results; a pair with a NaN colour gives NaN where the
   plain versions give NaN; a launch the card refuses raises;
   the whole ``stream_composite`` backward against autograd through the
   plain forward (per-Gaussian gradients within 2e-3·max|g| + 1e-7 per
   field) at the same tiles and chunks;
   the per-tile-list kernel (K2: its lists as a chunk-aligned stream
   through K1's row and combine kernels) on the list form of the fixture
   and on the random scene's lists at tile 32, 16 and 8 and chunk 128, 256
   and 512, with and without ``order`` (colour 1e-5, depth 2e-5, final T
   5e-6; its counter and K1's two advance by one a call; a repeat gives
   the same bits), a NaN colour and a launch the card refuses;
   the later phases hold the kernels against the plain versions on their
   streams too;
2. the render path: ``dge_tpu_torch.launch --render`` of the quality-gate
   scene over the committed 16-view capture at 256^2, in-process, with the
   launch counters set to 0 just before and read just after; spill must be
   0 after the cap ladder and the mean PSNR of the float renders against
   the capture at least 41.5 dB;
3. full width, forward: the trained bench scene spill-free at 512^2 and at
   1920x1080, timed with CUDA events (whole render, its stages, K1, each
   of its two kernels alone, plain versions) and a profiler trace (the
   kernels' device times);
4. the training path: ``dge_tpu_torch.launch --fit`` on the same capture at
   256^2 (SH degree 3, 1,200 steps, seed 0), counters set to 0 just before
   and read just after, then the saved PLY rendered spill-free over the 16
   views; every loss finite, at least one launch per step of each of K1's
   two kernels and of K3, suffix, K4 and the ordered fold, more than 8,000
   Gaussians alive, train PSNR (last 100 steps) and evaluation PSNR at
   least 30 dB; the fold at the fit's view 0 (its layout and fold
   kernels and no sort; bit-identical repeats, plain version and
   ``index_add_`` on a CPU copy; ``index_add_`` on the card within
   1e-5·max|g|; times); then two
   700-step fits with seed 0, which must log the same losses and alive
   counts and save the same PLY;
5. full width, training: on the bench scene at 512^2 with a seeded random
   target and ``lambda_dssim=0``: K3 and K4 against their plain versions,
   CUDA-event times of K1 (with and without the ``boundary_T`` store), K3
   (both routes), the suffix kernel and K4 alone, of the stages of a train
   step, of forward + backward of ``render`` and of a whole train step; the
   fold as in phase 4; two forward + backward passes of one step give
   bit-identical gradients in every parameter group;
6. the evaluation path: ``dge_tpu_torch.launch --validate`` of the
   quality-gate scene over the capture at 256^2, in-process, twice: on the
   default backend (K1) and with ``--backend cuda_tiles`` (per-tile lists,
   K2), counters set to 0 before each; spill 0 and mean PSNR at least 41.5
   dB in both, the two within 0.02 dB, SSIM and LPIPS finite, K2 launched
   at least once per view and K1's two kernels exactly as often as K2 in
   the second run; ``--export`` with an 8-frame orbit; the mask lift
   (``render_weights``) over the 16 views; K2 at the path's shapes, then
   LPIPS at 256^2 (ms a view, card against CPU within 1e-4 relative), and
   K2 on the bench scene at 512^2 and 1920x1080 (whole ``cuda_tiles``
   render, list binning, the wrapper's event time and the device time of
   its kernels, its layout's row-count read and gather apart, plain
   version, bound, image against ``cuda_stream``); and the K1-vs-K5 tool
   (``dge_tpu_torch.tools.proto_logdot``) at 512^2, counters set to 0
   before it;
7. the edit path: ``--train --smoke`` at full SD-1.5 width on random
   weights over 10 views of the capture (camera batches of 5, 20 DDIM
   steps, a 150-step refit), counters set to 0 before it; its checks, the
   kernels at the refit's shapes, SDPA against the chunked attention, the
   blockwise argmax against the dense one, UNet / VAE / DDIM-step times;
8. the rest of the edit system, counters set to 0 before each run: (a)
   the repo's recipe ``--train --config configs/dge.yaml`` (batched reuse)
   as a local edit (precomputed masks, a 50-step refit, CLIP metrics from a
   random full-width CLIP directory): the reuse mode, a spill-free mask
   lift, a grad mask neither empty nor everything, the masked fields (all
   but rotation, as in the reference) of every Gaussian outside it
   bit-identical after the refit, the edited frames, spill 0, the kernels'
   launches; one DDIM step of the 10 views in ``"loop"`` and in ``"vmap"``
   mode: the vmap pass's gather indices equal to the loop's except at ties
   within 1e-5, the two steps within 2e-4 with the loop's indices handed
   over, the free difference and both times printed; (b) 20
   steps of ``system.edit.use_sds=true`` over batches of 5: finite losses,
   moved parameters, densify statistics, spill 0, at least 2·5 launches a
   step of K1's two kernels and 5 of K3, suffix, K4 and the fold; the
   kernels at the SDS shapes, one SDS step's gradients through the
   kernels against the plain render within 2e-3·max|g|, the SDS step and
   the VAE encoder's forward + backward at 5 x 512^2 timed, peak memory;
   (c) ``ClipSimilarity`` at ViT-L/14 width over the original and edited
   frames: finite, identical images within 1e-5 of 1, ms per image;
9. multi-GPU on the one card (dge_tpu_torch/parallel/): (a) ``python -m
   torch.distributed.run --standalone --nproc_per_node=1 -m
   dge_tpu_torch.launch --train --smoke --distributed`` with
   ``system.guidance.batch_mode=shard`` on phase 7's setup (TF32 off, a
   30-step refit): exit 0, NCCL named in the rank's log, finite losses and
   edit frames, spill 0, the kernels launched every step; then one DDIM
   step of the 10 views in ``"shard"`` mode in a one-rank NCCL group
   equal to the ``"vmap"`` step bit for bit; (b) gloo ranks that share
   cuda:0 (correctness and launches, not scaling): world 2, the
   view-sharded train step over capture views 0 and 8 of the quality-gate
   scene and one shard-mode DDIM step at full SD-1.5 width (each rank's
   gather indices equal to the vmap pass's except at ties within 1e-5, the
   step within 2e-4 of vmap's with that gather handed over); world 4, the
   bench scene at 512^2 in 4 tile bands of 128 rows, gauss x tile 2 x 2
   and 4 depth slabs through the list kernel K2 (colour and alpha within
   5e-3, depth 5e-2 of the whole render, spill 0; each band within colour
   1e-4 / depth 1e-3 / T 2e-4 of the port's own render of that band
   viewport), the depth-slab train step and the view x tile step 2 x 2
   with SSIM. The view-sharded step against the single-rank step over the
   same views (``dryrun.reference_step``), the view x tile step against
   the view-sharded step (the same ``denom``), the depth-slab step against
   the same four slabs merged in one process (``slab_step_one_rank``):
   loss within 1e-5, each field's gradient within 2e-3·max|g| + 1e-7, no
   gradient of another sign (zero against non-zero counts), parameters
   within 1e-4 where both gradients are at least 1e-12 (1e3 x Adam's eps;
   the largest difference over all entries reported), the view step's two
   replicas equal; the depth-slab step's loss within 1e-5 of the unsharded
   step (each slab starts at T = 1, so its gradients part past the early
   stop, as JAX's do, ROADMAP.md §3: reported); every rank's counters of
   K1, K3, suffix, K4 and the fold
   (steps) and of K2 and its layout kernel (renders) advanced; per rank
   and scenario the CUDA-event ms, the collectives' host ms and peak
   memory;
10. the capture and checkpoint paths, counters set to 0 before each run:
   (a) the committed capture written as a Blender capture
   (``transforms_train.json``) and ``launch --render`` of the quality-gate
   scene over it: mean PSNR within 1e-3 dB of phase 2's (41.8454 dB when
   phase 2 is not in the run), spill 0, K1's two kernels launched at least
   once a view; (b) ``dge_tpu_torch.tools.make_bench_capture --style
   aniso`` at 512^2 with 24 views (spill 0 on every view, K1 launched on
   every view), then ``launch --fit`` of that capture with its
   ``cfg.yaml`` (SH degree 0) for 1,000 steps: every loss finite, K1's two
   kernels, K3, suffix, K4 and the fold launched at least once a step, the
   points read by the native parser; steps/s, peak memory, the alive count
   and the train PSNR of the last 100 steps printed; (c) full-width SD-1.5
   networks with random weights written as a diffusers directory of
   ``.bin`` files, ingested (``tools/ingest_checkpoint``), and one DDIM
   step of 5 views from the raw and from the ingested directory: equal bit
   for bit; write, ingest and load seconds printed; (d) the native
   ``points3D.bin`` parser used on the committed capture and equal to the
   Python loop; the kernels against their plain versions at the bench
   capture's view 0.

``--phases`` runs a subset (for a quick check of a new kernel) and
``--fit-steps`` changes the length of phase 4's fit (6000 is the quality
gate's own recipe); the result lines are printed only when all ten ran.
It prints one JSON line with every kernel, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Any failure raises: the
exit code is then not 0 and no result line is printed. Without a CUDA
device, or outside the repository, it fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
# the backward kernels (csrc/pairs_backward.cu, source note): pass 1 is the
# forward's walk plus g and the block sum; pass 2 adds dalpha and the chain
FLOPS_PASS1 = 35
FLOPS_PASS2 = 70
GRAD_TOL = 2e-3  # x max|reference| + 1e-7, per field
FLOPS_LOGDOT = 27  # K1's count plus one log and one exp per (pair, pixel)
FIT_STEPS = 1200
# two same-seed fits of this length pass the densify steps 500 and 600 (the
# final step densifies nothing)
REPRO_STEPS = 700
FIT_PSNR_MIN = 30.0
BACKENDS_PSNR_TOL = 0.02  # dB between the stream and the list validate run
# list image against stream image, both spill-free. The two binnings keep
# the same pairs in every tile, but order ties in quantised depth by
# submission, which differs (the stream's two-tier emission submits small
# Gaussians first), so some tiles' lists are permuted among equal depths. In
# the tiles whose order is the same, the two families part only at a pixel
# where a pair was refused (T·cp < 1e-4, chunks cut at other places): before
# that pair T was below 1e-4 / (1 - 0.99), and all that later chunks can
# still add is bounded by that residual, so there the images differ by less
# than 1e-2, and only where the final T is below 1e-2
LIST_VS_STREAM_TOL = 1e-2
# K5 against K1: how far (relative) the 1e-4 stop is moved to find the
# pixels where the two forms' prefixes, which part by a few 1e-5 relative
# over a block, decide a refusal differently
STOP_NUDGE = 1e-3
# where the pair-stream ladder starts on the bench scene at 1920x1080
STREAM_START_1080P = dict(tight_cull=True, max_per_tile=2048,
                          max_tiles_per_gaussian=64, small_slots=16,
                          max_pairs=3 << 18, big_capacity=16384)
ALL_PHASES = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10}
# phase 7, the edit path: 10 views in camera batches of 5, one edit round,
# a refit that passes one densify (step 100)
EDIT_VIEWS = 10
EDIT_BATCH = 5
EDIT_STEPS = 150
SDPA_TOL = 1e-4  # x max|chunked plain attention|
# phase 8, the rest of the edit system: the repo's recipe (configs/dge.yaml,
# batched reuse) as a local edit with a short refit, then the SDS mode
LOCAL_STEPS = 50
SDS_STEPS = 20
MASK_DIR = os.path.join(ROOT, "outputs", "quality_gate", "20260821-064841",
                        "masks")
# one DDIM step, "vmap" against "loop" with the same gather indices
# (tests/test_guidance.py's tolerance between JAX's two modes)
VMAP_TOL = 2e-4
CLIP_TOL = 1e-5  # sim_image of identical images against 1
ARGMAX_GAP = 1e-5  # dense top-2 gap above which the argmax indices must agree
# phase 9, multi-GPU on the one card: the capture views of the view-sharded
# and view x tile steps (one a rank / band row), the refit of the NCCL run
MULTI_VIEWS = (0, 8)
NCCL_REFIT_STEPS = 30
# a sharded render against the whole image (tests/test_parallel.py's
# tolerances: depth-quantisation ties order differently in a band or slab)
BAND_TOL = {"color": 5e-3, "alpha": 5e-3, "depth": 5e-2}
STEP_PARAM_TOL = 1e-4
# 1e3 x Adam's eps (1e-15): where both gradients are at least this, Adam's
# first step lr·g/(|g| + eps) changes by less than lr·1e-3 <= 5e-5 over any
# change of the gradient that keeps its sign; below it the step turns the
# rounding of a gradient of ~eps into a move of up to ~lr
ADAM_FLOOR = 1e-12
STEP_LOSS_TOL = 1e-5
# phase 10, the capture and checkpoint paths: phase 2's render PSNR (chip
# runs of PRs 1-9), held when phase 2 is not in the run; the bench capture's
# fit; the views of one DDIM step from the ingested checkpoint
RENDER_PSNR_DB = 41.8454
BLENDER_PSNR_TOL = 1e-3
BENCH_VIEWS = 24
BENCH_SIZE = 512
BENCH_FIT_STEPS = 1000
INGEST_VIEWS = 5
KERNEL_NAMES = ("pairs_composite", "pairs_composite_combine", "pairs_pass1",
                "pairs_suffix", "pairs_pass2", "pairs_fold", "list_stream",
                "tiles_composite", "pairs_logdot", "pairs_logdot_combine")
# the forward's two kernels per form (csrc/pair_rows_forward.cuh): counter
# keys and the profiler's kernel names
FORWARD_FORMS = {False: ("pairs_composite", "pairs_composite_combine",
                         "rows_forward_kernel<false>",
                         "rows_combine_kernel<false>"),
                 True: ("pairs_logdot", "pairs_logdot_combine",
                        "rows_forward_kernel<true>",
                        "rows_combine_kernel<true>")}
BACKWARD_KERNELS = ("pairs_pass1", "pairs_suffix", "pairs_pass2",
                    "pairs_fold")
# K2 runs its layout kernel, then K1's row and combine kernels over its
# aligned list stream: a call advances these four counters by one each
K2_COUNTERS = ("list_stream", "tiles_composite") + FORWARD_FORMS[False][:2]
# K2 against its plain version (composite_lists): the two differ only in
# where T is multiplied in, f32 rounding
K2_TOL = {"color": 1e-5, "depth": 2e-5, "trans": 5e-6}


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


def bound_ms(pairs: int, num_tiles: int, tile_px: int,
             flops: int = FLOPS_PER_PAIR_PIXEL, bytes_per_pair: int = 40):
    """Least time of a forward compositing on this card: bytes (each pair's
    features read once, 40 bytes, plus 4 for its list entry on the list
    path; [T, 5, P] written once) over HBM rate vs operations over f32
    rate."""
    p = tile_px * tile_px
    t_bytes = (pairs * bytes_per_pair + num_tiles * p * 5 * 4) / HBM_BYTES_PER_S
    t_ops = pairs * p * flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def forward_bounds(pairs: int, num_tiles: int, rows: int, tile_px: int,
                   chunk: int, log_space: bool = False,
                   boundary: bool = False):
    """Least times of the forward's row kernel and combine kernel on this
    card, as ``bound_ms``, each with its terms written out: the row kernel
    reads each pair's 40 bytes and writes the scratch R·P·28 (32 in log
    space) and the keep mask R·G·W·4, against 25 (27) operations per (pair,
    pixel); the combine reads the scratch and writes [T, 5, P] (T·P·20) and,
    with ``boundary``, boundary_T (R·P·4), against one multiply-add per
    field, row and pixel (its walks depend on the data and are not
    counted)."""
    p = tile_px * tile_px
    fields = 8 if log_space else 7
    flops = FLOPS_LOGDOT if log_space else FLOPS_PER_PAIR_PIXEL
    mask_bytes = rows * 4 * -(-p // 128) * -(-chunk // 32) * 4
    out = []
    for ops, nbytes, terms in (
            (pairs * p * flops, pairs * 40 + rows * p * fields * 4
             + mask_bytes,
             f"max(({pairs}*40 + {rows}*{p}*{fields * 4} + {mask_bytes}) B "
             f"/ 3.35 TB/s, {pairs}*{p}*{flops} op / 67 TFLOP/s)"),
            (rows * p * 8, rows * p * fields * 4 + num_tiles * p * 20
             + boundary * rows * p * 4,
             f"max(({rows}*{p}*{fields * 4} + {num_tiles}*{p}*20"
             + (f" + {rows}*{p}*4" if boundary else "") + ") B / 3.35 TB/s, "
             f"{rows}*{p}*8 op / 67 TFLOP/s)")):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / F32_FLOPS
        out.append((max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations", terms))
    return out


def forward_vs_plain(inp, what: str, log_space: bool = False) -> dict:
    """The forward's row kernel and combine kernel (K1's, or K5's with
    ``log_space``) each against its plain version on one stream: the
    scratch field by field (the prefixes and T within 2e-4, the first kept
    pair and the keep mask's words equal in all but one in a thousand, L
    within the colour and depth tolerances where the combine reads it: a
    prefix of at least 1e-4 in both), the combine on the kernel's scratch and its boundary T; two
    launches of each bit-identical. Returns per kernel its max abs error and
    how often each combine case fired."""
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC

    row_key, comb_key = FORWARD_FORMS[log_space][:2]
    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"],
              chunk=inp["chunk"], log_space=log_space)
    args = (inp["data"], inp["starts"], inp["counts"])
    blk_off, row_tile, _ = PC.block_rows(inp["starts"], inp["counts"],
                                         inp["chunk"], inp["data"].shape[1])
    used = row_tile < inp["starts"].shape[0]
    before = dict(PC.launch_counts)
    scratch, mask = PC.rows_forward(*args, blk_off, row_tile, **kw)
    out, bt = PC.rows_combine(scratch, mask, *args, blk_off, boundary=True,
                              **kw)
    torch.cuda.synchronize()
    for k in PC.launch_counts:
        want = before[k] + (k in (row_key, comb_key))
        if PC.launch_counts[k] != want:
            raise AssertionError(f"{what}: launch counter {k} advanced by "
                                 f"{PC.launch_counts[k] - before[k]}")
    scratch2, mask2 = PC.rows_forward(*args, blk_off, row_tile, **kw)
    same = {
        "row kernel again": torch.equal(scratch2[used], scratch[used])
        and torch.equal(mask2[used], mask[used]),
        "combine again": all(torch.equal(x[sel], y[sel]) for x, y, sel in zip(
            PC.rows_combine(scratch, mask, *args, blk_off, boundary=True,
                            **kw), (out, bt), (slice(None), used)))}
    if not all(same.values()):
        raise AssertionError(f"{what}: not bit-identical: {same}")
    want_s, want_m = PC.rows_forward_reference(*args, blk_off, row_tile, **kw)
    want_s, got_s = want_s[used], scratch[used]
    mask_off = float((mask[used] != want_m[used]).float().mean()) \
        if got_s.numel() else 0.0
    read = (got_s[:, 0] >= 1e-4) & (want_s[:, 0] >= 1e-4)
    e_cp = float((got_s[:, 0:2] - want_s[:, 0:2]).abs().max()) \
        if got_s.numel() else 0.0
    if log_space and got_s.numel():
        e_cp = max(e_cp, float((got_s[:, 7] - want_s[:, 7]).abs().max()))
    j0_off = float((got_s[:, 2] != want_s[:, 2]).float().mean()) \
        if got_s.numel() else 0.0
    e_l = [float((got_s[:, f] - want_s[:, f])[read].abs().max())
           if bool(read.any()) else 0.0 for f in range(3, 7)]
    if not (e_cp <= TOL["trans"] and j0_off <= 1e-3 and mask_off <= 1e-3
            and max(e_l[:3]) <= TOL["color"] and e_l[3] <= TOL["depth"]):
        raise AssertionError(f"{what}: row kernel disagrees with its plain "
                             f"version: prefixes {e_cp}, j0 {j0_off}, mask "
                             f"{mask_off}, L {e_l}")
    out_p, bt_p = PC.rows_combine_reference(scratch, mask, *args, blk_off,
                                            boundary=True, **kw)
    e_out = compare(out, out_p, f"{what} {comb_key} vs plain")
    e_bt = float((bt[used] - bt_p[used]).abs().max()) if bool(used.any()) \
        else 0.0
    if e_bt > TOL["trans"]:
        raise AssertionError(f"{what}: combine boundary T {e_bt}")
    cases = PC.combine_cases(scratch, bt, row_tile, inp["starts"].shape[0],
                             log_space=log_space)
    log(f"  {what} {row_key}: prefixes max|err| {e_cp:.3e}, j0 differs in "
        f"{j0_off:.2e} of visits, mask in {mask_off:.2e} of words, L "
        f"max|err| {max(e_l):.3e}; combine cases "
        f"{cases}; bit-identical {sorted(same)}")
    return {row_key: max([e_cp] + e_l), comb_key: max(e_out, e_bt),
            "cases": cases}


def forward_times(inp, log_space: bool = False, plain_reps: int = 3,
                  boundary: bool = False) -> dict:
    """At one stream's shapes: CUDA-event times of the forward's row kernel
    and combine kernel alone and of the whole wrapper (with the boundary_T
    store where ``boundary``, as the fit path calls it), their device times
    from a profiler trace, their plain versions' times, their bounds and
    how often each combine case fired."""
    from dge_tpu_torch.ops import pairs_composite as PC

    row_key, comb_key, row_name, comb_name = FORWARD_FORMS[log_space]
    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"],
              chunk=inp["chunk"], log_space=log_space)
    args = (inp["data"], inp["starts"], inp["counts"])
    num_tiles = inp["starts"].shape[0]
    blk_off, row_tile, n_rows = PC.block_rows(
        inp["starts"], inp["counts"], inp["chunk"], inp["data"].shape[1])
    scratch, mask = PC.rows_forward(*args, blk_off, row_tile, **kw)
    _, bt = PC.rows_combine(scratch, mask, *args, blk_off, boundary=True,
                            **kw)
    cases = PC.combine_cases(scratch, bt, row_tile, num_tiles,
                             log_space=log_space)
    rows = int((row_tile < num_tiles).sum())
    bounds = forward_bounds(inp["pairs"], num_tiles, rows, inp["tile_px"],
                            inp["chunk"], log_space, boundary)

    def whole():
        return PC.composite_rows(
            *args, boundary_rows=(blk_off, n_rows) if boundary else None,
            row_tile=row_tile, **kw)

    dev = kernel_device_ms(whole, {row_key: row_name, comb_key: comb_name})
    res = {}
    for key, fn, plain, (b_ms, b_by, terms) in (
            (row_key, lambda: PC.rows_forward(*args, blk_off, row_tile, **kw),
             lambda: PC.rows_forward_reference(*args, blk_off, row_tile,
                                               **kw), bounds[0]),
            (comb_key, lambda: PC.rows_combine(scratch, mask, *args, blk_off,
                                               boundary=boundary, **kw),
             lambda: PC.rows_combine_reference(scratch, mask, *args, blk_off,
                                               boundary=boundary, **kw),
             bounds[1])):
        res[key] = dict(ms=cuda_ms(fn, reps=20), device_ms=dev[key],
                        plain_ms=cuda_ms(plain, reps=plain_reps, warmup=1),
                        bound_ms=b_ms, bound_by=b_by, bound_terms=terms)
    res["whole_ms"] = cuda_ms(whole, reps=20)
    res["rows"] = rows
    res["cases"] = cases
    return res


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
    return dict(data=assembly(prep, pb), pair_ids=pb.pair_ids,
                layout=pb.fold_layout(), starts=pb.starts.contiguous(),
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


def backward_bounds(pairs: int, num_tiles: int, rows: int, tile_px: int):
    """Least times of pass 1, pass 2 and the suffix kernel on this card, as
    ``bound_ms``: every input read once, every output written once, against
    the operations (one add per row and pixel for the suffix)."""
    p = tile_px * tile_px
    out = []
    for ops, nbytes in (
            (pairs * p * FLOPS_PASS1,
             pairs * 40 + num_tiles * p * 20 + rows * p * 8),
            (pairs * p * FLOPS_PASS2,
             pairs * 40 + num_tiles * p * 24 + rows * p * 8 + pairs * 40),
            (rows * p, rows * p * 8)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / F32_FLOPS
        out.append((max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations"))
    return out


def rel_err(got, want, what: str) -> float:
    """max|got - want| / max|want|; raises beyond GRAD_TOL·max + 1e-7."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if not err <= GRAD_TOL * scale + 1e-7:
        raise AssertionError(f"{what}: |err| {err} > {GRAD_TOL}*{scale}+1e-7")
    return err / max(scale, 1e-30)


@contextlib.contextmanager
def backward_option(**options):
    """Run the backward kernels with module constants of ops/pairs_backward
    (MAX_CHUNK) set for the block's duration."""
    from dge_tpu_torch.ops import pairs_backward as PB

    old = {k: getattr(PB, k) for k in options}
    for k, v in options.items():
        setattr(PB, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(PB, k, v)


def backward_args(inp, seed: int = 0):
    """The backward kernels' inputs on one stream: a seeded random cotangent
    [T, 5, P], the compact row layout, and the forward kernel's output with
    the boundary T it stores for the backward."""
    import torch

    from dge_tpu_torch.ops import pairs_backward as PB
    from dge_tpu_torch.ops import pairs_composite as PC

    dev = inp["data"].device
    num_tiles = inp["starts"].shape[0]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cot = torch.randn(num_tiles, 5, inp["tile_px"] ** 2, generator=gen).to(dev)
    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"],
              chunk=inp["chunk"])
    blk_off, row_tile, n_rows = PB.block_rows(
        inp["starts"], inp["counts"], inp["chunk"], inp["data"].shape[1])
    fwd, boundary_t = PC.composite_pairs_stream(
        inp["data"], inp["starts"], inp["counts"],
        boundary_rows=(blk_off, n_rows), **kw)
    used = row_tile < num_tiles
    return dict(inp, cot=cot, fwd=fwd, boundary_t=boundary_t, blk_off=blk_off,
                row_tile=row_tile, n_rows=n_rows, used=used,
                rows=int(used.sum()), kw=kw)


def backward_vs_plain(inp, what: str, seed: int = 0):
    """The backward kernels against their plain versions on one stream: the
    boundary T that K1 stores, the pass-1 row totals from it, the suffix
    kernel, pass 1 as a whole on both routes (boundary T handed over, and
    from K1's walk), and pass 2 (both kinds fed the kernels' pass-1 output).
    Pass 2 twice must give the same bits. Returns the args and, per backward
    kernel, (max abs err, the same relative to the field's largest reference
    value)."""
    import torch

    from dge_tpu_torch.ops import pairs_backward as PB
    from dge_tpu_torch.ops import pairs_composite as PC

    a = backward_args(inp, seed)
    used, kw = a["used"], a["kw"]
    base = (a["data"], a["starts"], a["counts"], a["blk_off"])

    def max_abs(x, y):
        return float((x - y).abs().max()) if x.numel() else 0.0

    def counted(fn, **advance):
        before = dict(PC.launch_counts)
        out = fn()
        torch.cuda.synchronize()
        for k in PC.launch_counts:
            if PC.launch_counts[k] != before[k] + advance.get(k, 0):
                raise AssertionError(f"{what}: launch counter {k} advanced by "
                                     f"{PC.launch_counts[k] - before[k]}")
        return out

    def pass1(**extra):
        return PB.pairs_pass1(*base, a["n_rows"], a["cot"], **extra, **kw)

    def pass2(bt, suf):
        return PB.pairs_pass2(*base, a["row_tile"], a["cot"], a["fwd"], bt,
                              suf, **kw)

    handed = dict(boundary_t=a["boundary_t"], row_tile=a["row_tile"])
    totals = counted(lambda: PB.pairs_row_totals(
        *base, a["row_tile"], a["cot"], a["boundary_t"], **kw), pairs_pass1=1)
    suf_alone = counted(lambda: PB.pairs_suffix(
        totals, a["starts"], a["counts"], a["blk_off"],
        tile_px=inp["tile_px"], chunk=inp["chunk"]), pairs_suffix=1)
    bt, suf = counted(lambda: pass1(**handed), pairs_pass1=1, pairs_suffix=1)
    bt_w, suf_w = counted(pass1, pairs_composite=1,
                          pairs_composite_combine=1, pairs_pass1=1,
                          pairs_suffix=1)
    grads = counted(lambda: pass2(bt, suf), pairs_pass2=1)
    same = {"suffix alone": torch.equal(suf_alone[used], suf[used]),
            "walk route boundary T": torch.equal(bt_w[used], bt[used]),
            "walk route suffix": torch.equal(suf_w[used], suf[used]),
            "pass 2 again": torch.equal(pass2(bt, suf), grads)}
    torch.cuda.synchronize()
    if not all(same.values()):
        raise AssertionError(f"{what}: not bit-identical: {same}")

    bt_p, suf_p = PB.pass1_reference(*base, a["n_rows"], a["cot"], **kw)
    totals_p = PB.row_totals_reference(*base, a["row_tile"], a["cot"], bt,
                                       **kw)
    suf_from_totals = PB.suffix_reference(totals, a["starts"], a["counts"],
                                          a["blk_off"], chunk=inp["chunk"])
    grads_p = PB.pass2_reference(*base, a["row_tile"], a["cot"], a["fwd"], bt,
                                 suf, **kw)
    e_bt = max_abs(bt[used], bt_p[used])
    if e_bt > TOL["trans"]:
        raise AssertionError(f"{what}: boundary T {e_bt} > {TOL['trans']}")
    r_tot = rel_err(totals[used], totals_p[used], f"{what} row totals")
    r_suf = rel_err(suf[used], suf_from_totals[used], f"{what} suffix kernel")
    r_p1 = rel_err(suf[used], suf_p[used], f"{what} pass 1 suffix")
    r_g = [rel_err(grads[f], grads_p[f], f"{what} pass 2 row {f}")
           for f in range(10)]
    log(f"  {what}: K1's boundary T max|err| {e_bt:.3e}; pass 1 row totals "
        f"rel {r_tot:.3e}, suffix kernel rel {r_suf:.3e}, whole pass 1 rel "
        f"{r_p1:.3e}; pass 2 per-pair grads rel {max(r_g):.3e}; bit-identical "
        f"{sorted(same)} (rows {a['rows']}, pairs {inp['pairs']})")
    a.update(suffix=suf, totals=totals)
    return a, {
        "pairs_pass1": (max(e_bt, max_abs(totals[used], totals_p[used]),
                            max_abs(suf[used], suf_p[used])),
                        max(r_tot, r_p1, e_bt)),
        "pairs_suffix": (max_abs(suf[used], suf_from_totals[used]), r_suf),
        "pairs_pass2": (max_abs(grads, grads_p), max(r_g))}


def nan_colour_vs_plain(dev):
    """A pair with a NaN colour in a 16x16 tile that five wide pairs cover:
    the row kernels must turn it into NaN exactly where the plain versions
    do (the row's totals and suffix at every pixel; mean, conic and opacity
    gradients of every pair of the row) and agree on the rest (the colour
    and depth gradients, which no NaN reaches)."""
    import torch

    from dge_tpu_torch.ops import pairs_backward as PB

    feat = torch.zeros(10, 8)
    feat[0:2] = 8.0
    feat[2] = feat[4] = 1e-3  # alpha 0.28-0.3 at every pixel of the tile
    feat[5] = 0.3
    feat[6:9] = 0.5
    feat[9] = 1.0
    feat[6, 2] = float("nan")
    inp = dict(data=feat.to(dev).contiguous(),
               starts=torch.zeros(1, dtype=torch.int32, device=dev),
               counts=torch.full((1,), 5, dtype=torch.int32, device=dev),
               tiles_x=1, tiles_y=1, pairs=5, chunk=128, tile_px=16)
    a = backward_args(inp, seed=7)
    base = (a["data"], a["starts"], a["counts"], a["blk_off"])
    rows = (a["row_tile"], a["cot"])
    bt, suf = PB.pairs_pass1(*base, a["n_rows"], a["cot"],
                             boundary_t=a["boundary_t"],
                             row_tile=a["row_tile"], **a["kw"])
    totals = PB.pairs_row_totals(*base, *rows, bt, **a["kw"])
    grads = PB.pairs_pass2(*base, *rows, a["fwd"], bt, suf, **a["kw"])
    totals_p = PB.row_totals_reference(*base, *rows, bt, **a["kw"])
    grads_p = PB.pass2_reference(*base, *rows, a["fwd"], bt, suf, **a["kw"])
    used = a["used"]
    for what, got, want in (("row totals", totals[used], totals_p[used]),
                            ("suffix", suf[used], totals_p[used]),
                            ("pass 2", grads[:, :5], grads_p[:, :5])):
        if not torch.equal(got.isnan(), want.isnan()):
            raise AssertionError(f"NaN colour, {what}: the kernel's NaNs are "
                                 "not the plain version's")
        rel_err(got.nan_to_num(), want.nan_to_num(), f"NaN colour {what}")
    if not (bool(totals[used].isnan().all())
            and bool(grads[:6, :5].isnan().all())
            and bool(grads[6:].isfinite().all())
            and float(grads[6:].abs().max()) > 0):
        raise AssertionError("NaN colour: not where it is expected")
    log("  NaN colour: row totals, suffix and the mean / conic / opacity "
        "gradients of the row are NaN in the kernels as in the plain "
        "versions; colour and depth gradients finite and equal")


def backward_times(a, plain_reps: int = 2):
    """CUDA-event times of K1 (row + combine kernel) with and without the
    boundary-T store, of the pass-1 row kernel, the suffix kernel, pass 1 as
    a whole on both routes and pass 2; of the plain versions; and, from a profiler trace, the
    device time of each hand-written kernel of a training step."""
    from dge_tpu_torch.ops import pairs_backward as PB
    from dge_tpu_torch.ops import pairs_composite as PC

    kw = a["kw"]
    stream = (a["data"], a["starts"], a["counts"])
    base = stream + (a["blk_off"],)

    def k1():
        return PC.composite_pairs_stream(*stream, **kw)

    def k1_store():
        return PC.composite_pairs_stream(
            *stream, boundary_rows=(a["blk_off"], a["n_rows"]), **kw)

    def row_totals():
        return PB.pairs_row_totals(*base, a["row_tile"], a["cot"],
                                   a["boundary_t"], **kw)

    def suffix():
        return PB.pairs_suffix(a["totals"], a["starts"], a["counts"],
                               a["blk_off"], tile_px=kw["tile_px"],
                               chunk=kw["chunk"])

    def pass1(**extra):
        return PB.pairs_pass1(*base, a["n_rows"], a["cot"], **extra, **kw)

    def pass1_handed():
        return pass1(boundary_t=a["boundary_t"], row_tile=a["row_tile"])

    def pass2():
        return PB.pairs_pass2(*base, a["row_tile"], a["cot"], a["fwd"],
                              a["boundary_t"], a["suffix"], **kw)

    # the two K1 forms in turns: plain, store, store, plain
    k1_ms = [cuda_ms(f, reps=20) for f in (k1, k1_store, k1_store, k1)]
    out = dict(
        k1_ms=min(k1_ms[0], k1_ms[3]), k1_store_ms=min(k1_ms[1], k1_ms[2]),
        pass1_ms=cuda_ms(row_totals, reps=20),
        pass2_ms=cuda_ms(pass2, reps=20), suffix_ms=cuda_ms(suffix, reps=20),
        pass1_whole_ms=cuda_ms(pass1_handed, reps=20),
        pass1_walk_route_ms=cuda_ms(pass1, reps=20))

    def step():
        k1_store()
        pass1_handed()
        pass2()

    out.update(kernel_device_ms(step, dict(
        k1_row_device_ms=FORWARD_FORMS[False][2],
        k1_combine_device_ms=FORWARD_FORMS[False][3],
        pass1_device_ms="pairs_rows_kernel<false>",
        suffix_device_ms="rows_suffix_kernel",
        pass2_device_ms="pairs_rows_kernel<true>")))
    out.update(
        pass1_plain_ms=cuda_ms(lambda: PB.pass1_reference(
            *base, a["n_rows"], a["cot"], **kw), reps=plain_reps, warmup=1),
        suffix_plain_ms=cuda_ms(lambda: PB.suffix_reference(
            a["totals"], a["starts"], a["counts"], a["blk_off"],
            chunk=kw["chunk"]), reps=plain_reps, warmup=1),
        pass2_plain_ms=cuda_ms(lambda: PB.pass2_reference(
            *base, a["row_tile"], a["cot"], a["fwd"], a["boundary_t"],
            a["suffix"], **kw), reps=plain_reps, warmup=1))
    return out


def fold_cell(a, num_gaussians: int, what: str) -> dict:
    """The ordered fold on one stream's pass-2 gradients, through the
    binning's layout: one call advances only the fold's counter and
    launches its two kernels (layout, fold) and no sort (a profiler listing
    of ten calls); two calls bit-identical; equal bit for bit to its plain
    version (the same adds in the same order) and to ``index_add_`` on a
    CPU copy (serial, in stream order); within 1e-5·max|g| of
    ``index_add_`` on the card (whose atomics add in another order);
    CUDA-event and device times of the fold, of each of its kernels, of its
    plain version and of ``index_add_``, the library call that computes the
    same function; the function's bound (bytes: the used positions'
    gradients and ids read, [10, N] written) and the layout kernel's own
    (E·12 bytes)."""
    import torch

    from dge_tpu_torch.ops import pairs_backward as PB
    from dge_tpu_torch.ops import pairs_composite as PC

    pair_ids, layout = a["pair_ids"], a["layout"]
    pair_grads = PB.pairs_pass2(
        a["data"], a["starts"], a["counts"], a["blk_off"], a["row_tile"],
        a["cot"], a["fwd"], a["boundary_t"], a["suffix"], **a["kw"])
    # as stream_backward calls it: the stream's tail past the last range out
    used = (a["starts"] + a["counts"]).max()

    def fold():
        return PB.fold_to_gaussians(pair_grads, pair_ids, num_gaussians, used,
                                    layout=layout)

    before = dict(PC.launch_counts)
    got = fold()
    torch.cuda.synchronize()
    for k in PC.launch_counts:
        if PC.launch_counts[k] != before[k] + (k == "pairs_fold"):
            raise AssertionError(f"{what} fold: launch counter {k} advanced")
    # the trace of 10 calls names every kernel they launched; it may drop
    # a few records on this card's profiler, never add one
    calls = 10
    events, _ = profiled_kernels(fold, calls)
    listing = [(e.key[:60], e.count / calls) for e in events]
    names = [name for name, _ in listing]
    if (len(names) != 2 or max(c for _, c in listing) > 1
            or not any("fold_layout_kernel" in k for k in names)
            or not any("fold_kernel" in k for k in names)):
        raise AssertionError(f"{what} fold: one call launched {listing}")
    again = fold()
    plain = PB.fold_reference(pair_grads, layout, used)
    cpu = torch.zeros(got.shape).index_add_(1, pair_ids.cpu().long(),
                                            pair_grads.cpu())

    def index_add():
        return torch.zeros_like(got).index_add_(1, pair_ids.long(),
                                                pair_grads)

    scale = float(pair_grads.abs().max())
    e_lib = float((got - index_add()).abs().max())
    e_plain = float((got - plain).abs().max())
    same = {"repeat": torch.equal(got, again),
            "plain": torch.equal(got, plain),
            "cpu index_add_": torch.equal(got.cpu(), cpu)}
    if not all(same.values()) or not e_lib <= 1e-5 * scale:
        raise AssertionError(f"{what} fold: bit for bit {same}, vs plain "
                             f"{e_plain}, vs index_add_ {e_lib} (max|g| "
                             f"{scale})")
    # the function's bytes: the gradients and ids of the positions before
    # ``used`` read, [10, N] written; the layout kernel reads the E slots'
    # int64 sort indices and writes their int32 positions
    n_used = int(used)
    slots = layout.perm.shape[0]
    t_bytes = (n_used * 44 + num_gaussians * 40) / HBM_BYTES_PER_S
    t_ops = n_used * 10 / F32_FLOPS
    kernel_ms = kernel_device_ms(fold, dict(k="fold_kernel",
                                            layout="fold_layout_kernel"))
    res = dict(
        pairs=pair_ids.numel(), used=n_used, slots=slots,
        emission=list(layout.emission),
        tier2=int((layout.tier2_ids < num_gaussians).sum()),
        gaussians=num_gaussians,
        launches_per_fold=listing, bit_identical=sorted(same),
        ms=cuda_ms(fold, reps=20),
        # per launch, each kernel launched once a call
        device_ms=kernel_ms["k"] + kernel_ms["layout"],
        kernel_device_ms=kernel_ms["k"],
        layout_device_ms=kernel_ms["layout"],
        plain_ms=cuda_ms(lambda: PB.fold_reference(pair_grads, layout, used),
                         reps=3, warmup=1),
        library_ms=cuda_ms(index_add, reps=20),
        library_device_ms=sum_device_ms(index_add),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        layout_bound_ms=slots * 12 / HBM_BYTES_PER_S * 1e3,
        max_abs_err=e_plain, vs_index_add_rel=e_lib / max(scale, 1e-30))
    log(f"  {what} fold: {res}")
    return res


def composite_grads_vs_autograd(scene, cam, what: str, chunk: int = 64,
                                tile_px: int = 32):
    """The whole stream_composite backward (K1 forward, K3 + K4 + fold)
    against autograd through the plain forward: gradients of mean2d, conic,
    opacity, rgb and depth under a seeded random cotangent on colour, depth
    and final T."""
    import torch

    from dge_tpu_torch.ops import binning as B
    from dge_tpu_torch.ops import pairs_backward as PB
    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.ops import projection as P

    prep = P.preprocess(scene.xyz, scene.get_scaling, scene.get_rotation,
                        scene.get_opacity, scene.get_features, scene.alive,
                        cam, scene.active_sh_degree, scene.max_sh_degree)
    pb = B.bin_gaussians_pairs(prep.mean2d, prep.depth, prep.radius,
                               prep.visible, height=cam.height,
                               width=cam.width, tile_px=tile_px,
                               max_per_tile=4096)
    # both sides composite the same stream, spilled or not
    names = ("mean2d", "conic", "rgb", "depth", "opacity")
    gen = torch.Generator(device="cpu").manual_seed(3)
    wts = [torch.randn(cam.height, cam.width, c, generator=gen).to(
        scene.device) for c in (3, 1, 1)]
    geom = dict(height=cam.height, width=cam.width, tiles_x=pb.tiles_x,
                tiles_y=pb.tiles_y, tile_px=tile_px, chunk=max(chunk, 128))
    starts = pb.starts.to(torch.int32).contiguous()
    counts = pb.counts.to(torch.int32).contiguous()
    res = {}
    for kind in ("kernels", "plain"):
        leaves = [getattr(prep, k).detach().clone().requires_grad_(True)
                  for k in names]
        if kind == "kernels":
            color, depth, tfin = PB.stream_composite(
                *leaves, pb.pair_ids, starts, counts,
                layout=pb.fold_layout(), **geom)
        else:
            color, depth, tfin = PC.composite_pairs(
                pb.pair_ids, starts, counts, *leaves,
                bg=torch.zeros(3, device=scene.device), use_kernel=False,
                **geom)
        loss = ((color * wts[0]).sum() + (depth * wts[1][..., 0]).sum()
                + (tfin * wts[2][..., 0]).sum())
        res[kind] = torch.autograd.grad(loss, leaves)
    worst = 0.0
    for k, got, want in zip(names, res["kernels"], res["plain"]):
        r = rel_err(got, want, f"{what} d{k}")
        log(f"  {what}: d{k} max|g| {float(want.abs().max()):.3e} "
            f"rel err {r:.3e}")
        worst = max(worst, r)
    return worst


def same_seed_fits(launch) -> dict:
    """Two ``--fit`` runs with seed 0, past the second densify (steps 500
    and 600 of REPRO_STEPS): their logged losses, PSNRs and alive counts
    (metrics.jsonl, every 10 steps, wall time left out), final alive counts
    and saved PLY files must be identical."""
    import hashlib

    runs = []
    for _ in range(2):
        with tempfile.TemporaryDirectory() as tmp:
            r = launch.main(["--fit", "--source", CAPTURE, "--out", tmp,
                             "--seed", "0", "data.height=256",
                             "data.width=256", "system.sh_degree=3",
                             f"trainer.max_steps={REPRO_STEPS}"])
            with open(os.path.join(r.trial_dir, "metrics.jsonl")) as f:
                logged = [{k: v for k, v in json.loads(line).items()
                           if k != "wall"} for line in f]
            with open(r.ply_path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            runs.append(dict(logged=logged, n_alive=r.n_alive, ply=digest,
                             steps_per_s=r.steps / r.seconds))
    a, b = runs
    parted = next((x["step"] for x, y in zip(a["logged"], b["logged"])
                   if x != y), None)
    log(f"  two {REPRO_STEPS}-step fits, seed 0: alive {a['n_alive']} / "
        f"{b['n_alive']}, first logged step that differs {parted}, PLY "
        f"identical {a['ply'] == b['ply']}, last logged "
        f"{a['logged'][-1]} / {b['logged'][-1]}")
    if (parted is not None or a["logged"] != b["logged"]
            or a["n_alive"] != b["n_alive"] or a["ply"] != b["ply"]):
        raise AssertionError("two fits with the same seed differ")
    return dict(steps=REPRO_STEPS, n_alive=a["n_alive"],
                logged_steps=len(a["logged"]),
                last_loss=a["logged"][-1]["train/loss"],
                steps_per_s=[x["steps_per_s"] for x in runs])


def mean_psnr_against_capture(frames, names):
    import numpy as np
    import torch

    from dge_tpu_torch.ops import losses as L
    from dge_tpu_torch.utils import saving

    psnrs = []
    for img, name in zip(frames, names):
        if img.shape != (256, 256, 3) or not np.isfinite(img).all():
            raise AssertionError(f"render {name}: bad shape or non-finite")
        gt = saving.load_image(os.path.join(CAPTURE, "images", name + ".png"))
        psnrs.append(float(L.psnr(torch.from_numpy(img),
                                  torch.from_numpy(gt))))
    return float(np.mean(psnrs)), psnrs


def train_cell(scene, cam, caps, tight_cull, a, times):
    """Phase 5: the stages of one train step on the bench scene at 512^2
    (seeded random target, lambda_dssim=0), forward + backward of render,
    and whole train steps, with and without the per-step host read of the
    spill."""
    import numpy as np
    import torch

    from dge_tpu_torch.ops import losses as L
    from dge_tpu_torch.ops import pairs_backward as PB
    from dge_tpu_torch.ops import projection as P
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.systems import fit as F
    from dge_tpu_torch.systems import optim as O

    dev = scene.device
    target = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(cam.height, cam.width, 3)).astype(np.float32)).to(dev)
    bg = torch.zeros(3, device=dev)
    kw = dict(tile_px=32, chunk=64, tight_cull=tight_cull, **caps)

    def leaf_scene():
        return scene.with_params({k: v.detach().requires_grad_(True)
                                  for k, v in scene.params().items()})

    def prep_fwd_bwd():
        s = leaf_scene()
        prep = P.preprocess(s.xyz, s.get_scaling, s.get_rotation,
                            s.get_opacity, s.get_features, s.alive, cam,
                            s.active_sh_degree, s.max_sh_degree)
        loss = (prep.mean2d.sum() + prep.conic.sum() + prep.rgb.sum()
                + prep.depth.sum() + prep.opacity.sum())
        return torch.autograd.grad(loss, list(s.params().values()))

    def render_fwd_bwd():
        s = leaf_scene()
        out = R.render(s, cam, bg, backend="cuda_train", **kw)
        return torch.autograd.grad(L.l1_loss(out.color, target),
                                   list(s.params().values()))

    img = R.render(scene, cam, bg, backend="cuda_stream", **kw).color

    def loss_fwd_bwd():
        x = img.detach().requires_grad_(True)
        return torch.autograd.grad(L.l1_loss(x, target), x)

    optimizer = O.make_optimizer(O.OptimConfig.scaled(1500))
    params = {k: v.detach() for k, v in scene.params().items()}
    opt_state = optimizer.init(params)
    grads = {k: torch.randn_like(v) * 1e-3 for k, v in params.items()}
    pair_grads = PB.pairs_pass2(
        a["data"], a["starts"], a["counts"], a["blk_off"], a["row_tile"],
        a["cot"], a["fwd"], a["boundary_t"], a["suffix"], **a["kw"])
    pair_ids = a["pair_ids"]
    used = (a["starts"] + a["counts"]).max()

    # one step's gradients twice: every parameter group bit-identical
    # (the fold adds in stream order; no other op of the step may add in an
    # order of its own)
    first, second = render_fwd_bwd(), render_fwd_bwd()
    differ = [k for k, x, y in zip(scene.params(), first, second)
              if not torch.equal(x, y)]
    if differ:
        raise AssertionError(f"train step: gradients of {differ} differ "
                             "between two runs")
    log("  512x512 train step: render forward + backward twice, the "
        "gradients of every parameter group bit-identical")
    stages = dict(
        preprocess_fwd_bwd_ms=cuda_ms(prep_fwd_bwd),
        fold_ms=cuda_ms(lambda: PB.fold_to_gaussians(
            pair_grads, pair_ids, scene.capacity, used,
            layout=a["layout"])),
        loss_fwd_bwd_ms=cuda_ms(loss_fwd_bwd),
        adam_ms=cuda_ms(lambda: optimizer.update(grads, opt_state, params)),
        render_fwd_bwd_ms=cuda_ms(render_fwd_bwd),
    )

    step = F.make_train_step(optimizer, lambda_dssim=0.0, **kw)
    state = [scene, opt_state, F.FitState.create(scene.capacity, dev)]

    def one_step(sync: bool):
        s, o, f, aux = step(*state, cam, target, bg)
        state[:] = [s, o, f]
        if sync:
            int(aux["spill"])
        return aux

    for _ in range(3):
        one_step(True)
    stages["train_step_ms"] = cuda_ms(lambda: one_step(False), reps=10,
                                      warmup=0)
    for name, sync in (("steps_per_s_sync", True), ("steps_per_s_nosync",
                                                     False)):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(20):
            aux = one_step(sync)
        torch.cuda.synchronize()
        stages[name] = 20 / (time.time() - t0)
    if not bool(torch.isfinite(aux["loss"])):
        raise AssertionError("train step: non-finite loss")
    busy = device_busy(lambda: one_step(True), steps=5)
    if busy["device_busy_share"] is not None:
        # the trace slows the host; the untraced step is the fairer base
        busy["device_share_of_train_step"] = (busy["device_ms_per_step"]
                                              / stages["train_step_ms"])
    stages.update(busy)
    stages.update(times)
    return stages


def dev_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def profiled_kernels(step, steps: int):
    """A torch.profiler trace of ``steps`` calls → (the kernels' events, most
    device time first; wall time in us). Kernels only: a host-side op's
    device time is its kernels' over again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    return events, wall_us


def device_busy(step, steps: int) -> dict:
    """Share of the wall time of ``steps`` calls during which the card ran a
    kernel, and the kernels that took most of it, from a torch.profiler
    trace; ``None`` where the trace shows no device time."""
    events, wall_us = profiled_kernels(step, steps)
    total = sum(dev_us(e) for e in events)
    if total <= 0:
        return dict(device_busy_share=None, device_kernels=None)
    return dict(
        device_busy_share=total / wall_us,
        profiled_step_ms=wall_us / steps / 1e3,
        device_ms_per_step=total / steps / 1e3,
        device_launches_per_step=sum(e.count for e in events) / steps,
        device_kernels=[(e.key[:60], dev_us(e) / steps / 1e3, e.count // steps)
                        for e in events[:8]])


def sum_device_ms(step, steps: int = 10) -> float:
    """Device time of every kernel ``step`` launches, per call, in ms, from
    a torch.profiler trace (no host time): each kernel's time per launch
    times its launches a call, rounded. The card's profiler may drop a few
    records of a trace; the per-launch means stay fair, a plain sum would
    come out low."""
    events, _ = profiled_kernels(step, steps)
    return sum(dev_us(e) / e.count * max(1, round(e.count / steps))
               for e in events if e.count) / 1e3


def kernel_device_ms(step, kernels: dict, steps: int = 10) -> dict:
    """Device time per launch, in ms, of the kernels named in ``kernels``
    ({result key: substring of the kernel's name}) over ``steps`` calls of
    ``step``, from a torch.profiler trace: unlike a CUDA-event pair around
    one call it holds no host time, which matters below ~0.1 ms. ``None``
    where the trace shows no such kernel."""
    events, _ = profiled_kernels(step, steps)
    out = {}
    for key, part in kernels.items():
        found = [e for e in events if part in e.key]
        n = sum(e.count for e in found)
        out[key] = sum(dev_us(e) for e in found) / n / 1e3 if n else None
    return out


def kernel_vs_plain(inp, what: str) -> float:
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC

    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"],
              chunk=inp["chunk"])
    before = dict(PC.launch_counts)
    got = PC.composite_pairs_stream(inp["data"], inp["starts"], inp["counts"],
                                    **kw)
    torch.cuda.synchronize()
    for k in ("pairs_composite", "pairs_composite_combine"):
        if PC.launch_counts[k] != before[k] + 1:
            raise AssertionError(f"launch counter {k} did not advance")
    want = PC.composite_pairs_reference(inp["data"], inp["starts"],
                                        inp["counts"], **kw)
    return compare(got, want, what)


def list_inputs(scene, cam, caps, tight_cull, tile_px, chunk):
    """The list kernel's inputs for one frame, as render(backend=
    "cuda_tiles") forms them."""
    import torch

    from dge_tpu_torch.ops import binning as B
    from dge_tpu_torch.ops import tiles_composite as TT

    preprocess, _, _ = stream_stages(scene, cam, {}, tight_cull, tile_px)
    prep = preprocess()

    def binning():
        return B.bin_gaussians(
            prep.mean2d, prep.depth, prep.radius, prep.visible,
            height=cam.height, width=cam.width, tile_px=tile_px,
            max_per_tile=caps["max_per_tile"],
            max_tiles_per_gaussian=caps["max_tiles_per_gaussian"],
            conic=prep.conic if tight_cull else None,
            opacity=prep.opacity if tight_cull else None)

    bins = binning()
    if int(bins.spill) != 0:
        raise AssertionError(f"list binning spills {int(bins.spill)} at "
                             f"{caps}")
    feats = (prep.mean2d, prep.conic, prep.rgb, prep.depth, prep.opacity)
    return dict(feat=TT.feature_table(*feats), feats=feats,
                lists=bins.lists.contiguous(), counts=bins.counts.contiguous(),
                order=None, tiles_x=bins.tiles_x, tiles_y=bins.tiles_y,
                pairs=int(bins.counts.sum()), chunk=max(chunk, 128),
                tile_px=tile_px, binning=binning)


def list_kernel_vs_plain(inp, what: str) -> dict:
    """K2 (K1's row and combine kernels over the aligned list stream)
    against its plain version (ops/composite.composite_lists at the
    kernel's chunk) on one frame's lists, at K2_TOL, NaN where the plain
    version has NaN; the ``tiles_composite`` counter and K1's two advance
    by one each; a second call gives the same bits."""
    import torch

    from dge_tpu_torch.ops import composite as CMP
    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.ops import tiles_composite as TT

    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"],
              chunk=inp["chunk"])
    args = (inp["feat"], inp["lists"], inp["counts"], inp["order"])
    before = dict(PC.launch_counts)
    got = TT.composite_tiles_kernel(*args, **kw)
    torch.cuda.synchronize()
    for k in PC.launch_counts:
        if PC.launch_counts[k] != before[k] + (k in K2_COUNTERS):
            raise AssertionError(f"{what}: launch counter {k} advanced by "
                                 f"{PC.launch_counts[k] - before[k]}")
    if not torch.equal(TT.composite_tiles_kernel(*args, **kw).nan_to_num(
            nan=7.0), got.nan_to_num(nan=7.0)):
        raise AssertionError(f"{what}: two launches differ")
    want = CMP.composite_lists(inp["lists"], inp["counts"], *inp["feats"],
                               order=inp["order"], **kw)
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError(f"{what}: the kernel's NaNs are not the plain "
                             "version's")
    # the layout kernel alone: the same bits as its plain version
    counts = inp["counts"].clamp(max=inp["lists"].shape[1])
    _, _, cum, rows = TT.list_rows(counts, inp["chunk"])
    layout = (inp["feat"], inp["lists"], counts, inp["order"], cum, rows,
              inp["chunk"])
    e_layout = 0.0
    for x, y in zip(TT.list_stream(*layout),
                    TT.list_stream_reference(*layout)):
        if not torch.equal(x.nan_to_num(nan=7.0), y.nan_to_num(nan=7.0)):
            raise AssertionError(f"{what}: the layout kernel differs from "
                                 "its plain version")
        if x.numel():
            e_layout = max(e_layout, float((x.float() - y.float())
                                           .nan_to_num().abs().max()))
    err = (got - want).nan_to_num().abs()
    e = [float(err[:, f].max()) if err.numel() else 0.0
         for f in (slice(0, 3), 3, 4)]
    log(f"  {what}: max|err| colour {e[0]:.3e} depth {e[1]:.3e} T "
        f"{e[2]:.3e}; bit-identical repeat; layout kernel = its plain "
        "version")
    if not (e[0] <= K2_TOL["color"] and e[1] <= K2_TOL["depth"]
            and e[2] <= K2_TOL["trans"]):
        raise AssertionError(f"{what}: K2 disagrees with its plain version "
                             f"({e}) > {K2_TOL}")
    return {"tiles_composite": max(e[0], e[2]), "list_stream": e_layout}


def list_times(inp, plain_reps: int = 3) -> dict:
    """At one frame's shapes: CUDA-event times of K2's wrapper, of its
    layout's two parts (``list_rows``, which holds the host read of the row
    count, and the gather ``list_stream``), of its plain version and of the
    list binning; from a profiler trace the device time of every kernel of
    one wrapper call (summed, and K1's row and combine kernels apart); K2's
    bound and the bounds of the two kernels at its rows."""
    import torch

    from dge_tpu_torch.ops import composite as CMP
    from dge_tpu_torch.ops import tiles_composite as TT

    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"],
              chunk=inp["chunk"])
    args = (inp["feat"], inp["lists"], inp["counts"], inp["order"])
    num_tiles = inp["counts"].shape[0]
    b_ms, b_by = bound_ms(inp["pairs"], num_tiles, inp["tile_px"],
                          bytes_per_pair=44)
    _, _, cum, rows = TT.list_rows(inp["counts"], inp["chunk"])
    rb = forward_bounds(inp["pairs"], num_tiles, rows, inp["tile_px"],
                        inp["chunk"])
    layout = (inp["feat"], inp["lists"], inp["counts"], inp["order"], cum,
              rows, inp["chunk"])
    # the layout's function: each entry's id (and order) and each listed
    # Gaussian's feature row read once, each entry's ten features and each
    # row's tile written (the zero padding past a tile's count is the
    # design's own); no arithmetic to speak of
    k = inp["lists"].shape[1]
    ids = inp["lists"][torch.arange(k, device=inp["lists"].device)[None]
                       < inp["counts"][:, None]]
    if inp["order"] is not None:
        ids = inp["order"][ids.long()]
    gaussians = int(torch.unique(ids).numel())
    per_entry = 4 + 4 * (inp["order"] is not None) + 40
    lay_bound = (inp["pairs"] * per_entry + gaussians * 40 + rows * 4) \
        / HBM_BYTES_PER_S * 1e3

    def wrapper():
        return TT.composite_tiles_kernel(*args, **kw)

    events, _ = profiled_kernels(wrapper, 10)
    dev = {e.key: dev_us(e) / 10 / 1e3 for e in events}  # per call
    return dict(
        ms=cuda_ms(wrapper, reps=20),
        device_ms=sum(dev.values()),
        row_device_ms=sum(v for k, v in dev.items()
                          if FORWARD_FORMS[False][2] in k),
        combine_device_ms=sum(v for k, v in dev.items()
                              if FORWARD_FORMS[False][3] in k),
        layout_device_ms=sum(v for k, v in dev.items()
                             if "rows_" not in k),
        list_stream_device_ms=sum(v for k, v in dev.items()
                                  if "list_stream_kernel" in k),
        list_rows_ms=cuda_ms(lambda: TT.list_rows(inp["counts"],
                                                  inp["chunk"]), reps=20),
        list_stream_ms=cuda_ms(lambda: TT.list_stream(*layout), reps=20),
        list_stream_plain_ms=cuda_ms(
            lambda: TT.list_stream_reference(*layout), reps=5, warmup=1),
        list_stream_bound_ms=lay_bound, listed_gaussians=gaussians,
        rows=rows, row_bound_ms=rb[0][0], combine_bound_ms=rb[1][0],
        combine_bound_by=rb[1][1],
        plain_ms=cuda_ms(lambda: CMP.composite_lists(
            inp["lists"], inp["counts"], *inp["feats"], order=inp["order"],
            **kw), reps=plain_reps, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        bin_gaussians_ms=cuda_ms(inp["binning"], reps=5, warmup=1))


def logdot_vs_plain(inp, what: str) -> float:
    """K5 against its plain version and against K1 on one stream."""
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.tools import proto_logdot as LD

    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"],
              chunk=inp["chunk"])
    args = (inp["data"], inp["starts"], inp["counts"])
    before = dict(PC.launch_counts)
    got = LD.composite_pairs_logdot(*args, **kw)
    torch.cuda.synchronize()
    for k in ("pairs_logdot", "pairs_logdot_combine"):
        if PC.launch_counts[k] != before[k] + 1:
            raise AssertionError(f"{k} launch counter did not advance")
    err = compare(got, LD.composite_pairs_logdot_reference(*args, **kw),
                  f"{what} K5 vs plain")
    k5_vs_k1(got, PC.composite_pairs_stream(*args, **kw), args, kw,
             f"{what} K5 vs K1")
    return err


def k5_vs_k1(k5, k1, args, kw, what: str) -> int:
    """K5 against K1 on one stream, ``[T, 5, P]`` each, within ``TOL`` at
    every pixel but those where rounding decides a refusal. The two forms
    composite alike but for the block's prefix, ``exp(sum log(1 - alpha))``
    in K5 and a product in K1, which part by a few 1e-5 relative over a
    block of hundreds of pairs; a pair whose ``T·cp`` lies that close to
    the 1e-4 stop can be refused by one form and kept by the other. A pixel
    that parts beyond ``TOL`` must equal, within ``TOL``, K1's plain
    version with the stop moved by ``STOP_NUDGE`` (relative) one way or the
    other: then such a pair, and nothing else, made the difference. Returns
    how many pixels were so explained."""
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC

    def beyond(x):
        err = (x - k5).abs()
        return ((err[:, 0:3] > TOL["color"]).any(1)
                | (err[:, 3] > TOL["depth"]) | (err[:, 4] > TOL["trans"]))

    bad = beyond(k1)
    if not bad.any():
        compare(k5, k1, what)
        return 0
    left = bad
    for s in (1.0 + STOP_NUDGE, 1.0 - STOP_NUDGE):
        left = left & beyond(PC.composite_pairs_reference(
            *args, stop=PC.T_EPS * s, **kw))
    n_bad, n_left = int(bad.sum()), int(left.sum())
    log(f"  {what}: {n_bad} pixels beyond the tolerance, {n_bad - n_left} "
        f"of them a refusal within {STOP_NUDGE} of the stop")
    if n_left:
        raise AssertionError(f"{what}: {n_left} pixels part beyond {TOL} "
                             "that no refusal at the stop explains")
    return n_bad


def k2_summary(t: dict) -> str:
    return (f"K2 {t['ms']:.4f} ms (events), device {t['device_ms']:.4f} ms "
            f"(row kernel {t['row_device_ms']:.4f}, combine "
            f"{t['combine_device_ms']:.4f}, layout {t['layout_device_ms']:.4f}"
            f" of which the layout kernel {t['list_stream_device_ms']:.4f}), "
            f"list_rows {t['list_rows_ms']:.4f} ms, list_stream "
            f"{t['list_stream_ms']:.4f} ms (plain "
            f"{t['list_stream_plain_ms']:.3f}, bound "
            f"{t['list_stream_bound_ms']:.5f}), rows {t['rows']}, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}; row kernel {t['row_bound_ms']:.5f}, combine "
            f"{t['combine_bound_ms']:.5f}), bin_gaussians "
            f"{t['bin_gaussians_ms']:.3f} ms")


def list_cell(name, scene, cam, bg, stream_start, *, chunk=64, **start):
    """Phase 6, full width on lists: probe a spill-free ``cuda_tiles``
    renderer, hold K2 against its plain version on the frame's lists, time
    the whole render, the list binning, the kernel and the plain version,
    and compare binning and image with the spill-free ``cuda_stream`` ones:
    the same pairs in every tile, and in the tiles that also hold them in
    the same order, images that differ by the chunk rule alone."""
    import torch

    from dge_tpu_torch.ops import render as R

    r = R.SpillFreeRenderer(scene, bg, tile_px=32, chunk=chunk,
                            backend="cuda_tiles",
                            log=lambda m: log(f"  [{name} lists] {m}"),
                            **start)
    if r.probe(cam) != 0:
        raise AssertionError(f"{name} lists: spill after the ladder")
    out = r.render(cam)
    if int(out.spill) != 0 or not bool(torch.isfinite(out.color).all()):
        raise AssertionError(f"{name} lists: spill or non-finite colour")
    rs = R.SpillFreeRenderer(scene, bg, tile_px=32, chunk=chunk,
                             **stream_start)
    if rs.probe(cam) != 0:
        raise AssertionError(f"{name}: cuda_stream spills after the ladder")
    stream = rs.render(cam)
    inp = list_inputs(scene, cam, r.caps, r.tight_cull, 32, chunk)
    sinp = stream_inputs(scene, cam, rs.caps, rs.tight_cull, 32, chunk)
    k = inp["lists"].shape[1]
    slot = torch.arange(k, device=scene.device)[None, :]
    pos = (sinp["starts"][:, None].long() + slot).clamp(
        max=sinp["pair_ids"].numel() - 1)
    none = torch.full_like(inp["lists"], -1)
    s_ids = torch.where(slot < sinp["counts"][:, None],
                        sinp["pair_ids"][pos], none)
    l_ids = torch.where(slot < inp["counts"][:, None], inp["lists"], none)
    if not torch.equal(s_ids.sort(dim=1).values, l_ids.sort(dim=1).values):
        raise AssertionError(f"{name}: list and stream binning keep "
                             "different pairs")
    same_order = (s_ids == l_ids).all(dim=1)  # [T]
    ys = torch.arange(cam.height, device=scene.device) // 32
    xs = torch.arange(cam.width, device=scene.device) // 32
    ordered = same_order[ys[:, None] * inp["tiles_x"] + xs[None, :]]  # [H, W]
    apart = (out.color - stream.color).abs().amax(-1)
    diff = float(apart.max())
    n_diff = int((apart > 1e-5).sum())
    rule = ordered & (apart > 1e-5)
    diff_rule = float(apart[ordered].max()) if bool(ordered.any()) else 0.0
    t_rule = float((1.0 - stream.alpha)[rule].max()) if bool(rule.any()) \
        else 0.0
    found = list_kernel_vs_plain(inp, f"{name} K2 vs plain")
    cell = dict(cell=name, render_ms=cuda_ms(lambda: r.render(cam), reps=10),
                **list_times(inp), entries=inp["pairs"],
                tiles=int(inp["counts"].shape[0]),
                list_width=int(inp["lists"].shape[1]),
                fullest_tile=int(inp["counts"].max()), chunk=inp["chunk"],
                caps=r.caps, tight_cull=r.tight_cull,
                max_abs_err=found["tiles_composite"],
                layout_max_abs_err=found["list_stream"],
                vs_stream_max_abs=diff, vs_stream_pixels_over_1e5=n_diff,
                tiles_in_stream_order=int(same_order.sum()),
                vs_stream_max_abs_in_those=diff_rule,
                vs_stream_max_final_t_in_those=t_rule)
    log(f"  {name} lists: render {cell['render_ms']:.3f} ms/frame, "
        f"{k2_summary(cell)}, entries "
        f"{cell['entries']}, fullest tile {cell['fullest_tile']}, list width "
        f"{cell['list_width']}, caps {r.caps}; image vs cuda_stream max|diff| "
        f"{diff:.3e} ({n_diff} pixels over 1e-5); {cell['tiles_in_stream_order']} "
        f"of {cell['tiles']} tiles hold their pairs in the stream's order, "
        f"and there max|diff| {diff_rule:.3e}, at pixels with final T up to "
        f"{t_rule:.3e}")
    if diff_rule > LIST_VS_STREAM_TOL or t_rule > LIST_VS_STREAM_TOL:
        raise AssertionError(
            f"{name}: in tiles of equal order cuda_tiles and cuda_stream "
            f"differ by {diff_rule}, at pixels with final T up to {t_rule}: "
            f"more than the chunk rule allows ({LIST_VS_STREAM_TOL})")
    return cell


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


def saturation_fixture(dev):
    """One 16x16 tile, chunk 128, every pair covering the tile with one
    alpha (conic 0): row 0 one pair 0.5 (every kept pair applied), row 1
    five pairs 0.9 (entered at T = 0.5: three applied, then refused: the
    combine walks the row), row 2 one pair 0.99 (entered at 5e-4: refused at
    once), row 3 two transparent pairs and one 0.5 (applied), row 4 only
    pairs without opacity."""
    import torch

    rows = [[0.5], [0.9] * 5, [0.99], [0.0, 0.0, 0.5], [0.0]]
    feat = torch.zeros(10, 128 * len(rows))
    feat[0:2] = 8.0
    feat[6] = 1.0
    feat[9] = 2.0
    for r, ops in enumerate(rows):
        feat[5, 128 * r:128 * r + len(ops)] = torch.tensor(ops)
        feat[7, 128 * r:128 * r + len(ops)] = 0.1 * (r + 1)
    return dict(data=feat.to(dev).contiguous(),
                starts=torch.zeros(1, dtype=torch.int32, device=dev),
                counts=torch.full((1,), feat.shape[1], dtype=torch.int32,
                                  device=dev),
                tiles_x=1, tiles_y=1, pairs=feat.shape[1], chunk=128,
                tile_px=16)


def nan_colour_forward(dev):
    """Five pairs every pixel applies, the third with a NaN red: K1's and
    K5's kernels give NaN red at every pixel, as the plain versions do, and
    agree with them on the rest."""
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.tools import proto_logdot as LD

    feat = torch.zeros(10, 8)
    feat[0:2] = 8.0
    feat[5] = 0.3
    feat[6:9] = 0.5
    feat[9] = 1.0
    feat[6, 2] = float("nan")
    args = (feat.to(dev).contiguous(),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.full((1,), 5, dtype=torch.int32, device=dev))
    kw = dict(tiles_x=1, tile_px=16, chunk=128)
    for got, want in (
            (PC.composite_pairs_stream(*args, **kw),
             PC.composite_pairs_reference(*args, **kw)),
            (LD.composite_pairs_logdot(*args, **kw),
             LD.composite_pairs_logdot_reference(*args, **kw))):
        if not (torch.equal(got.isnan(), want.isnan())
                and bool(got[0, 0].isnan().all())):
            raise AssertionError("forward NaN colour: the kernels' NaNs are "
                                 "not the plain versions'")
        compare(got.nan_to_num(), want.nan_to_num(), "forward NaN colour")
    log("  forward NaN colour: red NaN at every pixel in K1 and K5 as in "
        "the plain versions; the rest equal")


def refused_forward_launch(inp):
    """A chunk whose row stage exceeds what a block may have (96 KB at
    2048) is refused by the card: the wrapper raises and counts nothing,
    and the next launch is unharmed."""
    from dge_tpu_torch.ops import pairs_composite as PC

    args = (inp["data"], inp["starts"], inp["counts"])
    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"])
    good = PC.composite_pairs_stream(*args, chunk=inp["chunk"], **kw)
    old = PC.MAX_CHUNK
    PC.MAX_CHUNK = 4096
    before = dict(PC.launch_counts)
    try:
        PC.composite_pairs_stream(*args, chunk=2048, **kw)
    except RuntimeError as e:
        log(f"  refused forward launch raises: {e}")
    else:
        raise AssertionError("a refused forward launch did not raise")
    finally:
        PC.MAX_CHUNK = old
    if PC.launch_counts != before:
        raise AssertionError("a refused launch was counted")
    if not bool((PC.composite_pairs_stream(*args, chunk=inp["chunk"], **kw)
                 == good).all()):
        raise AssertionError("the launch after the refusal differs")


def nan_colour_lists(dev):
    """Two tiles' lists of five wide Gaussians, the third with a NaN red:
    K2 gives NaN red where its plain version does and agrees on the
    rest."""
    import torch

    feat = torch.zeros(8, 10)
    feat[:, 0:2] = 16.0  # mean at the corner the two 16-pixel tiles share
    feat[:, 2] = feat[:, 4] = 1e-3
    feat[:, 5] = 0.3
    feat[:, 6:9] = 0.5
    feat[:, 9] = 1.0
    feat[2, 6] = float("nan")
    feat = feat.to(dev)
    inp = dict(feat=feat.contiguous(), lists=torch.arange(
        5, dtype=torch.int32, device=dev).repeat(2, 1).contiguous(),
        counts=torch.full((2,), 5, dtype=torch.int32, device=dev),
        order=None, tiles_x=2, tile_px=16, chunk=128,
        feats=(feat[:, 0:2], feat[:, 2:5], feat[:, 6:9], feat[:, 9],
               feat[:, 5]))
    return list_kernel_vs_plain(inp, "list NaN colour K2")


def refused_list_launch(inp):
    """K2 at a chunk whose row stage exceeds what a block may have is
    refused by the card: the wrapper raises and counts nothing for K2, and
    the next launch is unharmed."""
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.ops import tiles_composite as TT

    args = (inp["feat"], inp["lists"], inp["counts"], inp["order"])
    kw = dict(tiles_x=inp["tiles_x"], tile_px=inp["tile_px"])
    good = TT.composite_tiles_kernel(*args, chunk=inp["chunk"], **kw)
    old = PC.MAX_CHUNK
    PC.MAX_CHUNK = 4096
    before = PC.launch_counts["tiles_composite"]
    try:
        TT.composite_tiles_kernel(*args, chunk=2048, **kw)
    except RuntimeError as e:
        log(f"  refused K2 launch raises: {e}")
    else:
        raise AssertionError("a refused K2 launch did not raise")
    finally:
        PC.MAX_CHUNK = old
    if PC.launch_counts["tiles_composite"] != before:
        raise AssertionError("a refused K2 launch was counted")
    if not torch.equal(TT.composite_tiles_kernel(*args, chunk=inp["chunk"],
                                                 **kw), good):
        raise AssertionError("the K2 launch after the refusal differs")


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
    k1 = forward_times(inp, plain_reps=1)
    plain_ms = cuda_ms(lambda: PC.composite_pairs_reference(*args, **kw),
                       reps=3, warmup=1)
    stages = stage_ms(scene, cam, r.caps, r.tight_cull, 32)
    b_ms, b_by = bound_ms(inp["pairs"], inp["starts"].shape[0], 32)
    cell = dict(cell=name, render_ms=render_ms, **stages, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, k1=k1,
                pairs=inp["pairs"], tiles=int(inp["starts"].shape[0]),
                chunk=inp["chunk"], caps=r.caps, tight_cull=r.tight_cull,
                max_abs_err=err)
    log(f"  {name}: render {render_ms:.3f} ms/frame, K1 {kernel_ms:.3f} "
        f"ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"pairs {inp['pairs']}, caps {r.caps}, tight_cull {r.tight_cull}")
    log(f"  {name} K1's kernels: " + "; ".join(
        f"{k} {v}" for k, v in k1.items() if isinstance(v, dict)))
    log(f"  {name} stages: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in stages.items()))
    return cell


def attention_vs_chunked(dev) -> list:
    """SDPA, pinned to ``EFFICIENT_ATTENTION`` by the port's rule
    (``layers.sdpa_takes``), against the chunked plain attention (k_chunk
    1024) at the pivot pass's full shapes: 3 CFG chunks x 8 heads over 2 key
    frames of the 64^2 latent's blocks (head width 40 over 8,192 tokens, 80
    over 2,048, 160 over 512), and the VAE mid block's one head of 512 over
    4,096 tokens for 5 views; within 1e-4·max|out|. Prints the backend each
    head width takes."""
    import torch

    from dge_tpu_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for b, h, s, d in ((3, 8, 8192, 40), (3, 8, 2048, 80), (3, 8, 512, 160),
                       (5, 1, 4096, 512)):
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   for _ in range(3))
        got = L.attend_heads(q, k, v, k_chunk=1024)
        want = L.attend_chunked(q, k, v, k_chunk=1024)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        res = dict(
            shape=[b, h, s, d],
            backend=("EFFICIENT_ATTENTION" if L.sdpa_takes(d, q.dtype)
                     else "chunked"),
            max_abs_err=err, max_abs_out=scale,
            ms=cuda_ms(lambda: L.attend_heads(q, k, v)),
            plain_ms=cuda_ms(lambda: L.attend_chunked(q, k, v, 1024), reps=3,
                             warmup=1))
        log(f"  attention {res}")
        if err > SDPA_TOL * scale:
            raise AssertionError(f"attention {res['shape']}: SDPA differs "
                                 f"from the chunked version by {err}")
        out.append(res)
    return out


def blockwise_vs_dense(cams, dev) -> dict:
    """``epi_blockwise_argmax`` against the dense path of the pivot reuse at
    a full-width 32^2 latent (S = 1,024 tokens of width 640, the second down
    block): 5 capture views (pivot 2) against 2 key views, normalised random
    tokens; the indices must agree wherever the dense top-2 gap exceeds
    1e-5."""
    import torch

    from dge_tpu_torch.models import layers as L
    from dge_tpu_torch.parallel.mesh import stack_cameras
    from dge_tpu_torch.systems import guidance as GD

    cams_b, keys = stack_cameras(cams[5:10]), stack_cameras([cams[1], cams[7]])
    band = GD.make_cross_view_state(cams_b, keys, 2, 32, 32, 2, 1.0, "banded")
    dense = GD.make_cross_view_state(cams_b, keys, 2, 32, 32, 2, 1.0, "dense")
    gen = torch.Generator(device=dev).manual_seed(1)
    img = L._unit(torch.randn(5, 1024, 640, generator=gen, device=dev))
    piv = L._unit(torch.randn(5, 2, 1024, 640, generator=gen, device=dev))

    def banded():
        return L.epi_blockwise_argmax(img, piv, band.epi_lines[1024],
                                      band.epi_pts[1024], 1.0)

    def dense_masked():
        sim = torch.einsum("fsd,fktd->fkst", img, piv)
        viol = dense.epipolar[1024]
        return torch.where(viol & ~viol.all(dim=-1, keepdim=True), 0.0, sim)

    sim = dense_masked()
    top2 = sim.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > ARGMAX_GAP
    got, want = banded(), sim.argmax(dim=-1)
    res = dict(queries=int(clear.numel()), clear=int(clear.sum()),
               mismatched_clear=int(((got != want) & clear).sum()),
               mismatched_all=int((got != want).sum()),
               ms=cuda_ms(banded, reps=5, warmup=1),
               dense_ms=cuda_ms(lambda: dense_masked().argmax(dim=-1),
                                reps=5, warmup=1))
    log(f"  epi_blockwise_argmax vs dense at S=1024: {res}")
    if res["mismatched_clear"]:
        raise AssertionError("epi_blockwise_argmax differs from the dense "
                             "path where the top-2 gap exceeds 1e-5")
    return res


def edit_stage_times(cams, dev) -> dict:
    """CUDA-event medians at the edit path's full shapes (SD-1.5 widths,
    random weights, 64^2 latents of the 512^2 guidance input, 10 views in 2
    camera batches of 5, text of 77 tokens): the UNet in plain mode at batch
    15 (5 views x 3 CFG chunks), the pivot pass (2 key frames x 3) and one
    2-key reuse pass (batch 15); the VAE encode and decode of 5 views at
    512^2; one DDIM step of the loop at t >= 100 (pivot pass, both reuse
    passes, CFG, update)."""
    import torch

    from dge_tpu_torch.diffusion import ddim
    from dge_tpu_torch.diffusion import ip2p as P
    from dge_tpu_torch.parallel.mesh import stack_cameras
    from dge_tpu_torch.systems import guidance as GD

    models = P.build_models(seed=0, device=dev)
    g = GD.DGEGuidance(GD.GuidanceConfig(camera_batch_size=EDIT_BATCH),
                       models)
    gen = torch.Generator(device=dev).manual_seed(2)
    n = EDIT_VIEWS
    lat = torch.randn(n, 64, 64, 4, generator=gen, device=dev)
    cond = torch.randn(3 * n, 64, 64, 4, generator=gen, device=dev)
    te = torch.randn(3 * n, 77, 768, generator=gen, device=dev)
    t = 500

    def inp(idx):
        return torch.cat([P.triple(lat[idx]), cond[:3 * len(idx)]], dim=-1)

    batch = torch.arange(EDIT_BATCH, 2 * EDIT_BATCH, device=dev)
    piv = torch.tensor([2, 7], device=dev)
    record = {}
    cams_all = stack_cameras(cams[:n])
    cv = GD.make_cross_view_state(stack_cameras(cams[5:10]),
                                  stack_cameras([cams[2], cams[7]]), 2, 64,
                                  64, 2)
    imgs = torch.rand(EDIT_BATCH, 512, 512, 3, generator=gen, device=dev)
    emb_pos, emb_neg = te[:n], te[n:2 * n]
    cond_img, cond_zero = cond[:n], torch.zeros_like(cond[:n])

    def triple_for(idx):
        return (torch.cat([emb_pos[idx], emb_neg[idx], emb_neg[idx]]),
                torch.cat([cond_img[idx], cond_img[idx], cond_zero[idx]]))

    def one_step():
        eps = g._predict_eps_multiview(lat, t, cams_all, triple_for, n,
                                       EDIT_BATCH, n // EDIT_BATCH, 64, 64,
                                       gen)
        return ddim.step(models.schedule, eps, t, lat, 20)

    res = dict(
        unet_plain_b15_ms=cuda_ms(lambda: P.unet_eps(
            models, inp(batch), t, te[:15]), reps=3, warmup=1),
        pivot_pass_b6_ms=cuda_ms(lambda: P.unet_eps(
            models, inp(piv), t, te[:6], mode="pivot_record", pivot=record),
            reps=3, warmup=1),
        reuse_pass_b15_ms=cuda_ms(lambda: P.unet_eps(
            models, inp(batch), t, te[:15], mode="pivot_reuse",
            cross_view=cv, pivot=record), reps=3, warmup=1),
        vae_encode_5x512_ms=cuda_ms(lambda: P.encode_images(models, imgs,
                                                             gen),
                                    reps=3, warmup=1),
        vae_decode_5x512_ms=cuda_ms(lambda: P.decode_latents(models,
                                                             lat[:5]),
                                    reps=3, warmup=1),
        ddim_step_10_views_ms=cuda_ms(one_step, reps=3, warmup=1))
    log(f"  edit path stages: {res}")
    del models, g, record
    return res


def save_random_clip(root: str, dev, vision_cfg=None, text_cfg=None):
    """A CLIP pair of towers on random weights (seed 0; ViT-L/14 and a
    768-projected text tower unless configs are given) saved as a local
    transformers-layout directory (``pytorch_model.bin``, ``config.json``
    with the head counts) for ``system.clip_checkpoint``; returns the
    scorer built from the same weights."""
    import torch

    from dge_tpu_torch.models import clip_vision as CV

    sim = CV.build_clip_similarity(vision_cfg=vision_cfg, text_cfg=text_cfg,
                                   device=dev)
    state = {k: v.cpu() for m in (sim.vision, sim.text)
             for k, v in m.state_dict().items()}
    os.makedirs(root, exist_ok=True)
    torch.save(state, os.path.join(root, "pytorch_model.bin"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({f"{name}_config": {"num_attention_heads":
                                      m.config.num_heads}
                   for name, m in (("vision", sim.vision),
                                   ("text", sim.text))}, f)
    return sim


def local_edit_checks(run, scene0, views: int, steps: int, size: int):
    """Phase 8 (a)'s checks of one ``--train --config configs/dge.yaml``
    local edit: the batched reuse, a spill-free lift, a grad mask that is
    neither empty nor everything, every masked field (all but rotation, as
    in the reference) of every Gaussian outside it bit-identical after the
    refit and some inside moved, the edited frames, spill 0.
    Returns the mask's size."""
    import numpy as np
    import torch

    from dge_tpu_torch.systems.optim import MASKED_FIELDS

    system = run.system
    if system.guidance.cfg.batch_mode != "vmap":
        raise AssertionError(f"local edit: batch_mode "
                             f"{system.guidance.cfg.batch_mode!r}")
    if system.lift_spill or system.lift_caps is None:
        raise AssertionError(f"local edit: lift spill {system.lift_spill}, "
                             f"caps {system.lift_caps}")
    mask = system.scene.grad_mask > 0
    n_mask, n_alive = int(mask.sum()), system.scene.n_alive
    if not 0 < n_mask < n_alive:
        raise AssertionError(f"local edit: grad mask holds {n_mask} of "
                             f"{n_alive} alive Gaussians")
    scene = system.scene
    if not torch.equal(scene.alive, scene0.alive):
        raise AssertionError("local edit: the alive set changed")
    # the grad mask holds the fields the reference hooks; rotation is not
    # one of them (gaussian_model.py:841-851; ROADMAP.md §3)
    outside = scene0.alive & ~mask
    moved = 0.0
    for k in MASKED_FIELDS:
        a, b = getattr(scene, k), getattr(scene0, k)
        if not torch.equal(a[outside], b[outside]):
            raise AssertionError(f"local edit: {k} changed outside the "
                                 "grad mask")
        if a[mask].numel():
            moved = max(moved, float((a[mask] - b[mask]).abs().max()))
    if moved <= 0.0:
        raise AssertionError("local edit: nothing inside the mask moved")
    rot_outside = float((scene.rotation[outside]
                         - scene0.rotation[outside]).abs().max())
    frames = [run.edit_frames[v] for v in sorted(run.edit_frames)]
    bad = [i for i, f in enumerate(frames)
           if f.shape != (size, size, 3) or not np.isfinite(f).all()
           or f.min() < 0.0 or f.max() > 1.0]
    if len(frames) != views or bad:
        raise AssertionError(f"local edit: {len(frames)} frames, bad {bad}")
    if not run.losses_finite or run.spill or run.render_spill:
        raise AssertionError(f"local edit: losses finite "
                             f"{run.losses_finite}, spill {run.spill} / "
                             f"{run.render_spill}")
    if run.steps != steps:
        raise AssertionError(f"local edit: {run.steps} steps")
    return dict(mask=n_mask, alive=n_alive, lift_caps=system.lift_caps,
                inside_moved_max=moved,
                outside_rotation_moved_max=rot_outside)


def loop_vs_vmap_step(models, cams, views: int, batch: int, lat: int,
                      dev, reps: int = 3) -> dict:
    """One DDIM step over ``views`` views at t = 500 (pivot pass, reuse,
    CFG, update) in ``"loop"`` and in ``"vmap"`` mode from the same draws,
    with their CUDA-event times.

    The two modes run the same arithmetic at other batch sizes, so cuBLAS
    and cuDNN sum in other orders, and the reuse's cosine argmax can flip
    at a near-tie, which moves a gathered token. So: (1) each reuse block's
    gather indices of the vmap pass are held against the loop's, and every
    index that differs must be a tie within 1e-5 of masked cosine
    similarity (``ARGMAX_GAP``); (2) the vmap step with the loop's indices
    handed to its gather must equal the loop's within 2e-4; (3) the free
    vmap step's difference is reported."""
    import torch

    from dge_tpu_torch.diffusion import ddim
    from dge_tpu_torch.models import layers as L
    from dge_tpu_torch.parallel.mesh import stack_cameras
    from dge_tpu_torch.systems import guidance as GD

    gen = torch.Generator(device=dev).manual_seed(3)
    d = models.unet.config.cross_attention_dim
    x = torch.randn(views, lat, lat, 4, generator=gen, device=dev)
    cond = torch.randn(views, lat, lat, 4, generator=gen, device=dev)
    te = torch.randn(2 * views, 77, d, generator=gen, device=dev)
    cams_all = stack_cameras(cams[:views])
    n_batches = views // batch

    def triple_for(idx):
        return (torch.cat([te[idx], te[views + idx], te[views + idx]]),
                torch.cat([cond[idx], cond[idx], torch.zeros_like(
                    cond[idx])]))

    guides = {mode: GD.DGEGuidance(GD.GuidanceConfig(
        camera_batch_size=batch, batch_mode=mode), models)
        for mode in ("loop", "vmap")}

    def step(mode):
        with torch.no_grad():
            eps = guides[mode]._predict_eps_multiview(
                x, 500, cams_all, triple_for, views, batch, n_batches, lat,
                lat, torch.Generator(device=dev).manual_seed(4))
            return ddim.step(models.schedule, eps, 500, x, 20)

    real = L.epi_blockwise_argmax
    loop_idx, flips, gaps = [], [], []

    def recording(*args, **kw):
        loop_idx.append(real(*args, **kw))
        return loop_idx[-1]

    def forced(img, piv_img, lines, pts, threshold, block=512):
        """The vmap pass's own indices, counted against the loop's, which
        it returns: batch 0's single key duplicated, the rest as they
        are."""
        j = len(flips)
        n = len(loop_idx) // n_batches
        want = torch.cat([loop_idx[j].expand(-1, 2, -1)]
                         + [loop_idx[i * n + j]
                            for i in range(1, n_batches)])
        own = real(img, piv_img, lines, pts, threshold, block)
        f, k, q = torch.nonzero(own != want, as_tuple=True)
        flips.append(int(f.numel()))
        for a, b, c in zip(f.tolist(), k.tolist(), q.tolist()):
            sims = piv_img[a, b] @ img[a, c]  # [S]
            viol = (lines[a, b, c] @ pts.T).abs() > threshold
            masked = sims if bool(viol.all()) else torch.where(
                viol, 0.0, sims)
            gaps.append(float((masked[own[a, b, c]]
                               - masked[want[a, b, c]]).abs()))
        return want

    out = {}
    try:
        L.epi_blockwise_argmax = recording
        out["loop"] = step("loop")
        L.epi_blockwise_argmax = forced
        out["forced"] = step("vmap")
    finally:
        L.epi_blockwise_argmax = real
    out["vmap"] = step("vmap")
    res = dict(
        loop_ms=cuda_ms(lambda: step("loop"), reps=reps, warmup=1)
        if dev.type == "cuda" else None,
        vmap_ms=cuda_ms(lambda: step("vmap"), reps=reps, warmup=1)
        if dev.type == "cuda" else None,
        max_abs_diff=float((out["loop"] - out["forced"]).abs().max()),
        free_max_abs_diff=float((out["loop"] - out["vmap"]).abs().max()),
        max_abs=float(out["loop"].abs().max()),
        gathered=sum(int(i.numel()) for i in loop_idx),
        flips=sum(flips), flip_max_gap=max(gaps, default=0.0))
    log(f"  one DDIM step of {views} views, loop vs vmap: {res}")
    if res["flip_max_gap"] > ARGMAX_GAP:
        raise AssertionError(f"vmap's gather differs from the loop's away "
                             f"from a tie: gap {res['flip_max_gap']}")
    if not res["max_abs_diff"] <= VMAP_TOL:
        raise AssertionError(f"vmap differs from loop by "
                             f"{res['max_abs_diff']} with the same gather")
    return res


def sds_checks(run, scene0, batch: int, steps: int) -> dict:
    """Phase 8 (b)'s checks of one ``--train system.edit.use_sds=true``
    run: finite losses, parameters moved, densification statistics
    accumulated, no edit frames, spill 0."""
    from dge_tpu_torch.scene.gaussians import PARAM_NAMES

    system = run.system
    moved = max(float((getattr(system.scene, k) - getattr(scene0, k)).abs()
                      .max()) for k in PARAM_NAMES
                if getattr(scene0, k).numel())
    denom = float(system.fit_state.denom.max())
    if not run.losses_finite or moved <= 0.0 or denom <= 0.0:
        raise AssertionError(f"SDS: losses finite {run.losses_finite}, "
                             f"moved {moved}, denom max {denom}")
    if run.edit_frames or run.spill or run.render_spill:
        raise AssertionError(f"SDS: {len(run.edit_frames)} edit frames, "
                             f"spill {run.spill} / {run.render_spill}")
    if run.steps != steps or system.fit_state.step != steps:
        raise AssertionError(f"SDS: {run.steps} steps")
    return dict(params_moved_max=moved, denom_max=denom)


def sds_grads_vs_plain(system, batch: int, dev) -> dict:
    """One SDS refit's loss and gradients through the kernels
    (``cuda_train``: K1, K3, suffix, K4, fold) against the same loss on the
    plain render (``backend="torch"``, autograd) on the same device, within
    2e-3·max|g| per field."""
    import torch

    from dge_tpu_torch.diffusion import ip2p as P

    vids = system.view_list[:batch]
    cam = system.cameras[vids[0]]
    rh, rw = P.resize_to_64_multiple(cam.height, cam.width,
                                     system.guidance.cfg.resize_target)
    shape = P.latent_shape(system.guidance.models,
                           torch.zeros(batch, rh, rw, 3))
    gen = torch.Generator(device=dev).manual_seed(6)
    target = torch.randn(shape, generator=gen, device=dev)
    noise = torch.randn(shape, generator=gen, device=dev)
    loss_k, g_k, _ = system.sds_loss_and_grads(vids, target, noise)
    loss_p, g_p, _ = system.sds_loss_and_grads(vids, target, noise,
                                               backend="torch")
    rel = {k: float((g_k[k] - g_p[k]).abs().max())
           / max(float(g_p[k].abs().max()), 1e-30) for k in g_p
           if g_p[k].numel()}
    res = dict(loss=float(loss_k), plain_loss=float(loss_p), rel_err=rel)
    log(f"  SDS gradients, kernels vs plain render: {res}")
    if max(rel.values()) > GRAD_TOL or abs(
            float(loss_k) - float(loss_p)) > 1e-5 * abs(float(loss_p)):
        raise AssertionError("SDS gradients: kernels differ from the plain "
                             "render")
    return res


def vae_encode_fwd_bwd(models, views: int, size: int, dev) -> dict:
    """The VAE encoder's forward + backward (to the images) at ``views``
    images of ``size``^2: CUDA-event ms and peak memory."""
    import torch

    from dge_tpu_torch.diffusion import ip2p as P

    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.rand(views, size, size, 3, generator=gen, device=dev,
                   requires_grad=True)
    noise = torch.randn(P.latent_shape(models, x), generator=gen,
                        device=dev)

    def fwd_bwd():
        lat = P.encode_images_with(models, x, noise)
        return torch.autograd.grad(lat.square().sum(), x)[0]

    torch.cuda.reset_peak_memory_stats()
    g = fwd_bwd()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("VAE encoder backward: non-finite gradient")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return dict(ms=cuda_ms(fwd_bwd, reps=3, warmup=1),
                fwd_ms=cuda_ms(lambda: P.encode_images_with(
                    models, x.detach(), noise), reps=3, warmup=1),
                peak_memory_gib=peak)


def clip_checks(sim, src, edit) -> dict:
    """ClipSimilarity over the phase's original and edited frames: four
    finite arrays of the views' length; identical images score sim_image 1
    within 1e-5."""
    import numpy as np

    n = len(src)
    texts = (["a photo of a man"] * n, ["turn him into a clown"] * n)
    out = sim(src, edit, *texts)
    same = sim(src, src, *texts)[3]
    bad = [i for i, o in enumerate(out)
           if o.shape != (n,) or not np.isfinite(o).all()]
    if bad or float(np.abs(same - 1.0).max()) > CLIP_TOL:
        raise AssertionError(f"CLIP: outputs {bad} bad, identical images "
                             f"score {same}")
    return dict(means=[float(np.mean(o)) for o in out],
                identical_max_err=float(np.abs(same - 1.0).max()))


# ---- phase 9: multi-GPU on the one card ----------------------------------
# The rank functions run in ranks that dge_tpu_torch.parallel.dist.spawn_local
# starts (gloo, every rank on cuda:0); each returns numpy arrays and its
# per-scenario report.

def _qg_inputs(dev, views):
    """The quality-gate scene and the capture's cameras and images of
    ``views`` at 256^2 (stacked)."""
    import torch

    from dge_tpu_torch.parallel.mesh import stack_cameras
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.utils import saving

    cs = DS.ColmapScene(CAPTURE, height=256, width=256)
    cams = [cs.cameras[v] for v in views]
    targets = torch.stack([torch.from_numpy(saving.load_image(os.path.join(
        CAPTURE, "images", c.image_name + ".png"))) for c in cams]).to(dev)
    return (G.load_ply(QUALITY_PLY, device=dev),
            stack_cameras([CameraArrays.from_camera(c, device=dev)
                           for c in cams]), targets)


def _scenario(report, name, fn):
    """Run ``fn`` once with the launch counters and collective stats set to
    0 just before (its result is what the gates hold), then once more
    timed with CUDA events; record launches, ms, collective ms and calls of
    the timed run, and peak memory, under ``report[name]``."""
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.parallel import dist as D

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PC.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(PC.launch_counts)
    D.reset_collective_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    report[name] = dict(
        launches=launches, ms=start.elapsed_time(end),
        collective_ms=1e3 * D.collective_stats["seconds"],
        collectives=D.collective_stats["calls"],
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def _params_np(scene):
    from dge_tpu_torch.scene.gaussians import PARAM_NAMES

    return {k: getattr(scene, k).detach().cpu().numpy() for k in PARAM_NAMES}


def _step_np(res):
    """One train step's result from a fresh Adam state: the parameters, the
    gradients (the first moment after one step is (1 - b1)·g), the loss,
    the spill and ``denom``."""
    from dge_tpu_torch.systems.optim import B1

    scene, opt_state, fit_state, aux = res
    return dict(params=_params_np(scene), loss=float(aux["loss"]),
                grads={k: st["mu"].cpu().numpy() / (1.0 - B1)
                       for k, st in opt_state.items()},
                spill=int(aux.get("spill", 0)),
                denom=fit_state.denom.cpu().numpy())


def _fresh_opt(scene):
    from dge_tpu_torch.systems import optim as O
    from dge_tpu_torch.systems.fit import FitState

    opt = O.make_optimizer(O.OptimConfig.scaled(100))
    return opt, opt.init(scene.params()), FitState.create(scene.capacity,
                                                          scene.device)


def multi_world2(dev, qg_caps, views):
    """World 2: the view-sharded step (one capture view a rank, SSIM on)
    and one shard-mode DDIM step at full SD-1.5 width."""
    import torch

    from dge_tpu_torch.diffusion import ip2p
    from dge_tpu_torch.parallel import mesh as M
    from dge_tpu_torch.parallel import shard as S
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene.camera_arrays import CameraArrays

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report, out = {}, {}
    scene, cams, targets = _qg_inputs(dev, views)
    bg = torch.zeros(3, device=dev)
    opt, st, fs = _fresh_opt(scene)
    step = S.make_sharded_train_step(opt, M.make_view_mesh(2), **qg_caps)
    out["view_step"] = _step_np(_scenario(
        report, "view_step", lambda: step(scene, st, fs, cams, targets, bg)))
    cs = DS.ColmapScene(CAPTURE, height=256, width=256)
    ecams = [CameraArrays.from_camera(c, device=dev)
             for c in DS.subsample_views(cs.cameras, EDIT_VIEWS)]
    models = ip2p.build_models(device=dev)
    out["shard_edit"] = shard_vs_vmap_step(models, ecams, EDIT_VIEWS,
                                           EDIT_BATCH, 64, dev, report)
    return dict(out=out, report=report)


def multi_world4(dev, bench_caps, qg_caps, views):
    """World 4: the bench scene at 512^2 in 4 tile bands, in gauss x tile
    2 x 2 and in 4 depth slabs; the depth-slab train step (capture view
    ``views[0]``) and the view x tile step (2 x 2, SSIM on) on the
    quality-gate scene."""
    import torch

    from dge_tpu_torch.parallel import gauss_shard as GS
    from dge_tpu_torch.parallel import mesh as M
    from dge_tpu_torch.parallel import tile_shard as TS
    from dge_tpu_torch.scene import gaussians as G

    report, out = {}, {}
    bench = G.load_ply(BENCH_PLY, device=dev)
    cam = bench_camera(512, 512, dev)
    bg = torch.zeros(3, device=dev)

    def np_render(res):
        return [x.cpu().numpy() if torch.is_tensor(x) and x.dim() else int(x)
                for x in res]

    fn = TS.make_tile_sharded_render(TS.make_tile_mesh(4), 512, 512,
                                     **bench_caps)
    out["tile_render"] = np_render(_scenario(report, "tile_render",
                                             lambda: fn(bench, cam, bg)))
    gt = TS.make_gauss_tile_mesh(2, 2)
    blk = GS.shard_scene(bench, gt)
    fn2 = TS.make_gauss_tile_render(gt, 512, 512, **bench_caps)
    out["gauss_tile_render"] = np_render(_scenario(
        report, "gauss_tile_render", lambda: fn2(blk, cam, bg)))
    gm = GS.make_gauss_mesh(4)
    sblk = GS.shard_scene(bench, gm)
    fn3 = GS.make_depth_slab_render(gm, 512, 512, **bench_caps)
    out["slab_render"] = np_render(_scenario(
        report, "slab_render", lambda: fn3(sblk, cam, bg)))
    del bench, blk, sblk

    scene, cams, targets = _qg_inputs(dev, views)
    opt, st, fs = _fresh_opt(scene)
    sstep = GS.make_depth_slab_train_step(opt, gm, 256, 256, **qg_caps)
    qblk = GS.shard_scene(scene, gm)
    st_b = GS.shard_rows(st, scene.capacity, gm)
    fs_b = GS.shard_rows(fs, scene.capacity, gm)
    res = _scenario(report, "slab_step", lambda: sstep(
        qblk, st_b, fs_b, M.index_cameras(cams, 0), targets[0], bg))
    out["slab_step"] = _step_np((GS.gather_scene(res[0], gm),
                                 GS.gather_rows(res[1], gm),
                                 GS.gather_rows(res[2], gm), res[3]))
    opt, st, fs = _fresh_opt(scene)
    vt = TS.make_view_tile_train_step(opt, TS.make_view_tile_mesh(2, 2),
                                      256, 256, **qg_caps)
    out["view_tile_step"] = _step_np(_scenario(
        report, "view_tile_step",
        lambda: vt(scene, st, fs, cams, targets, bg)))
    return dict(out=out, report=report)


def shard_vs_vmap_step(models, cams, views: int, batch: int, lat: int, dev,
                       report=None) -> dict:
    """One DDIM step over ``views`` views at t = 500 in ``"vmap"`` mode on
    this rank and in ``"shard"`` mode over the process group, from the same
    draws (``loop_vs_vmap_step``'s inputs). With one rank the two are the
    same computation and must be equal bit for bit; with more, each rank's
    reuse gather indices are held against the vmap pass's rows of its
    frames (a difference only at a tie within ``ARGMAX_GAP``), and the shard
    step with the vmap indices handed over must be within ``VMAP_TOL``."""
    import torch

    from dge_tpu_torch.diffusion import ddim
    from dge_tpu_torch.models import layers as L
    from dge_tpu_torch.parallel import dist as D
    from dge_tpu_torch.parallel.mesh import stack_cameras
    from dge_tpu_torch.systems import guidance as GD

    gen = torch.Generator(device=dev).manual_seed(3)
    d = models.unet.config.cross_attention_dim
    x = torch.randn(views, lat, lat, 4, generator=gen, device=dev)
    cond = torch.randn(views, lat, lat, 4, generator=gen, device=dev)
    te = torch.randn(2 * views, 77, d, generator=gen, device=dev)
    cams_all = stack_cameras(cams[:views])
    n_batches = views // batch
    world, me = D.world_size(), D.rank()
    nd = max(k for k in range(1, world + 1) if n_batches % k == 0)
    lo = me * (n_batches // nd) * batch if me < nd else 0
    hi = lo + (n_batches // nd) * batch

    def triple_for(idx):
        return (torch.cat([te[idx], te[views + idx], te[views + idx]]),
                torch.cat([cond[idx], cond[idx], torch.zeros_like(
                    cond[idx])]))

    guides = {mode: GD.DGEGuidance(GD.GuidanceConfig(
        camera_batch_size=batch, batch_mode=mode), models)
        for mode in ("vmap", "shard")}

    def step(mode):
        with torch.no_grad():
            eps = guides[mode]._predict_eps_multiview(
                x, 500, cams_all, triple_for, views, batch, n_batches, lat,
                lat, torch.Generator(device=dev).manual_seed(4))
            return ddim.step(models.schedule, eps, 500, x, 20)

    real = L.epi_blockwise_argmax
    vmap_idx, flips, gaps = [], [], []

    def recording(*args, **kw):
        vmap_idx.append(real(*args, **kw))
        return vmap_idx[-1]

    def forced(img, piv_img, lines, pts, threshold, block=512):
        """This rank's own indices, counted against the vmap pass's rows of
        its frames, which it returns."""
        want = vmap_idx[len(flips)][lo:hi]
        own = real(img, piv_img, lines, pts, threshold, block)
        f, k, q = torch.nonzero(own != want, as_tuple=True)
        flips.append(int(f.numel()))
        for a, b, c in zip(f.tolist(), k.tolist(), q.tolist()):
            sims = piv_img[a, b] @ img[a, c]
            viol = (lines[a, b, c] @ pts.T).abs() > threshold
            masked = sims if bool(viol.all()) else torch.where(
                viol, 0.0, sims)
            gaps.append(float((masked[own[a, b, c]]
                               - masked[want[a, b, c]]).abs()))
        return want

    out = {}
    try:
        L.epi_blockwise_argmax = recording
        out["vmap"] = step("vmap")
        L.epi_blockwise_argmax = forced
        out["forced"] = step("shard")
    finally:
        L.epi_blockwise_argmax = real
    rep = {} if report is None else report
    out["shard"] = _scenario(rep, "shard_ddim_step", lambda: step("shard"))
    vmap_ms = cuda_ms(lambda: step("vmap"), reps=3, warmup=1)
    res = dict(
        world=world, shard_ms=rep["shard_ddim_step"]["ms"],
        vmap_ms=vmap_ms,
        max_abs_diff=float((out["vmap"] - out["forced"]).abs().max()),
        free_max_abs_diff=float((out["vmap"] - out["shard"]).abs().max()),
        bit_identical=bool(torch.equal(out["vmap"], out["shard"])),
        max_abs=float(out["vmap"].abs().max()),
        gathered=sum(int(i[lo:hi].numel()) for i in vmap_idx),
        flips=sum(flips), flip_max_gap=max(gaps, default=0.0))
    if res["flip_max_gap"] > ARGMAX_GAP:
        raise AssertionError(f"shard's gather differs from vmap's away from "
                             f"a tie: gap {res['flip_max_gap']}")
    if not res["max_abs_diff"] <= VMAP_TOL:
        raise AssertionError(f"shard differs from vmap by "
                             f"{res['max_abs_diff']} with the same gather")
    if world == 1 and not res["bit_identical"]:
        raise AssertionError("one rank: shard step != vmap step bit for bit")
    return res


def _max_param_diff(a: dict, b: dict) -> float:
    import numpy as np

    return max(float(np.abs(a[k] - b[k]).max(initial=0.0)) for k in a)


def step_vs(got: dict, want: dict) -> dict:
    """A train step held against another from the same fresh state: the
    loss difference; each field's gradient difference over
    ``max|g| + 1e-7 / GRAD_TOL`` (the kernels' gradient rule); the entries
    whose two gradients differ in sign, zero against non-zero included
    (Adam's first step moves each entry by lr·g/(|g| + eps), about ±lr, so
    such an entry alone parts the parameters by up to 2·lr); the largest
    parameter difference where both gradients are at least ``ADAM_FLOOR``
    (``params_max``), and over all entries, with the gradient of the entry
    (``params_max_all``, ``grad_at_max_all``): below the floor Adam's step
    turns the last bits of a gradient of ~eps into up to ~lr."""
    import numpy as np

    gerr, flips, worst, worst_all, g_all = 0.0, 0, 0.0, 0.0, 0.0
    for k, w in want["grads"].items():
        g = got["grads"][k]
        gerr = max(gerr, float(np.abs(g - w).max(initial=0.0))
                   / (float(np.abs(w).max(initial=0.0)) + 1e-7 / GRAD_TOL))
        flips += int((np.sign(g) != np.sign(w)).sum())
        d = np.abs(got["params"][k] - want["params"][k])
        small = np.minimum(np.abs(g), np.abs(w))
        worst = max(worst, float(d[small >= ADAM_FLOOR].max(initial=0.0)))
        if d.size and float(d.max()) > worst_all:
            worst_all = float(d.max())
            g_all = float(small.flat[int(d.argmax())])
    return dict(loss=abs(got["loss"] - want["loss"]), grad_rel=gerr,
                sign_flips=flips, params_max=worst,
                params_max_all=worst_all, grad_at_max_all=g_all)


def slab_step_one_rank(optimizer, scene, opt_state, fit_state, cam, target,
                       bg, n_slabs: int, *, lambda_dssim: float = 0.0,
                       backend=None, chunk: int = 64, **render_kw):
    """The depth-slab step's arithmetic in one process: the ``n_slabs``
    slabs composited one after another and merged with the over operator,
    one Adam step on the whole capacity. It isolates what the sharded step
    adds (the gathers, the sharded parameters and Adam state) from what the
    decomposition itself changes: each slab starts at T = 1, so its early
    stop is not the whole image's (ROADMAP.md §3)."""
    import torch

    from dge_tpu_torch.ops import losses as L
    from dge_tpu_torch.parallel import dryrun
    from dge_tpu_torch.parallel import gauss_shard as GS
    from dge_tpu_torch.parallel import tile_shard as TS
    from dge_tpu_torch.systems import fit as F

    use = F._train_backend(backend, scene.device)
    params = {k: v.detach().requires_grad_(True)
              for k, v in scene.params().items()}
    offset = torch.zeros(scene.capacity, 2, device=scene.device,
                         requires_grad=True)
    prep = TS.preprocess_scene(scene.with_params(params), cam)
    prep = prep._replace(mean2d=prep.mean2d + offset)
    colors, trans = [], []
    for k in range(n_slabs):
        vis = GS.slab_visible(prep, n_slabs, k)
        c, _, t, _ = GS._slab_composite(prep, vis, cam, height=cam.height,
                                        width=cam.width, backend=use,
                                        chunk=chunk, **render_kw)
        colors.append(c)
        trans.append(t)
    c, _, t = GS._merge_slabs(colors, trans, trans, n_slabs)
    c = c + t[..., None] * bg[None, None, :]
    loss = L.l1_loss(c, target)
    if lambda_dssim:
        loss = loss + lambda_dssim * (1.0 - L.ssim(c, target))
    radii = torch.where(prep.visible, prep.radius.detach(),
                        torch.zeros_like(prep.radius))
    out = dryrun.adam_and_stats(optimizer, scene, opt_state, fit_state,
                                params, offset, loss, prep.visible.float(),
                                radii, cam.width, cam.height)
    return out + (float(loss.detach()),)


def nccl_world1_train(dev) -> dict:
    """Phase 9 (a): ``--train --smoke --distributed`` with
    ``batch_mode=shard`` under ``torch.distributed.run`` with one rank
    (NCCL on cuda:0) on phase 7's setup, TF32 off; its log, metrics and
    edit frames checked; then one shard-mode DDIM step against the vmap
    step in a one-rank NCCL group in this process, bit for bit."""
    import glob
    import json

    import numpy as np
    import torch

    from dge_tpu_torch.diffusion import ip2p
    from dge_tpu_torch.parallel import dist as D
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.utils import saving

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0",
                   PYTHONPATH=os.pathsep.join(
                       [ROOT, os.environ.get("PYTHONPATH", "")]))
        t0 = time.time()
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node=1", "-m", "dge_tpu_torch.launch", "--train",
             "--smoke", "--distributed", "--gs_source", QUALITY_PLY,
             "--source", CAPTURE, "--out", tmp, "data.height=256",
             "data.width=256", f"data.max_view_num={EDIT_VIEWS}",
             f"system.guidance.camera_batch_size={EDIT_BATCH}",
             "system.guidance.batch_mode=shard",
             "system.prompt=turn him into a clown",
             f"system.edit.max_steps={NCCL_REFIT_STEPS}",
             f"system.edit.camera_update_per_step={NCCL_REFIT_STEPS + 1}"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.time() - t0
        text = run.stdout + run.stderr
        if run.returncode != 0:
            log(text[-6000:])
            raise AssertionError(f"--train --distributed exited with "
                                 f"{run.returncode}")
        if "backend nccl" not in text:
            raise AssertionError("the rank's log names no NCCL backend")
        with open(glob.glob(os.path.join(tmp, "dge", "*",
                                         "metrics.jsonl"))[0]) as f:
            rows = [json.loads(line) for line in f]
        frames = [saving.load_image(p) for p in sorted(glob.glob(
            os.path.join(tmp, "edit_cache", "*", "edit_0", "*.png")))]
        launches = json.loads(text.split("kernel launches: ")[1].split(
            "\n")[0].replace("'", '"'))
        peak = float(text.split("peak memory ")[1].split(" GiB")[0])
    losses = [r["train/loss"] for r in rows]
    if (len(rows) != NCCL_REFIT_STEPS or not np.isfinite(losses).all()
            or any(r["train/spill"] for r in rows)):
        raise AssertionError(f"--train --distributed: {len(rows)} steps, "
                             f"losses {losses[:3]}..., spill "
                             f"{[r['train/spill'] for r in rows]}")
    if len(frames) != EDIT_VIEWS or any(
            f.shape != (256, 256, 3) or not np.isfinite(f).all()
            for f in frames):
        raise AssertionError(f"--train --distributed: {len(frames)} edit "
                             "frames, or one not finite 256x256x3")
    short = [k for k in FORWARD_FORMS[False][:2] + BACKWARD_KERNELS
             if launches[k] < NCCL_REFIT_STEPS]
    if short:
        raise AssertionError(f"--train --distributed: too few launches of "
                             f"{short}: {launches}")
    # one DDIM step, shard against vmap, in a one-rank NCCL group here
    cs = DS.ColmapScene(CAPTURE, height=256, width=256)
    ecams = [CameraArrays.from_camera(c, device=dev)
             for c in DS.subsample_views(cs.cameras, EDIT_VIEWS)]
    models = ip2p.build_models(device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        D.dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1, timeout=D.TIMEOUT)
        try:
            step = shard_vs_vmap_step(models, ecams, EDIT_VIEWS, EDIT_BATCH,
                                      64, dev)
        finally:
            D.dist.destroy_process_group()
    del models
    torch.cuda.empty_cache()
    return dict(seconds=seconds, steps=len(rows), launches=launches,
                peak_memory_gib=peak, final_loss=losses[-1],
                ddim_step=step)


def write_random_ip2p(root: str, dev) -> dict:
    """Full-width SD-1.5 InstructPix2Pix networks with random weights (seed
    0) written as a diffusers directory of torch ``.bin`` files (unet/,
    vae/, text_encoder/); returns the bytes written a model."""
    import torch

    from dge_tpu_torch.diffusion import ip2p

    models = ip2p.build_models(seed=0, device=dev)
    sizes = {}
    for sub, net, fname in (
            ("unet", models.unet, "diffusion_pytorch_model.bin"),
            ("vae", models.vae, "diffusion_pytorch_model.bin"),
            ("text_encoder", models.text_encoder, "pytorch_model.bin")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, sub, fname)
        torch.save({k: v.cpu() for k, v in net.state_dict().items()}, path)
        sizes[sub] = os.path.getsize(path)
    del models
    return sizes


def one_ddim_step(models, cams, views: int, dev):
    """One DDIM step of ``views`` views in one camera batch at t = 500 (the
    pivot pass, the reuse, CFG and the update) from seeded draws."""
    import torch

    from dge_tpu_torch.diffusion import ddim
    from dge_tpu_torch.parallel.mesh import stack_cameras
    from dge_tpu_torch.systems import guidance as GD

    gen = torch.Generator(device=dev).manual_seed(3)
    lat = 64
    d = models.unet.config.cross_attention_dim
    x = torch.randn(views, lat, lat, 4, generator=gen, device=dev)
    cond = torch.randn(views, lat, lat, 4, generator=gen, device=dev)
    te = torch.randn(2 * views, 77, d, generator=gen, device=dev)

    def triple_for(idx):
        return (torch.cat([te[idx], te[views + idx], te[views + idx]]),
                torch.cat([cond[idx], cond[idx], torch.zeros_like(
                    cond[idx])]))

    guide = GD.DGEGuidance(GD.GuidanceConfig(camera_batch_size=views),
                           models)
    with torch.no_grad():
        eps = guide._predict_eps_multiview(
            x, 500, stack_cameras(cams[:views]), triple_for, views, views, 1,
            lat, lat, torch.Generator(device=dev).manual_seed(4))
        return ddim.step(models.schedule, eps, 500, x, 20)


def capture_paths(launch, dev, render_psnr) -> dict:
    """Phase 10: (a) ``--render`` of the quality-gate scene over the
    committed capture written as a Blender capture; (b) the bench capture
    generated at 512^2 and fitted; (c) a full-width checkpoint ingested and
    loaded both ways; (d) the native points parser. Counters are set to 0
    just before each run and read just after."""
    import numpy as np
    import torch

    from dge_tpu_torch.diffusion import ip2p
    from dge_tpu_torch.diffusion import weights as W
    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.scene import colmap as CM
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.tools import ingest_checkpoint, make_bench_capture

    out = {}
    k1 = FORWARD_FORMS[False][:2]
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the Blender capture: the committed capture's cameras in OpenGL
        # axes, its images by their paths
        cs = DS.ColmapScene(CAPTURE, height=256, width=256)
        blender = os.path.join(tmp, "blender")
        DS.write_transforms(cs.cameras, blender, [
            os.path.join(CAPTURE, "images", c.image_name)
            for c in cs.cameras])
        PC.reset_launch_counts()
        run = launch.main(["--render", "--gs_source", QUALITY_PLY, "--source",
                           blender, "--out", tmp, "data.height=256",
                           "data.width=256"])
        launches = dict(PC.launch_counts)
        psnr, _ = mean_psnr_against_capture(run.frames, run.image_names)
        want = RENDER_PSNR_DB if render_psnr is None else render_psnr
        out["blender"] = dict(psnr_db=psnr, want_db=want, spill=run.spill,
                              views=len(run.frames), launches=launches)
        log(f"  (a) Blender --render: {len(run.frames)} views, mean PSNR "
            f"{psnr:.6f} dB (phase 2: {want:.6f}), spill {run.spill}, "
            f"launches {launches}")
        if (len(run.frames) != 16 or run.spill
                or abs(psnr - want) > BLENDER_PSNR_TOL
                or min(launches[k] for k in k1) < len(run.frames)):
            raise AssertionError(f"Blender render: {out['blender']}")

        # (b) the bench capture at 512^2, then its fit (SH degree 0)
        cap = os.path.join(tmp, "bench_capture")
        PC.reset_launch_counts()
        t0 = time.time()
        made = make_bench_capture.main([
            "--out", cap, "--views", str(BENCH_VIEWS), "--size",
            str(BENCH_SIZE), "--style", "aniso"])
        gen_s = time.time() - t0
        launches = dict(PC.launch_counts)
        out["bench_capture"] = dict(
            n_gaussians=made.n_gaussians, spills=made.spills, caps=made.caps,
            render_s=made.seconds, seconds=gen_s, launches=launches)
        log(f"  (b) bench capture: {made.n_gaussians} gaussians, "
            f"{len(made.spills)} views at {BENCH_SIZE}^2, spills "
            f"{made.spills}, caps {made.caps}, renders {made.seconds:.2f} s "
            f"of {gen_s:.1f} s, launches {launches}")
        if (len(made.spills) != BENCH_VIEWS or any(made.spills)
                or min(launches[k] for k in k1) < BENCH_VIEWS):
            raise AssertionError(f"bench capture: {out['bench_capture']}")
        native0 = CM.points_parser_counts["native"]
        torch.cuda.reset_peak_memory_stats()
        PC.reset_launch_counts()
        fit = launch.main(["--fit", "--source", cap, "--config",
                           os.path.join(cap, "cfg.yaml"), "--out", tmp,
                           f"trainer.max_steps={BENCH_FIT_STEPS}"])
        launches = dict(PC.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out["bench_fit"] = dict(
            steps=fit.steps, seconds=fit.seconds,
            steps_per_s=fit.steps / fit.seconds, train_psnr=fit.last_psnr,
            n_alive=fit.n_alive, losses_finite=fit.losses_finite,
            peak_memory_gib=peak, caps=fit.caps, launches=launches,
            native_parser=CM.points_parser_counts["native"] - native0)
        log(f"  (b) bench fit: {fit.steps} steps in {fit.seconds:.1f} s "
            f"({fit.steps / fit.seconds:.2f} steps/s), peak {peak:.3f} GiB, "
            f"{fit.n_alive} alive, train PSNR (last 100) "
            f"{fit.last_psnr:.3f} dB, launches {launches}")
        idle = [k for k in k1 + BACKWARD_KERNELS
                if launches[k] < BENCH_FIT_STEPS]
        if idle or not fit.losses_finite or not out["bench_fit"][
                "native_parser"]:
            raise AssertionError(f"bench fit: {out['bench_fit']}, kernels "
                                 f"launched fewer times than steps: {idle}")
        del made, fit

        # (c) a full-width checkpoint as .bin files, its ingest cache, and
        # one DDIM step of 5 views from each: bit for bit
        src, cache = os.path.join(tmp, "ip2p"), os.path.join(tmp, "cache")
        t0 = time.time()
        sizes = write_random_ip2p(src, dev)
        write_s = time.time() - t0
        t0 = time.time()
        ingest_checkpoint.ingest(src, cache, vendor_tokenizer=False)
        ingest_s = time.time() - t0
        cams = [CameraArrays.from_camera(c, device=dev) for c in
                DS.ColmapScene(CAPTURE, height=512, width=512).cameras]
        steps, load_s = {}, {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for name, load in (("raw", W.load_ip2p_checkpoint),
                               ("ingested", W.load_ingested)):
                t0 = time.time()
                models = ip2p.build_models(params=load(
                    src if name == "raw" else cache), device=dev)
                torch.cuda.synchronize()
                load_s[name] = time.time() - t0
                steps[name] = one_ddim_step(models, cams, INGEST_VIEWS, dev)
                del models
        finally:
            torch.backends.cudnn.deterministic = deterministic
        same = torch.equal(steps["raw"], steps["ingested"])
        out["ingest"] = dict(
            bytes=sizes, write_s=write_s, ingest_s=ingest_s, load_s=load_s,
            equal=same, finite=bool(torch.isfinite(steps["raw"]).all()),
            is_ingested=W.is_ingested(cache))
        log(f"  (c) checkpoint {sum(sizes.values()) / 2 ** 30:.2f} GiB "
            f"written in {write_s:.1f} s, ingested in {ingest_s:.1f} s, "
            f"loaded raw / ingested in {load_s['raw']:.1f} / "
            f"{load_s['ingested']:.1f} s; DDIM step of {INGEST_VIEWS} views "
            f"bit for bit: {same}")
        if not (same and out["ingest"]["finite"]
                and out["ingest"]["is_ingested"]):
            raise AssertionError(f"ingest: {out['ingest']}")
        del steps

    # (d) the native points parser against the Python loop
    pts = os.path.join(CAPTURE, "sparse", "0", "points3D.bin")
    before = dict(CM.points_parser_counts)
    got = CM.read_points3d_binary(pts)
    loop = CM.read_points3d_binary_python(pts)
    used = CM.points_parser_counts["native"] - before["native"]
    equal = all(np.array_equal(a, b) for a, b in zip(got, loop))
    out["points_parser"] = dict(native=used, equal=equal,
                                points=int(got[0].shape[0]))
    log(f"  (d) points3D.bin: native parser used {used}x, equal to the "
        f"Python loop: {equal} ({got[0].shape[0]} points)")
    if used != 1 or not equal:
        raise AssertionError(f"points parser: {out['points_parser']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the measurements to this JSON file")
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--fit-steps", type=int, default=FIT_STEPS,
                    help="steps of phase 4's fit (default %(default)s; the "
                    "quality gate's own recipe is 6000)")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}
    fit_steps = args.fit_steps

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dge_tpu_torch import launch
    from dge_tpu_torch.ops import cuda_build
    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.ops import render as R
    from dge_tpu_torch.scene import dataset as DS
    from dge_tpu_torch.scene import gaussians as G
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.systems.edit import step_generator

    # parity: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    libs = cuda_build.build_all()
    log(f"built {[os.path.relpath(v, ROOT) for v in libs.values()]} in "
        f"{time.time() - t0:.1f} s")
    for lib in libs.values():
        with open(lib + ".ptxas.txt") as f:
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="  [%(name)s] %(message)s")

    errs = {k: [] for k in KERNEL_NAMES}
    rels = {k: [] for k in BACKWARD_KERNELS}

    def hold(inp, what, seed=0, forward=True):
        """The stream kernels (K1's and K5's row and combine kernels, each
        alone and, with ``forward``, the two together; the backward kernels
        K3, suffix, K4) against their plain versions on one stream."""
        cases = {}
        for log_space in (False, True):
            found = forward_vs_plain(inp, what, log_space)
            cases[log_space] = found.pop("cases")
            for k, e in found.items():
                errs[k].append(e)
        if forward:
            errs["pairs_composite"].append(kernel_vs_plain(inp, f"{what} K1"))
            errs["pairs_logdot"].append(logdot_vs_plain(inp, what))
        a, found = backward_vs_plain(inp, what, seed)
        for k, (e_abs, e_rel) in found.items():
            errs[k].append(e_abs)
            rels[k].append(e_rel)
        a["cases"] = cases[False]
        return a

    def hold_list(inp, what):
        """K2 and its layout kernel against their plain versions."""
        for k, e in list_kernel_vs_plain(inp, what).items():
            errs[k].append(e)

    bench = bg = None
    if phases & {3, 5, 6}:
        bench = G.load_ply(BENCH_PLY, device=dev)
        bg = torch.zeros(3, device=dev)

    # ---- phase 1: kernels vs plain -------------------------------------
    if 1 in phases:
        log("phase 1: kernels vs plain")
        fx = boundary_fixture(dev)
        hold(fx, "block-boundary fixture")
        nan_colour_vs_plain(dev)
        got = PC.composite_pairs_stream(fx["data"], fx["starts"],
                                        fx["counts"], tiles_x=1, tile_px=16,
                                        chunk=128)
        c, t = float(got[0, 0].mean()), float(got[0, 4].mean())
        log(f"  fixture colour {c:.6f} T {t:.6f} (block rule: 0.9975, "
            "0.0025; hard break: 0.995, 0.005)")
        if abs(c - 0.9975) > 1e-6 or abs(t - 0.0025) > 1e-7:
            raise AssertionError("block-boundary fixture: wrong block "
                                 "semantics")

        # every case of the combine fires on the saturation fixture, in both
        # forms; a NaN colour gives NaN where the plain version has it
        sat = saturation_fixture(dev)
        for log_space in (False, True):
            found = forward_vs_plain(sat, "saturation fixture", log_space)
            errs[FORWARD_FORMS[log_space][0]].append(
                found[FORWARD_FORMS[log_space][0]])
            errs[FORWARD_FORMS[log_space][1]].append(
                found[FORWARD_FORMS[log_space][1]])
            fired = found["cases"]
            log(f"  saturation fixture, log_space {log_space}: the combine "
                f"took all {fired['all']}, none {fired['none']}, walk "
                f"{fired['walk']} (and {fired['empty']} visits with no kept "
                "pair)")
            if min(fired["all"], fired["none"], fired["walk"]) <= 0:
                raise AssertionError(f"saturation fixture: a combine case "
                                     f"never fired: {fired}")
        nan_colour_forward(dev)
        refused_forward_launch(sat)

        rng = np.random.default_rng(0)
        rscene = random_scene(rng, 4000, dev)
        rcam = bench_camera(256, 256, dev)
        for tile_px in (32, 16, 8):
            for chunk in (128, 256):
                hold(stream_inputs(rscene, rcam, {}, False, tile_px, chunk),
                     f"random scene tile {tile_px} chunk {chunk}",
                     seed=chunk + tile_px, forward=tile_px == 32)
        # chunk 512: the most shared memory the row kernel asks for
        for tile_px in (16, 8):
            for log_space in (False, True):
                forward_vs_plain(
                    stream_inputs(rscene, rcam, {}, False, tile_px, 512),
                    f"random scene tile {tile_px} chunk 512", log_space)
        inp512 = stream_inputs(rscene, rcam, {}, False, 32, 512)
        hold(inp512, "random scene tile 32 chunk 512", seed=512,
             forward=False)
        # a launch the card refuses (a chunk whose slots exceed an SM's
        # shared memory) must raise, and leave the next launch unharmed
        from dge_tpu_torch.ops import pairs_backward as PB
        a = backward_args(inp512, seed=512)
        refused = dict(a["kw"], chunk=2 * PB.MAX_CHUNK)
        with backward_option(MAX_CHUNK=2 * PB.MAX_CHUNK):
            try:
                PB.pairs_pass2(a["data"], a["starts"], a["counts"],
                               a["blk_off"], a["row_tile"], a["cot"],
                               a["fwd"], a["boundary_t"], a["boundary_t"],
                               **refused)
            except RuntimeError as e:
                log(f"  refused launch raises: {e}")
            else:
                raise AssertionError("a refused launch did not raise")
        hold(inp512, "random scene tile 32 chunk 512 after the refusal",
             seed=512, forward=False)
        before = dict(PC.launch_counts)
        ko = R.render(rscene, rcam, tile_px=32, max_per_tile=4096)
        po = R.render(rscene, rcam, tile_px=32, max_per_tile=4096,
                      backend="torch")
        if any(PC.launch_counts[k] != before[k] + 1
               for k in FORWARD_FORMS[False][:2]):
            raise AssertionError("cuda_stream render did not launch K1's "
                                 "two kernels once each")
        for a, b, tol, what in ((ko.color, po.color, TOL["color"], "colour"),
                                (ko.depth, po.depth, TOL["depth"], "depth"),
                                (ko.alpha, po.alpha, TOL["trans"], "alpha")):
            e = float((a - b).abs().max())
            log(f"  random scene render {what}: max|err| {e:.3e}")
            if e > tol:
                raise AssertionError(f"random scene render {what} {e} > {tol}")
        for tile_px in (32, 16, 8):
            for chunk in (64, 256):
                composite_grads_vs_autograd(
                    rscene, rcam, f"stream_composite backward tile {tile_px} "
                    f"chunk {max(chunk, 128)}", chunk, tile_px)

        # K2: the fixture as one tile's list (chunks count from the tile's
        # own slot 0: slot 128 is applied again, slot 100 stays refused),
        # then the random scene's lists at tiles 32 / 16 / 8 and chunks
        # 128 / 256 / 512, direct ids and through `order`; a NaN colour and
        # a launch the card refuses
        from dge_tpu_torch.ops import binning as B
        from dge_tpu_torch.ops import tiles_composite as TT
        for slot, want_c, want_t in ((128, 0.9975, 0.0025),
                                     (100, 0.995, 0.005)):
            feat = fx["data"].clone()
            feat[5, 128] = 0.0
            feat[5, slot] = 0.5
            linp = dict(
                feat=feat.T.contiguous(), lists=torch.arange(
                    129, dtype=torch.int32, device=dev)[None, :].contiguous(),
                counts=fx["counts"], order=None, tiles_x=1, tile_px=16,
                chunk=128, feats=(feat[0:2].T, feat[2:5].T, feat[6:9].T,
                                  feat[9], feat[5]))
            hold_list(linp, f"list fixture slot {slot} K2")
            got = TT.composite_tiles_kernel(
                linp["feat"], linp["lists"], linp["counts"], tiles_x=1,
                tile_px=16, chunk=128)
            c, t = float(got[0, 0].mean()), float(got[0, 4].mean())
            log(f"  list fixture slot {slot}: colour {c:.6f} T {t:.6f} "
                f"(tile-relative rule: {want_c}, {want_t})")
            if abs(c - want_c) > 1e-6 or abs(t - want_t) > 1e-7:
                raise AssertionError("list fixture: wrong chunk semantics")
        prep = stream_stages(rscene, rcam, {}, False, 32)[0]()
        for tile_px in (32, 16, 8):
            scan = B.bin_gaussians_scan(
                prep.mean2d, prep.depth, prep.radius, prep.visible,
                height=256, width=256, tile_px=tile_px, max_per_tile=4096)
            for chunk in (128, 256, 512):
                # a Gaussian covers 4x the tiles at half the tile width
                linp = list_inputs(rscene, rcam, dict(
                    max_per_tile=4096,
                    max_tiles_per_gaussian=64 * (32 // tile_px) ** 2), False,
                    tile_px, chunk)
                what = f"random scene lists tile {tile_px} chunk {chunk} K2"
                hold_list(linp, what)
                if not torch.equal(scan.counts, linp["counts"]):
                    raise AssertionError("bin_gaussians_scan counts differ")
                oinp = dict(linp, lists=scan.lists.contiguous(),
                            order=scan.order.contiguous())
                hold_list(oinp, what + " through order")
        for k, e in nan_colour_lists(dev).items():
            errs[k].append(e)
        refused_list_launch(list_inputs(rscene, rcam, dict(
            max_per_tile=4096, max_tiles_per_gaussian=64), False, 32, 128))
        before = dict(PC.launch_counts)
        lo = R.render(rscene, rcam, tile_px=32, max_per_tile=4096,
                      max_tiles_per_gaussian=64, backend="cuda_tiles")
        po = R.render(rscene, rcam, tile_px=32, max_per_tile=4096,
                      max_tiles_per_gaussian=64, backend="torch_tiles",
                      chunk=128)
        if any(PC.launch_counts[k] != before[k] + 1 for k in K2_COUNTERS):
            raise AssertionError("cuda_tiles render did not launch K2 (K1's "
                                 "two kernels over its list stream) once")
        for a, b, tol, what in ((lo.color, po.color, TOL["color"], "colour"),
                                (lo.depth, po.depth, TOL["depth"], "depth"),
                                (lo.alpha, po.alpha, TOL["trans"], "alpha")):
            e = float((a - b).abs().max())
            log(f"  random scene cuda_tiles render {what}: max|err| {e:.3e}")
            if e > tol or int(lo.spill) != 0:
                raise AssertionError(f"cuda_tiles render {what} {e} > {tol}")

    # ---- phase 2: the render path --------------------------------------
    render_launches = mean_psnr = psnrs = None
    main_k1 = {}
    if 2 in phases:
        log("phase 2: render path (dge_tpu_torch.launch --render, "
            "quality-gate scene over fit_capture at 256^2)")
        with tempfile.TemporaryDirectory() as tmp:
            PC.reset_launch_counts()
            run = launch.main(["--render", "--gs_source", QUALITY_PLY,
                               "--source", CAPTURE, "--out", tmp,
                               "data.height=256", "data.width=256"])
            render_launches = dict(PC.launch_counts)
            n_png = len(os.listdir(os.path.join(run.trial_dir, "renders")))
        log(f"  launches during the render path: {render_launches}")
        if render_launches["pairs_composite"] < len(run.frames) + 1:
            raise AssertionError("render path did not go through the kernel")
        if run.spill != 0:
            raise AssertionError(f"render path spill {run.spill} after the "
                                 "ladder")
        if n_png != len(run.frames) or len(run.frames) != 16:
            raise AssertionError(f"expected 16 renders, got {n_png}")
        mean_psnr, psnrs = mean_psnr_against_capture(run.frames,
                                                     run.image_names)
        log(f"  mean PSNR {mean_psnr:.4f} dB over {len(psnrs)} views "
            f"(min {min(psnrs):.4f}), caps {run.caps}, tight_cull "
            f"{run.tight_cull}")
        if mean_psnr < PSNR_MIN:
            raise AssertionError(f"mean PSNR {mean_psnr} < {PSNR_MIN}")
        # the kernel at the render path's shapes: view 0 of the capture
        qscene = G.load_ply(QUALITY_PLY, device=dev)
        cs = DS.ColmapScene(CAPTURE, height=256, width=256)
        qcam = CameraArrays.from_camera(cs.cameras[0], device=dev)
        inp = stream_inputs(qscene, qcam, run.caps, run.tight_cull, 32, 64)
        errs["pairs_composite"].append(
            kernel_vs_plain(inp, "render path view 0"))
        main_k1 = forward_times(inp, plain_reps=5)
        log(f"  render path view 0 ({inp['pairs']} pairs, "
            f"{main_k1['rows']} rows): K1 {main_k1['whole_ms']:.4f} ms; "
            + "; ".join(f"{k} {v}" for k, v in main_k1.items()
                        if isinstance(v, dict)))

    # ---- phase 3: full width, forward ----------------------------------
    cells = []
    if 3 in phases:
        log("phase 3: full width (bench scene; each cell also holds the "
            "kernel against the plain version)")
        cells.append(full_width_cell("512x512", bench,
                                     bench_camera(512, 512, dev), bg))
        cells.append(full_width_cell(
            "1920x1080", bench, bench_camera(1080, 1920, dev), bg, chunk=256,
            **STREAM_START_1080P))
        errs["pairs_composite"] += [c["max_abs_err"] for c in cells]

    # ---- phase 4: the training path ------------------------------------
    fit = {}
    if 4 in phases:
        log(f"phase 4: training path (dge_tpu_torch.launch --fit on "
            f"fit_capture at 256^2, SH 3, {fit_steps} steps, seed 0)")
        with tempfile.TemporaryDirectory() as tmp:
            PC.reset_launch_counts()
            frun = launch.main(["--fit", "--source", CAPTURE, "--out", tmp,
                                "--seed", "0", "data.height=256",
                                "data.width=256", "system.sh_degree=3",
                                f"trainer.max_steps={fit_steps}"])
            fit_launches = dict(PC.launch_counts)
            log(f"  launches during the fit: {fit_launches}; "
                f"{frun.steps / frun.seconds:.2f} steps/s "
                f"({frun.seconds:.1f} s), alive {frun.n_alive}, last-100 "
                f"train PSNR {frun.last_psnr:.3f} dB, caps {frun.caps}")
            if not frun.losses_finite:
                raise AssertionError("fit: a loss was not finite")
            for k in FORWARD_FORMS[False][:2] + BACKWARD_KERNELS:
                v = fit_launches[k]
                if v < fit_steps:
                    raise AssertionError(f"fit: {k} launched {v} times in "
                                         f"{fit_steps} steps")
            if frun.n_alive <= 8000:
                raise AssertionError(f"fit: alive {frun.n_alive} did not grow")
            if frun.last_psnr < FIT_PSNR_MIN:
                raise AssertionError(f"fit: train PSNR {frun.last_psnr} < "
                                     f"{FIT_PSNR_MIN}")
            erun = launch.main(["--render", "--gs_source", frun.ply_path,
                                "--source", CAPTURE, "--out", tmp,
                                "data.height=256", "data.width=256"])
            if erun.spill != 0:
                raise AssertionError("fit evaluation: spill after the ladder")
            eval_psnr, eval_views = mean_psnr_against_capture(
                erun.frames, erun.image_names)
            log(f"  spill-free evaluation PSNR {eval_psnr:.4f} dB over "
                f"{len(eval_views)} views (min {min(eval_views):.4f})")
            if eval_psnr < FIT_PSNR_MIN:
                raise AssertionError(f"fit: evaluation PSNR {eval_psnr} < "
                                     f"{FIT_PSNR_MIN}")
            # the kernels at the fit's shapes: view 0, the loop's final caps
            fscene = G.load_ply(frun.ply_path, device=dev)
        cs = DS.ColmapScene(CAPTURE, height=256, width=256)
        fcam = CameraArrays.from_camera(cs.cameras[0], device=dev)
        fcaps = {k: v for k, v in frun.caps.items()
                 if k not in ("tile_px", "chunk", "tight_cull")}
        inp = stream_inputs(fscene, fcam, fcaps, frun.caps["tight_cull"],
                            frun.caps["tile_px"], frun.caps["chunk"])
        a = hold(inp, "fit view 0")
        fold_fit = fold_cell(a, fscene.capacity, "fit view 0")
        errs["pairs_fold"].append(fold_fit["max_abs_err"])
        fb = backward_bounds(inp["pairs"], inp["starts"].shape[0], a["rows"],
                             32)
        fit = dict(
            steps=frun.steps, seconds=frun.seconds,
            steps_per_s=frun.steps / frun.seconds, n_alive=frun.n_alive,
            train_psnr_db=frun.last_psnr, eval_psnr_db=eval_psnr,
            eval_views_db=eval_views, caps=frun.caps, launches=fit_launches,
            view0=dict(pairs=inp["pairs"], rows=a["rows"],
                       cases=a["cases"], k1=forward_times(inp, boundary=True),
                       **backward_times(a, plain_reps=3),
                       pass1_bound_ms=fb[0][0], pass1_bound_by=fb[0][1],
                       pass2_bound_ms=fb[1][0], pass2_bound_by=fb[1][1],
                       suffix_bound_ms=fb[2][0], suffix_bound_by=fb[2][1]),
            fold=fold_fit, reproduced=same_seed_fits(launch))
        log(f"  fit view 0: {fit['view0']}")

    # ---- phase 5: full width, training ---------------------------------
    train = {}
    if 5 in phases:
        log("phase 5: full width, training (bench scene at 512^2, seeded "
            "random target, lambda_dssim=0)")
        cam512 = bench_camera(512, 512, dev)
        r = R.SpillFreeRenderer(bench, bg, tile_px=32,
                                log=lambda m: log(f"  [512x512] {m}"))
        if r.probe(cam512) != 0:
            raise AssertionError("512x512: spill after the ladder")
        inp = stream_inputs(bench, cam512, r.caps, r.tight_cull, 32, 64)
        a = hold(inp, "512x512")
        fold512 = fold_cell(a, bench.capacity, "512x512")
        errs["pairs_fold"].append(fold512["max_abs_err"])
        times = backward_times(a)
        tb = backward_bounds(inp["pairs"], inp["starts"].shape[0], a["rows"],
                             32)
        train = train_cell(bench, cam512, r.caps, r.tight_cull, a, times)
        train.update(fold=fold512, pairs=inp["pairs"], rows=a["rows"],
                     caps=r.caps,
                     tight_cull=r.tight_cull, pass1_bound_ms=tb[0][0],
                     pass1_bound_by=tb[0][1], pass2_bound_ms=tb[1][0],
                     pass2_bound_by=tb[1][1], suffix_bound_ms=tb[2][0],
                     suffix_bound_by=tb[2][1])
        log("  512x512 training cell: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in train.items() if k != "device_kernels"))
        for name, ms, count in train["device_kernels"] or []:
            log(f"    device: {ms:.4f} ms/step in {count} launches of {name}")

    # ---- phase 6: the evaluation path (per-tile lists, K2; the K5 tool) --
    ev = {}
    if 6 in phases:
        log("phase 6: evaluation path (dge_tpu_torch.launch --validate of "
            "the quality-gate scene over fit_capture at 256^2, on "
            "cuda_stream and on cuda_tiles; --export; mask lift; K2 full "
            "width; the K1-vs-K5 tool)")
        from dge_tpu_torch.tools import proto_logdot as LD
        runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            for backend in ("cuda_stream", "cuda_tiles"):
                PC.reset_launch_counts()
                t0 = time.time()
                vrun = launch.main(
                    ["--validate", "--gs_source", QUALITY_PLY, "--source",
                     CAPTURE, "--out", tmp, "--backend", backend,
                     "data.height=256", "data.width=256"])
                res = dict(vrun.results["fit_capture"],
                           launches=dict(PC.launch_counts),
                           seconds=time.time() - t0)
                runs[backend] = res
                log(f"  --validate on {backend}: {res}")
                n_png = len(os.listdir(os.path.join(
                    vrun.eval_dir, "fit_capture", "renders")))
                if res["spill"] != 0 or res["n_views"] != 16 or n_png != 16:
                    raise AssertionError(f"validate {backend}: spill or "
                                         "missing views")
                if not res["psnr"] >= PSNR_MIN:
                    raise AssertionError(f"validate {backend}: PSNR "
                                         f"{res['psnr']} < {PSNR_MIN}")
                if not (math.isfinite(res["ssim"])
                        and math.isfinite(res["lpips"] or math.nan)):
                    raise AssertionError(f"validate {backend}: bad SSIM/LPIPS")
            k1_keys = FORWARD_FORMS[False][:2]
            if (min(runs["cuda_stream"]["launches"][k] for k in k1_keys) < 16
                    or runs["cuda_stream"]["launches"]["tiles_composite"]):
                raise AssertionError("default validate did not go through K1")
            # K2 runs its layout kernel and K1's two kernels, once each a call
            tiles = runs["cuda_tiles"]["launches"]
            if (tiles["tiles_composite"] < 16
                    or any(tiles[k] != tiles["tiles_composite"]
                           for k in k1_keys + ("list_stream",))):
                raise AssertionError("cuda_tiles validate did not go through "
                                     "K2 (K1's kernels once per K2 call)")
            gap = abs(runs["cuda_stream"]["psnr"] - runs["cuda_tiles"]["psnr"])
            log(f"  PSNR gap between the two backends: {gap:.5f} dB")
            if gap > BACKENDS_PSNR_TOL:
                raise AssertionError(f"validate: backends differ by {gap} dB")
            erun = launch.main(["--export", "--gs_source", QUALITY_PLY,
                                "--out", tmp, "data.height=256",
                                "data.width=256", "export.frames=8"])
            n_png = len(os.listdir(os.path.join(erun.trial_dir,
                                                "orbit_frames")))
            if (len(erun.frames) != 8 or n_png != 8
                    or not os.path.exists(erun.scene_ply)):
                raise AssertionError("export: frames or scene.ply missing")
            for i, f in enumerate(erun.frames):
                if (f.shape != (256, 256, 3) or not np.isfinite(f).all()
                        or f.max() < 0.05):
                    raise AssertionError(f"export frame {i}: non-finite or "
                                         "black")
            brightest = max(float(f.max()) for f in erun.frames)
            log(f"  --export: 8 orbit frames, brightest {brightest:.3f}")

        # the mask lift over the 16 views, at caps nothing can overflow
        qscene = G.load_ply(QUALITY_PLY, device=dev)
        cs = DS.ColmapScene(CAPTURE, height=256, width=256)
        qcams = [CameraArrays.from_camera(c, device=dev) for c in cs.cameras]
        lift_kw = dict(tile_px=32, max_per_tile=qscene.capacity,
                       max_tiles_per_gaussian=64)
        half = torch.zeros(256, 256, device=dev)
        half[:, 128:] = 1.0
        w_full, h_full = R.render_weights(qscene, qcams[0],
                                          torch.ones(256, 256, device=dev),
                                          **lift_kw)[:2]
        if not torch.equal(w_full, h_full) or float(h_full.sum()) <= 0:
            raise AssertionError("mask lift: full mask weights != hits")
        torch.cuda.synchronize()
        t0 = time.time()
        w_sum = torch.zeros(qscene.capacity, device=dev)
        h_sum = torch.zeros(qscene.capacity, device=dev)
        for cam in qcams:
            w, h = R.render_weights(qscene, cam, half, **lift_kw)[:2]
            w_sum += w
            h_sum += h
        torch.cuda.synchronize()
        lift_ms = (time.time() - t0) * 1e3 / len(qcams)
        n_hit = int((h_sum > 0).sum())
        frac = float(w_sum.sum() / h_sum.sum())
        log(f"  mask lift: {lift_ms:.2f} ms/view, {n_hit} of "
            f"{qscene.n_alive} Gaussians hit, masked share of hits "
            f"{frac:.4f}")
        if (n_hit == 0 or not 0.0 < frac < 1.0
                or bool((w_sum > h_sum).any())
                or not bool(torch.isfinite(w_sum).all())):
            raise AssertionError("mask lift: bad weights")

        # K2 at the evaluation path's shapes: view 0 of the capture
        r = R.SpillFreeRenderer(qscene, torch.zeros(3, device=dev),
                                tile_px=32, backend="cuda_tiles")
        if r.probe(qcams[0]) != 0:
            raise AssertionError("validate view 0: spill after the ladder")
        inp = list_inputs(qscene, qcams[0], r.caps, r.tight_cull, 32, 64)
        hold_list(inp, "validate view 0 K2")
        main_k2 = list_times(inp, plain_reps=5)
        log(f"  validate view 0: {k2_summary(main_k2)}, entries "
            f"{inp['pairs']}, caps {r.caps}")

        # LPIPS per view at 256^2 (TF32 off, as in the tool), on the card
        # and against the same network on the CPU
        from dge_tpu_torch.models import lpips as LP
        from dge_tpu_torch.utils import saving
        img = r.render(qcams[0]).color
        gt = torch.from_numpy(saving.load_image(saving.find_image(
            cs.images_dir, cs.cameras[0].image_name))).to(dev)
        lp_fn, lp_params = LP.make_perceptual_fn(device=dev)
        lp_card = float(lp_fn(img, gt))
        lp_cpu = float(LP.make_perceptual_fn(params={
            k: v.cpu() for k, v in lp_params.items()}, device="cpu")[0](
                img.cpu(), gt.cpu()))
        lpips_ms = cuda_ms(lambda: lp_fn(img, gt), reps=10)
        log(f"  LPIPS at 256^2: {lpips_ms:.3f} ms a view, {lp_card:.6f} on "
            f"the card, {lp_cpu:.6f} on the CPU")
        if not abs(lp_card - lp_cpu) <= 1e-4 * abs(lp_cpu):
            raise AssertionError(f"LPIPS card {lp_card} vs CPU {lp_cpu}")

        # K2 at full width: the bench scene at 512^2 and 1920x1080
        list_cells = [
            list_cell("512x512", bench, bench_camera(512, 512, dev), bg, {},
                      tight_cull=True, max_tiles_per_gaussian=256),
            list_cell("1920x1080", bench, bench_camera(1080, 1920, dev), bg,
                      STREAM_START_1080P, chunk=256, tight_cull=True,
                      max_per_tile=2048, max_tiles_per_gaussian=256)]
        errs["tiles_composite"] += [c["max_abs_err"] for c in list_cells]
        errs["list_stream"] += [c["layout_max_abs_err"] for c in list_cells]

        # the K1-vs-K5 tool on the bench scene at 512^2, then K5 against its
        # plain version on the tool's stream
        PC.reset_launch_counts()
        tool = LD.main([])
        tool_launches = dict(PC.launch_counts)
        if (min(tool_launches[k] for k in FORWARD_FORMS[True][:2]) < 1
                or tool["k5_ms"] is None):
            raise AssertionError("proto_logdot did not launch K5")
        r5 = R.SpillFreeRenderer(bench, bg, tile_px=32, chunk=128)
        if r5.probe(bench_camera(512, 512, dev)) != 0:
            raise AssertionError("512x512: spill after the ladder")
        inp5 = stream_inputs(bench, bench_camera(512, 512, dev), r5.caps,
                             r5.tight_cull, 32, 128)
        if inp5["pairs"] != tool["pairs"]:
            raise AssertionError("the tool's stream is not the 512x512 cell's")
        errs["pairs_logdot"].append(logdot_vs_plain(inp5, "512x512"))
        for log_space in (False, True):
            found = forward_vs_plain(inp5, "512x512", log_space)
            for k in FORWARD_FORMS[log_space][:2]:
                errs[k].append(found[k])
        main_k5 = dict(
            **forward_times(inp5, log_space=True, plain_reps=1),
            k1=forward_times(inp5, plain_reps=1),
            tool_k5_ms=tool["k5_ms"], tool_k1_ms=tool["k1_ms"],
            pairs=tool["pairs"],
            max_dcolor_vs_k1=tool["max_dcolor"],
            max_ddepth_vs_k1=tool["max_ddepth"],
            max_dtrans_vs_k1=tool["max_dtrans"])
        log(f"  proto_logdot at 512x512: {main_k5}, launches {tool_launches}")
        ev = dict(validate=runs, lift_ms_per_view=lift_ms,
                  lpips_ms_per_view=lpips_ms, lpips_view0=lp_card,
                  lift_gaussians_hit=n_hit, view0=main_k2,
                  list_cells=list_cells, logdot=main_k5,
                  logdot_launches=tool_launches)

    # ---- phase 7: the edit path (--train, full-width random networks) ---
    edit = {}
    if 7 in phases:
        log("phase 7: edit path (dge_tpu_torch.launch --train --smoke, "
            f"quality-gate scene over {EDIT_VIEWS} views of fit_capture at "
            f"256^2, full-width SD-1.5 networks on random weights, camera "
            f"batches of {EDIT_BATCH}, 20 DDIM steps, {EDIT_STEPS} refit "
            "steps)")
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.reset_peak_memory_stats()
            PC.reset_launch_counts()
            trun = launch.main([
                "--train", "--smoke", "--gs_source", QUALITY_PLY, "--source",
                CAPTURE, "--out", tmp, "data.height=256", "data.width=256",
                f"data.max_view_num={EDIT_VIEWS}",
                f"system.guidance.camera_batch_size={EDIT_BATCH}",
                "system.prompt=turn him into a clown",
                f"system.edit.max_steps={EDIT_STEPS}",
                "system.edit.densify_from=100",
                f"system.edit.camera_update_per_step={EDIT_STEPS + 1}"])
            edit_launches = dict(PC.launch_counts)
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            escene = G.load_ply(trun.ply_path, device=dev)
            # the run's DGESystem holds the SD-1.5 weights: release them
            trun = trun._replace(system=None)
        log(f"  launches during the edit path: {edit_launches}")
        frames = [trun.edit_frames[v] for v in sorted(trun.edit_frames)]
        bad = [i for i, f in enumerate(frames)
               if f.shape != (256, 256, 3) or not np.isfinite(f).all()
               or f.min() < 0.0 or f.max() > 1.0]
        if len(frames) != EDIT_VIEWS or bad:
            raise AssertionError(f"edit path: {len(frames)} edited frames, "
                                 f"bad {bad}")
        if not trun.losses_finite:
            raise AssertionError("edit path: a refit loss was not finite")
        if trun.spill or trun.render_spill:
            raise AssertionError(f"edit path: spill {trun.spill} in the "
                                 f"refit, {trun.render_spill} in the renders")
        if escene.n_alive == 0:
            raise AssertionError("edit path: last.ply holds no Gaussian")
        need = {k: 2 * EDIT_VIEWS + EDIT_STEPS
                for k in FORWARD_FORMS[False][:2]}
        need.update({k: EDIT_STEPS for k in BACKWARD_KERNELS})
        short = {k: (edit_launches[k], v) for k, v in need.items()
                 if edit_launches[k] < v}
        if short:
            raise AssertionError(f"edit path: kernels launched too few times "
                                 f"(got, need): {short}")
        cs = DS.ColmapScene(CAPTURE, height=256, width=256)
        ecams = [CameraArrays.from_camera(c, device=dev)
                 for c in DS.subsample_views(cs.cameras, EDIT_VIEWS)]
        # the refit's kernels at the edit path's shapes: the edited scene,
        # view 0, the loop's final caps
        ecaps = {k: v for k, v in trun.caps.items()
                 if k not in ("tile_px", "chunk", "tight_cull")}
        inp = stream_inputs(escene, ecams[0], ecaps, trun.caps["tight_cull"],
                            trun.caps["tile_px"], trun.caps["chunk"])
        a = hold(inp, "edit refit view 0")
        fold_edit = fold_cell(a, escene.capacity, "edit refit view 0")
        errs["pairs_fold"].append(fold_edit["max_abs_err"])
        smi_line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        edit = dict(
            launches=edit_launches, steps=trun.steps,
            seconds=trun.seconds,
            edit_round_s=trun.seconds["edit"],
            refit_steps_per_s=trun.steps / trun.seconds["fit"],
            peak_memory_gib=peak_gb, n_alive=escene.n_alive, caps=trun.caps,
            refit_view0=dict(pairs=inp["pairs"], rows=a["rows"]),
            fold=fold_edit, attention=attention_vs_chunked(dev),
            blockwise_argmax=blockwise_vs_dense(ecams, dev),
            stages=edit_stage_times(ecams, dev), card=smi_line)
        log(f"  edit round {edit['edit_round_s']:.2f} s, refit "
            f"{edit['refit_steps_per_s']:.2f} steps/s, peak memory "
            f"{peak_gb:.2f} GiB, host seconds {trun.seconds}, alive "
            f"{escene.n_alive}, caps {trun.caps} ({smi_line})")

    # ---- phase 8: the rest of the edit system ----
    if 8 in phases:
        log(f"phase 8: the repo's recipe (--config configs/dge.yaml, batched "
            f"reuse) as a local edit of the quality-gate scene over "
            f"{EDIT_VIEWS} views at 256^2 (precomputed masks, "
            f"{LOCAL_STEPS} refit steps, CLIP metrics on random full-width "
            f"towers), then {SDS_STEPS} SDS steps over batches of "
            f"{EDIT_BATCH}, full-width SD-1.5 networks on random weights")
        scene0 = G.load_ply(QUALITY_PLY, device=dev)
        cs = DS.ColmapScene(CAPTURE, height=256, width=256)
        ecams = [CameraArrays.from_camera(c, device=dev)
                 for c in DS.subsample_views(cs.cameras, EDIT_VIEWS)]
        common = ["--gs_source", QUALITY_PLY, "--source", CAPTURE,
                  "data.height=256", "data.width=256",
                  f"data.max_view_num={EDIT_VIEWS}",
                  f"system.guidance.camera_batch_size={EDIT_BATCH}",
                  "system.prompt=turn him into a clown"]
        with tempfile.TemporaryDirectory() as tmp:
            # (a) the recipe, local, with CLIP metrics
            t0 = time.time()
            clip_dir = os.path.join(tmp, "clip")
            sim = save_random_clip(clip_dir, dev)
            clip_save_s = time.time() - t0
            torch.cuda.reset_peak_memory_stats()
            PC.reset_launch_counts()
            arun = launch.main([
                "--train", "--smoke", "--config",
                os.path.join(ROOT, "configs", "dge.yaml"), "--out",
                os.path.join(tmp, "a"), *common, "system.seg_prompt=object",
                "system.segmentor=precomputed", f"system.mask_dir={MASK_DIR}",
                f"system.clip_checkpoint={clip_dir}",
                f"system.edit.max_steps={LOCAL_STEPS}",
                f"system.edit.camera_update_per_step={LOCAL_STEPS + 1}",
                "system.edit.densify_from=1000000"])
            local_launches = dict(PC.launch_counts)
            local_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  launches during the local edit: {local_launches}")
        local = local_edit_checks(arun, scene0, EDIT_VIEWS, LOCAL_STEPS, 256)
        need = {k: 2 * EDIT_VIEWS + LOCAL_STEPS
                for k in FORWARD_FORMS[False][:2]}
        need.update({k: LOCAL_STEPS for k in BACKWARD_KERNELS})
        short = {k: (local_launches[k], v) for k, v in need.items()
                 if local_launches[k] < v}
        if short:
            raise AssertionError(f"local edit: kernels launched too few "
                                 f"times (got, need): {short}")
        cm = arun.clip_metrics
        if cm is None or cm["n_views"] != EDIT_VIEWS or not all(
                math.isfinite(cm[k]) for k in cm):
            raise AssertionError(f"local edit: CLIP metrics {cm}")
        local.update(launches=local_launches, seconds=arun.seconds,
                     edit_round_s=arun.seconds["edit"],
                     refit_steps_per_s=LOCAL_STEPS / arun.seconds["fit"],
                     peak_memory_gib=local_peak, clip_metrics=cm,
                     clip_save_s=clip_save_s,
                     loop_vs_vmap=loop_vs_vmap_step(
                         arun.system.guidance.models, ecams, EDIT_VIEWS,
                         EDIT_BATCH, 64, dev))
        vids = sorted(arun.edit_frames)
        src = np.stack([arun.system.origin_frames[v] for v in vids])
        clip = clip_checks(sim, src,
                           np.stack([arun.edit_frames[v] for v in vids]))
        clip["ms_per_image"] = cuda_ms(lambda: sim.image_features(src),
                                       reps=5, warmup=1) / len(src)
        log(f"  local edit: {local}")
        log(f"  CLIP on random ViT-L/14: {clip}")
        del arun, sim

        # (b) SDS
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.reset_peak_memory_stats()
            PC.reset_launch_counts()
            srun = launch.main([
                "--train", "--smoke", "--out", tmp, *common,
                "system.edit.use_sds=true",
                f"system.edit.camera_batch_size={EDIT_BATCH}",
                f"system.edit.max_steps={SDS_STEPS}"])
            sds_launches = dict(PC.launch_counts)
            sds_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  launches during the SDS run: {sds_launches}")
        sds = sds_checks(srun, scene0, EDIT_BATCH, SDS_STEPS)
        need = {k: 2 * EDIT_BATCH * SDS_STEPS
                for k in FORWARD_FORMS[False][:2]}
        need.update({k: EDIT_BATCH * SDS_STEPS for k in BACKWARD_KERNELS})
        short = {k: (sds_launches[k], v) for k, v in need.items()
                 if sds_launches[k] < v}
        if short:
            raise AssertionError(f"SDS: kernels launched too few times "
                                 f"(got, need): {short}")
        ssys = srun.system
        # the kernels at the SDS path's shapes: the scene after the run, the
        # first view
        inp = stream_inputs(ssys.scene, ssys.cameras[0],
                            {k: v for k, v in ssys.loop.caps.items()
                             if k not in ("tile_px", "chunk", "tight_cull")},
                            ssys.loop.tight_cull, ssys.loop.tile_px,
                            ssys.loop.chunk)
        hold(inp, "SDS view 0")
        step_gen = iter(range(10 ** 6, 10 ** 6 + 100))
        sds.update(
            launches=sds_launches, seconds=srun.seconds,
            host_ms_per_step=1e3 * srun.seconds["sds"] / SDS_STEPS,
            peak_memory_gib=sds_peak,
            grads_vs_plain=sds_grads_vs_plain(ssys, EDIT_BATCH, dev),
            step_ms=cuda_ms(lambda: ssys.sds_step(
                step_generator(0, next(step_gen), dev)), reps=3, warmup=1),
            vae_encode_fwd_bwd=vae_encode_fwd_bwd(
                ssys.guidance.models, EDIT_BATCH, 512, dev))
        log(f"  SDS: {sds}")
        del srun, ssys
        edit_system = dict(local=local, sds=sds, clip=clip)

    # ---- phase 9: multi-GPU on the one card ----
    multi = {}
    if 9 in phases:
        log("phase 9: multi-GPU on one card: (a) --train --distributed "
            "with batch_mode=shard under torch.distributed.run, one rank, "
            "NCCL; (b) gloo ranks sharing cuda:0 (they measure correctness "
            "and launches, not scaling): world 2 (view-sharded step, shard "
            "DDIM step at full SD-1.5 width), world 4 (the bench scene in 4 "
            "tile bands, gauss x tile 2 x 2 and 4 depth slabs at 512^2; the "
            "depth-slab and view x tile steps on the quality-gate scene)")
        from dge_tpu_torch.parallel import dist as D
        from dge_tpu_torch.parallel import tile_shard as TS
        from dge_tpu_torch.parallel.dryrun import reference_step
        from dge_tpu_torch.parallel.mesh import index_cameras
        from dge_tpu_torch.systems import fit as F

        t9 = time.time()
        multi["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        log(f"  {multi['card']}")
        multi["nccl_world1"] = nccl_world1_train(dev)
        log(f"  (a) NCCL world 1: {multi['nccl_world1']}")
        bg0 = torch.zeros(3, device=dev)
        bench9 = G.load_ply(BENCH_PLY, device=dev)
        cam512 = bench_camera(512, 512, dev)
        r = R.SpillFreeRenderer(bench9, bg0, backend="cuda_tiles")
        if r.probe(cam512):
            raise AssertionError("bench scene: list spill at the ceilings")
        bench_caps = dict(r.caps, tile_px=32, tight_cull=r.tight_cull)
        qg, qcams, qtargets = _qg_inputs(dev, MULTI_VIEWS)
        r = R.SpillFreeRenderer(qg, bg0)
        for v in range(len(MULTI_VIEWS)):
            if r.probe(index_cameras(qcams, v)):
                raise AssertionError("quality-gate scene: spill at ceilings")
        qg_caps = dict(r.caps, tile_px=32, tight_cull=r.tight_cull)
        w2 = D.spawn_local(multi_world2, 2, device="cuda", backend="gloo",
                           args=(qg_caps, MULTI_VIEWS))
        w4 = D.spawn_local(multi_world4, 4, device="cuda", backend="gloo",
                           args=(bench_caps, qg_caps, MULTI_VIEWS))
        reports = {"world2": [w["report"] for w in w2],
                   "world4": [w["report"] for w in w4]}
        o2, o4 = w2[0]["out"], w4[0]["out"]
        # every rank's kernels advanced in every scenario
        for world, reps in reports.items():
            for rank_, rep in enumerate(reps):
                for scn, rr in rep.items():
                    need = (K2_COUNTERS[:2] if scn.endswith("render") else
                            FORWARD_FORMS[False][:2] + BACKWARD_KERNELS
                            if scn.endswith("step") and "ddim" not in scn
                            else ())
                    idle = [k for k in need if rr["launches"][k] < 1]
                    if idle:
                        raise AssertionError(f"{world} rank {rank_} {scn}: "
                                             f"no launch of {idle}")
                    log(f"  {world} rank {rank_} {scn}: {rr['ms']:.2f} ms, "
                        f"collectives {rr['collective_ms']:.2f} ms in "
                        f"{rr['collectives']} calls, peak "
                        f"{rr['peak_memory_gib']:.3f} GiB, launches "
                        f"{ {k: v for k, v in rr['launches'].items() if v} }")
        # the renders against the whole image and each band against the
        # port's own render of that band viewport
        whole = R.render(bench9, cam512, bg0, backend="cuda_tiles",
                         **bench_caps)
        want = (whole.color.cpu().numpy(), whole.depth.cpu().numpy(),
                whole.alpha.cpu().numpy())
        renders = {}
        for scn in ("tile_render", "gauss_tile_render", "slab_render"):
            color, depth, alpha, spill = o4[scn]
            errs9 = dict(color=float(np.abs(color - want[0]).max()),
                         depth=float(np.abs(depth - want[1]).max()),
                         alpha=float(np.abs(alpha - want[2]).max()),
                         spill=spill)
            if (spill or errs9["color"] > BAND_TOL["color"]
                    or errs9["alpha"] > BAND_TOL["alpha"]
                    or errs9["depth"] > BAND_TOL["depth"]):
                raise AssertionError(f"{scn} vs the whole render: {errs9}")
            if scn != "slab_render":
                band = []
                for i in range(512 // 128 if scn == "tile_render" else 2):
                    px = 128 if scn == "tile_render" else 256
                    c, d, t, _ = TS._band_render(
                        bench9, cam512, bg0, px, i * px, chunk=64,
                        backend="cuda_tiles", **bench_caps)
                    rows = slice(i * px, (i + 1) * px)
                    band.append(dict(
                        color=float(np.abs(color[rows]
                                           - c.cpu().numpy()).max()),
                        depth=float(np.abs(depth[rows]
                                           - d.cpu().numpy()).max()),
                        trans=float(np.abs(1.0 - alpha[rows]
                                           - t.cpu().numpy()).max())))
                    bad = {k: v for k, v in band[-1].items() if v > TOL[k]}
                    if bad:
                        raise AssertionError(f"{scn} band {i} vs its own "
                                             f"unsharded render: {bad}")
                errs9["bands_vs_own"] = band
            renders[scn] = errs9
        log(f"  renders vs the whole image (bands vs their own viewport): "
            f"{renders}")
        # the steps: the view-sharded step against the single-rank step
        # over the same views, the view x tile step against the
        # view-sharded step, the depth-slab step against the same slabs
        # merged in one process; each within the step gates. The slab step
        # against the unsharded step: the loss (each slab starts at T = 1,
        # so its early stop, and with it the gradients of pixels past it,
        # differ, as JAX's do; ROADMAP.md §3: reported)
        def counterpart(fn, *a, **kw):
            opt, st, fs = _fresh_opt(qg)
            res = fn(opt, qg, st, fs, *a, **kw)
            return _step_np(res[:3] + (dict(loss=res[3]),))

        cam0 = index_cameras(qcams, 0)
        opt, st, fs = _fresh_opt(qg)
        unsharded = _step_np(F.make_train_step(
            opt, lambda_dssim=0.0, backend="cuda_train", **qg_caps)(
            qg, st, fs, cam0, qtargets[0], bg0))
        views = counterpart(reference_step, qcams, qtargets, bg0,
                            lambda_dssim=0.2, backend="cuda_train",
                            **qg_caps)
        steps = dict(
            view_step=step_vs(o2["view_step"], views),
            view_tile_step=step_vs(o4["view_tile_step"], o2["view_step"]),
            slab_step=step_vs(o4["slab_step"], counterpart(
                slab_step_one_rank, cam0, qtargets[0], bg0, 4,
                backend="cuda_train", **qg_caps)))
        steps["view_step"]["replicas"] = _max_param_diff(
            w2[0]["out"]["view_step"]["params"],
            w2[1]["out"]["view_step"]["params"])
        steps["view_tile_step"]["denom_equal"] = bool(np.array_equal(
            o4["view_tile_step"]["denom"], o2["view_step"]["denom"]))
        unsharded = dict(slab_step=step_vs(o4["slab_step"], unsharded))
        log(f"  steps (view vs one rank, view x tile vs view-sharded, "
            f"slabs vs one-rank slabs): {steps}")
        log(f"  the slab step vs the unsharded step: {unsharded}")
        for scn, e in steps.items():
            if (e["loss"] > STEP_LOSS_TOL or e["grad_rel"] > GRAD_TOL
                    or e["params_max"] > STEP_PARAM_TOL or e["sign_flips"]
                    or e.get("replicas", 0.0) != 0.0
                    or not e.get("denom_equal", True)):
                raise AssertionError(f"{scn}: {e}")
        if unsharded["slab_step"]["loss"] > STEP_LOSS_TOL:
            raise AssertionError(f"slab step vs unsharded: {unsharded}")
        multi.update(world2=reports["world2"], world4=reports["world4"],
                     renders=renders, steps=steps, vs_unsharded=unsharded,
                     shard_edit=[w["out"]["shard_edit"] for w in w2],
                     seconds=time.time() - t9)
        log(f"  shard-mode DDIM step (world 2): {multi['shard_edit']}")
        log(f"  phase 9 took {multi['seconds']:.1f} s")
        del bench9, qg, whole

    # ---- phase 10: the capture and checkpoint paths ---------------------
    capture = None
    if 10 in phases:
        log("phase 10: capture and checkpoint paths (a Blender --render, the "
            "bench capture at 512^2 and its fit, a full-width checkpoint "
            "ingested, the native points parser)")
        t10 = time.time()
        capture = capture_paths(launch, dev, mean_psnr)
        # the kernels against their plain versions at the bench capture's
        # shapes: its ground truth from view 0 at the caps its renders grew
        from dge_tpu_torch.tools import make_bench_capture as MB

        gt = MB.gt_scene(MB.build_gt_scene(0), dev)
        gcam = CameraArrays.from_camera(MB.ring_cameras(
            BENCH_VIEWS, BENCH_SIZE, BENCH_SIZE)[0], device=dev)
        hold(stream_inputs(gt, gcam, capture["bench_capture"]["caps"], True,
                           32, 64), "bench capture view 0")
        del gt
        capture["seconds"] = time.time() - t10
        log(f"  phase 10 took {capture['seconds']:.1f} s")

    if phases != ALL_PHASES:
        log(f"phases {sorted(phases)} passed; the result lines need all "
            "ten")
        return 0

    v0 = fit["view0"]
    # K1 and K5 are each a row kernel and a combine kernel: the row kernel
    # carries the TPU kernel's name, times at the main path's shapes (render
    # path view 0; K5: the tool's 512^2 stream), with the cells beside them
    forward = []
    for log_space, times, launches, cells_of in (
            (False, main_k1, render_launches, [
                dict(cell=c["cell"], **{k: c["k1"][k] for k in
                                        FORWARD_FORMS[False][:2]})
                for c in cells] + [dict(cell="fit view 0", **{
                    k: v0["k1"][k] for k in FORWARD_FORMS[False][:2]})]),
            (True, ev["logdot"], ev["logdot_launches"], [])):
        row_key, comb_key = FORWARD_FORMS[log_space][:2]
        for key, source_note in ((row_key, "row kernel"),
                                 (comb_key, "combine kernel")):
            entry = {
                "name": key,
                "route": "cuda",
                "source": ("dge_tpu_torch/csrc/pairs_logdot.cu" if log_space
                           else "dge_tpu_torch/csrc/pairs_composite.cu"),
                "replaces": ("tools/proto_logdot.py:86" if log_space
                             else "dge_tpu/ops/pallas_composite.py:232"),
                "part": source_note,
                "launches": launches[key],
                "max_abs_err": max(errs[key]),
                **{k: times[key][k] for k in ("ms", "device_ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "bound_terms")},
                # no single PyTorch call walks a depth-ordered list with a
                # carried transmittance and a data-dependent stop
                "library_ms": None,
                "whole_ms": times["whole_ms"],
                "cells": [dict(cell=c["cell"], **c[key]) for c in cells_of],
            }
            if not log_space:
                entry["launches_fit"] = fit["launches"][key]
                entry["launches_edit"] = edit["launches"][key]
                entry["launches_local_edit"] = edit_system["local"][
                    "launches"][key]
                entry["launches_sds"] = edit_system["sds"]["launches"][key]
            forward.append(entry)
    kernels = forward + [{
        "name": "pairs_pass1",
        "route": "cuda",
        "source": "dge_tpu_torch/csrc/pairs_backward.cu",
        "replaces": "dge_tpu/ops/pallas_backward.py:111",
        "launches": fit["launches"]["pairs_pass1"],
        "launches_edit": edit["launches"]["pairs_pass1"],
        "launches_local_edit": edit_system["local"]["launches"]["pairs_pass1"],
        "launches_sds": edit_system["sds"]["launches"]["pairs_pass1"],
        "max_abs_err": max(errs["pairs_pass1"]),
        "max_rel_err": max(rels["pairs_pass1"]),  # of the field's max
        "ms": v0["pass1_ms"],  # the row kernel; the whole wrapper below
        "device_ms": v0["pass1_device_ms"],  # profiler: no host time
        "whole_ms": v0["pass1_whole_ms"],
        "walk_route_ms": v0["pass1_walk_route_ms"],
        "plain_ms": v0["pass1_plain_ms"],
        "bound_ms": v0["pass1_bound_ms"],
        "bound_by": v0["pass1_bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }, {
        "name": "pairs_suffix",
        "route": "cuda",
        "source": "dge_tpu_torch/csrc/pairs_backward.cu",
        "replaces": "dge_tpu/ops/pallas_backward.py:287",
        "launches": fit["launches"]["pairs_suffix"],
        "launches_edit": edit["launches"]["pairs_suffix"],
        "launches_local_edit": edit_system["local"]["launches"]["pairs_suffix"],
        "launches_sds": edit_system["sds"]["launches"]["pairs_suffix"],
        "max_abs_err": max(errs["pairs_suffix"]),
        "max_rel_err": max(rels["pairs_suffix"]),  # of the field's max
        "ms": v0["suffix_ms"],
        "device_ms": v0["suffix_device_ms"],
        "plain_ms": v0["suffix_plain_ms"],
        "bound_ms": v0["suffix_bound_ms"],
        "bound_by": v0["suffix_bound_by"],
        # a flipped cumsum works on a dense [T, rows, P], not on compact rows
        "library_ms": None,
    }, {
        "name": "pairs_pass2",
        "route": "cuda",
        "source": "dge_tpu_torch/csrc/pairs_backward.cu",
        "replaces": "dge_tpu/ops/pallas_backward.py:157",
        "launches": fit["launches"]["pairs_pass2"],
        "launches_edit": edit["launches"]["pairs_pass2"],
        "launches_local_edit": edit_system["local"]["launches"]["pairs_pass2"],
        "launches_sds": edit_system["sds"]["launches"]["pairs_pass2"],
        "max_abs_err": max(errs["pairs_pass2"]),
        "max_rel_err": max(rels["pairs_pass2"]),  # of the row's max |grad|
        "ms": v0["pass2_ms"],
        "device_ms": v0["pass2_device_ms"],
        "plain_ms": v0["pass2_plain_ms"],
        "bound_ms": v0["pass2_bound_ms"],
        "bound_by": v0["pass2_bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }, {
        "name": "pairs_fold",
        "route": "cuda",
        "source": "dge_tpu_torch/csrc/pairs_backward.cu",
        # the `.at[].add` fold after the backward kernels (jnp, no Pallas)
        "replaces": "dge_tpu/ops/pallas_backward.py:341",
        "launches": fit["launches"]["pairs_fold"],
        "launches_edit": edit["launches"]["pairs_fold"],
        "launches_local_edit": edit_system["local"]["launches"]["pairs_fold"],
        "launches_sds": edit_system["sds"]["launches"]["pairs_fold"],
        "max_abs_err": max(errs["pairs_fold"]),
        **{k: fit["fold"][k] for k in (
            "ms", "device_ms", "kernel_device_ms", "layout_device_ms",
            "plain_ms", "bound_ms", "bound_by", "layout_bound_ms",
            "library_ms", "library_device_ms", "launches_per_fold")},
        "cells": [dict(cell="512x512", **train["fold"]),
                  dict(cell="edit refit view 0", **edit["fold"])],
    }, {
        "name": "list_stream",
        "route": "cuda",
        "source": "dge_tpu_torch/csrc/list_stream.cu",
        # the TPU wrapper's gather feat[:, order[lists]] (jnp, no Pallas)
        "replaces": "dge_tpu/ops/pallas_composite.py:187",
        "launches": ev["validate"]["cuda_tiles"]["launches"]["list_stream"],
        "max_abs_err": max(errs["list_stream"]),
        "ms": ev["view0"]["list_stream_ms"],
        "device_ms": ev["view0"]["list_stream_device_ms"],
        "plain_ms": ev["view0"]["list_stream_plain_ms"],
        "bound_ms": ev["view0"]["list_stream_bound_ms"],
        "bound_by": "bytes",
        # index_select gathers, but only from the per-position ids, which
        # take their own ops to form
        "library_ms": None,
    }, {
        # K2: its lists as a chunk-aligned stream through K1's row and
        # combine kernels. Its times are those of the three kernels named in
        # composite_of, whose own entries count them too: add it to none.
        "name": "tiles_composite",
        "composite_of": ["list_stream", *FORWARD_FORMS[False][:2]],
        "route": "cuda",
        "source": "dge_tpu_torch/csrc/pair_rows_forward.cuh",
        "replaces": "dge_tpu/ops/pallas_composite.py:51",
        "launches": ev["validate"]["cuda_tiles"]["launches"][
            "tiles_composite"],
        "max_abs_err": max(errs["tiles_composite"]),
        **{k: ev["view0"][k] for k in (
            "ms", "device_ms", "row_device_ms", "combine_device_ms",
            "layout_device_ms", "list_stream_device_ms", "list_rows_ms",
            "list_stream_ms", "rows", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,  # no single PyTorch call computes this function
        "cells": ev["list_cells"],
    }]
    # phase 9: each kernel's launches per scenario, one count a rank
    per_rank = {"nccl_world1_train": [multi["nccl_world1"]["launches"]]}
    for world in ("world2", "world4"):
        for scn in multi[world][0]:
            per_rank[f"{world}_{scn}"] = [rep[scn]["launches"]
                                          for rep in multi[world]]
    for entry in kernels:
        entry["launches_multi_gpu"] = {
            scn: [counts[entry["name"]] for counts in ranks_]
            for scn, ranks_ in per_rank.items()}
        # phase 10: the Blender render, the bench capture's renders, its fit
        entry["launches_capture"] = {
            run_: capture[run_]["launches"][entry["name"]]
            for run_ in ("blender", "bench_capture", "bench_fit")}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    result = {"kernels": kernels, "psnr_mean_db": mean_psnr,
              "psnr_views_db": psnrs, "fit": fit, "train_512": train,
              "evaluation": ev, "edit": edit, "edit_system": edit_system,
              "multi_gpu": multi, "capture": capture,
              "card": smi,
              "seconds": time.time() - t_start}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log("kernels: " + json.dumps(list(KERNEL_NAMES)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
