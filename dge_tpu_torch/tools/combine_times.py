"""Times of the forward's combine kernel (``pairs_composite.rows_combine``,
``rows_combine_kernel`` of ``csrc/pair_rows_forward.cuh``) beside its row
kernel on one card, at the four views ``chip_smoke.py`` holds it at: the
fit view (capture view 0 of a seed-0 ``--fit`` of the committed capture at
256^2, with the ``boundary_T`` store the training forward asks for), the
quality-gate scene at 256^2 (capture view 0, the render path), and the
bench scene at 512^2 and 1920x1080; at 512^2 also the list kernel K2's
combine (its lists as the aligned stream) and the log-space arm K5's.

    python dge_tpu_torch/tools/combine_times.py [--root DIR] [--json PATH]
        [--fit-ply PATH] [--fit-steps N]

``--root`` names the checkout whose ``dge_tpu_torch`` is timed (default: the
one this file is in), so that two trees are compared in one run on one card
(run the file by its path: the package is imported from ``--root``). The fit
view's scene comes from ``--fit-ply`` where that file exists; otherwise the
tool fits it (``--fit-steps``, 1,200 by default) and, given ``--fit-ply``,
saves it there, so that later runs time the same scene. Every cell binds at
the caps a spill-free renderer settles on.

Per cell it prints: the row kernel's and the combine's device time per
launch and launches per call (a ``torch.profiler`` trace), their sum against
K1's whole bound and each kernel's own bound, the combine's case counts in
(row, pixel) visits (``combine_cases``), the rows in use, the fullest
tile's rows against the mean, and a sha256 of ``out`` and of ``boundary_T``
over the rows in use, so that two trees can be shown equal bit for bit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ROOT = os.path.dirname(os.path.dirname(HERE))
# the sibling tools of this file's tree, whatever tree --root names
sys.path.insert(0, HERE)
import list_kernel_times as LKT  # noqa: E402
TILE_PX = 32
# H100 SXM (NVIDIA's data sheet): HBM rate and f32 rate outside the tensor
# cores; operations per (pair, pixel) of the row kernel (K1 / K5)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
ROW_OPS = {False: 25, True: 27}


def sha256(x) -> str:
    return hashlib.sha256(x.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def bounds(pairs: int, num_tiles: int, rows: int, chunk: int,
           log_space: bool, boundary: bool) -> dict:
    """Least times in ms on this card, each the larger of bytes over the HBM
    rate and operations over the f32 rate: K1 whole (each pair's 40 bytes
    read, [T, 5, P] written; 25 operations per (pair, pixel)), its row
    kernel (the pairs read, scratch R·P·28 (32) and the keep mask written)
    and its combine (the scratch read, [T, 5, P] and, with ``boundary``,
    boundary_T R·P·4 written; one multiply-add per field, row and pixel;
    its walks depend on the data and are not counted)."""
    p = TILE_PX * TILE_PX
    fields = 8 if log_space else 7
    mask_bytes = rows * 4 * -(-p // 128) * -(-chunk // 32) * 4
    out_bytes = num_tiles * p * 20
    row_ops = pairs * p * ROW_OPS[log_space]

    def least(nbytes, ops):
        return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3

    return dict(
        whole=least(pairs * 40 + out_bytes, row_ops),
        row=least(pairs * 40 + rows * p * fields * 4 + mask_bytes, row_ops),
        combine=least(rows * p * fields * 4 + out_bytes
                      + boundary * rows * p * 4, rows * p * 8))


def kernel_times(fn, calls: int = 20) -> dict:
    """Per kernel name (``rows_forward_kernel`` / ``rows_combine_kernel``):
    device ms per launch and launches per call of ``fn``, from a
    torch.profiler trace."""
    out = {}
    for name, (ms, count) in LKT.device_ms(fn, calls=calls)["kernels"].items():
        for part in ("rows_forward_kernel", "rows_combine_kernel"):
            if part in name and count > 0:
                out[part] = dict(ms=ms / count, launches=round(count))
    return out


def forward_cell(inp: dict, *, log_space: bool = False,
                 boundary: bool = False) -> dict:
    """The row kernel then the combine on one stream (``inp``: data, starts,
    counts, tiles_x, chunk)."""
    import torch

    from dge_tpu_torch.ops import pairs_composite as PC
    from dge_tpu_torch.utils import tracing

    # through the registry: every tree that --root may name has the group
    launch_counts = tracing.group("launch_counts")
    args = (inp["data"], inp["starts"], inp["counts"])
    kw = dict(tiles_x=inp["tiles_x"], tile_px=TILE_PX, chunk=inp["chunk"],
              log_space=log_space)
    num_tiles = inp["starts"].shape[0]
    blk_off, row_tile, _ = PC.block_rows(inp["starts"], inp["counts"],
                                         inp["chunk"], inp["data"].shape[1])
    used = row_tile < num_tiles

    def call():
        scratch, mask = PC.rows_forward(*args, blk_off, row_tile, **kw)
        return PC.rows_combine(scratch, mask, *args, blk_off,
                               boundary=boundary, **kw)

    scratch, mask = PC.rows_forward(*args, blk_off, row_tile, **kw)
    before = dict(launch_counts)
    out, bt = PC.rows_combine(scratch, mask, *args, blk_off, boundary=True,
                              **kw)
    torch.cuda.synchronize()
    launched = {k: launch_counts[k] - before[k] for k in launch_counts
                if launch_counts[k] != before[k]}
    cases = PC.combine_cases(scratch, bt, row_tile, num_tiles,
                             log_space=log_space)
    s = inp["starts"].long()
    c = inp["counts"].long()
    chunk = inp["chunk"]
    tile_rows = torch.where(c > 0, (s + c - 1) // chunk - s // chunk + 1,
                            torch.zeros_like(c))
    rows = int(used.sum())
    times = kernel_times(call)
    b = bounds(inp["pairs"], num_tiles, rows, chunk, log_space, boundary)
    row_ms = times["rows_forward_kernel"]["ms"]
    comb_ms = times["rows_combine_kernel"]["ms"]
    return dict(
        pairs=inp["pairs"], tiles=num_tiles, chunk=chunk, rows=rows,
        fullest_tile_rows=int(tile_rows.max()),
        mean_tile_rows=float(tile_rows[c > 0].float().mean()),
        row_device_ms=row_ms, combine_device_ms=comb_ms,
        row_launches=times["rows_forward_kernel"]["launches"],
        combine_launches=times["rows_combine_kernel"]["launches"],
        combine_launch_counter=launched, boundary_store=boundary,
        sum_device_ms=row_ms + comb_ms, whole_bound_ms=b["whole"],
        sum_x_whole_bound=(row_ms + comb_ms) / b["whole"],
        row_bound_ms=b["row"], combine_bound_ms=b["combine"],
        combine_x_bound=comb_ms / b["combine"], cases=cases,
        out_sha256=sha256(out), boundary_t_sha256=sha256(bt[used]))


def stream_inputs(scene, cam, r, chunk: int = 64) -> dict:
    """K1's inputs for one frame at the spill-free renderer ``r``'s caps, as
    render() forms them at the renderer's ``chunk`` (the stream kernels run
    at max(chunk, 128))."""
    pb, data = LKT.pair_stream(scene, cam, r, TILE_PX)
    return dict(data=data, starts=pb.starts.contiguous(),
                counts=pb.counts.contiguous(), tiles_x=pb.tiles_x,
                pairs=int(pb.counts.sum()), chunk=max(chunk, 128))


def list_stream_inputs(scene, cam, r, chunk: int = 64) -> dict:
    """K2's aligned list stream for one frame at the spill-free
    ``cuda_tiles`` renderer ``r``'s caps, as ``composite_tiles_kernel``
    lays it out."""
    from dge_tpu_torch.ops import tiles_composite as TT

    inp = LKT.list_inputs(scene, cam, r.caps, r.tight_cull, chunk)
    counts = inp["counts"].clamp(max=inp["lists"].shape[1])
    starts, _, cum, n_rows = TT.list_rows(counts, inp["chunk"])
    data, _ = TT.list_stream(inp["feat"], inp["lists"], counts, None, cum,
                             n_rows, inp["chunk"])
    return dict(data=data, starts=starts, counts=counts,
                tiles_x=inp["tiles_x"], pairs=int(counts.sum()),
                chunk=inp["chunk"])


def fitted_scene(path, steps: int, capture: str, dev):
    """The seed-0 fit of the capture at 256^2 (SH 3), as ``chip_smoke.py``
    phase 4 runs it: loaded from ``path`` where that exists, else fitted
    and, given ``path``, saved there."""
    from dge_tpu_torch import launch
    from dge_tpu_torch.scene import gaussians as G

    if path and os.path.exists(path):
        return G.load_ply(path, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        run = launch.main(["--fit", "--source", capture, "--out", tmp,
                           "--seed", "0", "data.height=256",
                           "data.width=256", "system.sh_degree=3",
                           f"trainer.max_steps={steps}"])
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            shutil.copyfile(run.ply_path, path)
        return G.load_ply(run.ply_path, device=dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT,
                    help="checkout whose dge_tpu_torch is timed")
    ap.add_argument("--json", default=None, help="also write the results")
    ap.add_argument("--fit-ply", default=None,
                    help="the fit view's scene: loaded if it exists, else "
                    "fitted and saved here")
    ap.add_argument("--fit-steps", type=int, default=1200)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("combine_times: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    import dge_tpu_torch
    from dge_tpu_torch.ops import render as R

    dev = torch.device("cuda")
    bg = torch.zeros(3, device=dev)
    sc = LKT.scenes(dev)
    quality, cam0, bench = sc["quality"], sc["cam0"], sc["bench"]

    def renderer(scene, cam, chunk=64, **start):
        r = R.SpillFreeRenderer(scene, bg, tile_px=TILE_PX, chunk=chunk,
                                **start)
        if r.probe(cam) != 0:
            raise AssertionError("spill after the ladder")
        return r

    fit = fitted_scene(args.fit_ply, args.fit_steps, sc["capture"], dev)
    cam512, cam1080 = sc["bench_cam"](512, 512), sc["bench_cam"](1080, 1920)
    r512 = renderer(bench, cam512)
    cells = [
        ("fit view 0", lambda: forward_cell(
            stream_inputs(fit, cam0, renderer(fit, cam0)), boundary=True)),
        ("256x256 view 0", lambda: forward_cell(
            stream_inputs(quality, cam0, renderer(quality, cam0)))),
        ("512x512", lambda: forward_cell(stream_inputs(bench, cam512, r512))),
        ("1920x1080", lambda: forward_cell(stream_inputs(
            bench, cam1080, renderer(
                bench, cam1080, chunk=256, tight_cull=True,
                max_per_tile=2048, max_tiles_per_gaussian=64,
                small_slots=16, max_pairs=3 << 18, big_capacity=16384),
            chunk=256))),
        ("512x512 K2", lambda: forward_cell(list_stream_inputs(
            bench, cam512, renderer(bench, cam512, backend="cuda_tiles",
                                    tight_cull=True,
                                    max_tiles_per_gaussian=256)))),
        ("512x512 K5", lambda: forward_cell(
            stream_inputs(bench, cam512, r512), log_space=True)),
    ]
    out = dict(root=os.path.abspath(args.root),
               package=os.path.dirname(dge_tpu_torch.__file__),
               card=torch.cuda.get_device_name(0), cells={})
    for name, cell in cells:
        out["cells"][name] = cell()
        print(f"{name}: {json.dumps(out['cells'][name])}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
