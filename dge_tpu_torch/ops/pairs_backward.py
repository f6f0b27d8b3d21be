"""Differentiable pair-stream compositing: the forward kernel plus the
hand-written backward kernels behind one ``torch.autograd.Function``.

JAX counterpart: ``dge_tpu/ops/pallas_backward.py`` (``_pass1_kernel``,
``_pass2_kernel``, ``_stream_backward``, ``stream_composite``). The kernels
are ``dge_tpu_torch/csrc/pairs_backward.cu``; its source note states what
they compute, the design and the bounds.

- ``block_rows`` (from ops/pairs_composite.py, which owns the row layout)
  lays the (tile, stream block) rows out compactly.
- ``boundary_T`` ``[R, P]``, the transmittance entering each row, is handed
  over by the forward (``composite_pairs_stream(boundary_rows=...)``): the
  forward's combine kernel holds it anyway, so every backward kernel runs one
  thread block per row.
- ``pairs_row_totals`` (pass 1: each row's total of ``w·g`` from its
  ``boundary_T``), ``pairs_suffix`` (the totals become the inclusive suffix
  over a tile's later rows) and ``pairs_pass2`` are the kernels' wrappers:
  CUDA tensors launch the kernel or raise, CPU tensors take the plain
  version; nothing falls back. ``pairs_pass1`` joins the first two and
  returns ``(boundary_T, suffix)``; without a handed-over ``boundary_T`` it
  gets one from the forward's kernels.
- ``pass1_reference`` (the whole of pass 1 by a serial walk),
  ``row_totals_reference``, ``suffix_reference`` and ``pass2_reference`` are
  the plain PyTorch versions (``torch.cumprod`` and a flipped ``cumsum`` per
  block), same inputs and outputs as the kernels.
- ``fold_to_gaussians`` is the fold's wrapper: per-pair gradients ``[10,
  Pc]`` to per-Gaussian ``[10, N]``, each Gaussian's sum taken over its
  pairs in stream order from 0. On CUDA tensors it reads the binning's
  layout (``binning.FoldLayout``: a Gaussian's pairs lie in the stream in
  the order of its emission slots), inverts the sort's permutation in a
  layout kernel and adds each Gaussian's slots in order in the fold
  kernel; there is no second sort. On CPU tensors it is one
  ``index_add_``, which adds serially in stream order.
  ``fold_reference`` is the two kernels' arithmetic in plain PyTorch;
  ``ids_layout`` gives a stream that no binning made (test fixtures) a
  layout.
- ``stream_backward`` runs pass 1, pass 2 and the fold. Pass 2's per-pair
  gradients and the fold's sums are bit-identical from launch to launch,
  so a fit is reproducible from its seed.
- ``stream_composite`` is the Function: forward = stream assembly + the
  forward kernels (``pairs_composite.composite_pairs_stream``, which also
  stores ``boundary_T``), backward = ``stream_backward``. It returns (color,
  depth, final_T) with a zero background; the caller adds ``bg·T``, so that
  autograd supplies dL/dT_fin.

Every block of a tile's range is visited once. The TPU wrapper clamps its
block index to the stream's last block, so a tile whose range reaches that
block re-runs it and its gradients are added more than once; the port does
not copy that (ROADMAP.md §3).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dge_tpu_torch.ops import binning, cuda_build
from dge_tpu_torch.ops import pairs_composite as PC
from dge_tpu_torch.ops.pairs_composite import (ALPHA_EPS, ALPHA_MAX, FEAT,
                                               T_EPS, block_rows,
                                               launch_counts)

# The row kernel keeps, in dynamic shared memory, the staged row ([chunk, 12]
# floats) and, in pass 2, one slot of [chunk, 10] partial sums per warp (8
# warps for a 32x32 tile): 46 KB at chunk 128, 184 KB at 512, of the 227 KB a
# block may have. Above 48 KB the launcher asks for the size with
# cudaFuncSetAttribute (once per device and size) and returns its error; a
# chunk above MAX_CHUNK is refused here.
MAX_CHUNK = 512
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build_library("pairs_backward"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pairs_row_totals.argtypes = [
            ptr, i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, i32, i32, i32, i32,
            ptr, ptr]
        lib.pairs_row_totals.restype = i32
        lib.pairs_rows_suffix.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr]
        lib.pairs_rows_suffix.restype = i32
        lib.pairs_pass2.argtypes = [
            ptr, i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, i32, i32,
            i32, i32, ptr, ptr]
        lib.pairs_pass2.restype = i32
        lib.pairs_fold.argtypes = [ptr, i32, ptr, i32, i32, ptr, i32, i32,
                                   i32, i32, ptr, ptr, ptr, ptr]
        lib.pairs_fold.restype = i32
        _lib = lib
    return _lib


def _block_state(data, idx, in_range, px, py, trans):
    """The forward's per-block quantities for the stream positions ``idx``
    [G, C] from the entering transmittance ``trans`` [G, 1, P] (the
    arithmetic of ``composite_pairs_reference``)."""
    pc = data.shape[1]
    f = data[:, idx.clamp(0, pc - 1)][..., None]  # [FEAT, G, C, 1]
    dx = f[0] - px
    dy = f[1] - py
    power = -0.5 * (f[2] * dx * dx + f[4] * dy * dy) - f[3] * dx * dy
    ex = torch.exp(power)
    raw = f[5] * ex
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_EPS) & in_range[..., None]
    eff = torch.where(keep, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - eff
    cp = torch.cumprod(one_minus, dim=1)  # inclusive, [G, C, P]
    applied = trans * cp >= T_EPS
    t_prev = trans * (cp / one_minus)
    w = torch.where(applied, eff * t_prev, torch.zeros_like(cp))
    return dict(f=f, dx=dx, dy=dy, ex=ex, raw=raw, keep=keep, eff=eff,
                one_minus=one_minus, cp=cp, applied=applied, t_prev=t_prev,
                w=w)


def _pair_g(f, cot):
    """g = rgb·dL/dC + depth·dL/dD per (pair, pixel); cot [G, 5, P]."""
    return (f[6] * cot[:, None, 0] + f[7] * cot[:, None, 1]
            + f[8] * cot[:, None, 2] + f[9] * cot[:, None, 3])


def pass1_reference(data, starts, counts, blk_off, n_rows: int, cot, *,
                    tiles_x: int, tile_px: int, chunk: int):
    """Plain PyTorch version of pass 1 → (boundary_T, suffix), each
    [n_rows, P]: per (tile, stream block) row the transmittance entering the
    block and the sum of ``w·g`` over this and all later blocks of the tile.
    Unused rows are 0."""
    dev = data.device
    p = tile_px * tile_px
    boundary_t = torch.zeros(n_rows, p, dtype=torch.float32, device=dev)
    suffix = torch.zeros(n_rows, p, dtype=torch.float32, device=dev)
    live = torch.nonzero(counts > 0).flatten()
    if data.shape[1] == 0 or live.numel() == 0:
        return boundary_t, suffix
    starts = starts.long()
    ends = starts + counts.long()
    first = starts // chunk
    nblk = (ends - 1) // chunk - first + 1
    slot = torch.arange(chunk, device=dev)
    group = max(1, (1 << 23) // (chunk * p))
    for g0 in range(0, live.numel(), group):
        tiles = live[g0:g0 + group]
        px, py = PC.pixel_coords(tiles, tiles_x, tile_px, dev)
        s, e, fb, nb = starts[tiles], ends[tiles], first[tiles], nblk[tiles]
        row0 = blk_off[tiles].long()
        cot_g = cot[tiles]
        trans = torch.ones(tiles.numel(), 1, p, device=dev)
        totals = []
        for k in range(int(nb.max())):
            idx = (fb + k)[:, None] * chunk + slot[None, :]
            in_range = (idx >= s[:, None]) & (idx < e[:, None])
            st = _block_state(data, idx, in_range, px, py, trans)
            has = k < nb
            boundary_t[(row0 + k)[has]] = trans[has, 0]
            # 0 for a tile whose range ended before block k
            totals.append(PC.ordered_sum(st["w"] * _pair_g(st["f"], cot_g),
                                         1))
            trans = trans * torch.where(
                st["applied"], st["cp"], torch.ones_like(st["cp"])).amin(
                    dim=1, keepdim=True)
        run = torch.zeros(tiles.numel(), p, device=dev)
        for k in reversed(range(len(totals))):
            run = run + totals[k]
            has = k < nb
            suffix[(row0 + k)[has]] = run[has]
    return boundary_t, suffix


def _row_state(data, starts, ends, blk_off, row_tile, rows, boundary_t, *,
               tiles_x: int, tile_px: int, chunk: int):
    """``_block_state`` of the rows ``rows`` [G], each entered at its
    ``boundary_t``; also the rows' tiles, stream positions and range mask."""
    tiles = row_tile[rows].long()
    k = rows - blk_off[tiles].long()
    px, py = PC.pixel_coords(tiles, tiles_x, tile_px, data.device)
    slot = torch.arange(chunk, device=data.device)
    idx = (starts[tiles] // chunk + k)[:, None] * chunk + slot[None, :]
    in_range = (idx >= starts[tiles][:, None]) & (idx < ends[tiles][:, None])
    st = _block_state(data, idx, in_range, px, py,
                      boundary_t[rows][:, None, :])
    return st, tiles, idx, in_range


def row_totals_reference(data, starts, counts, blk_off, row_tile, cot,
                         boundary_t, *, tiles_x: int, tile_px: int,
                         chunk: int):
    """Plain PyTorch version of the pass-1 row kernel → totals [R, P]: per
    (tile, stream block) row, entered at ``boundary_t``, the sum of ``w·g``
    over the row's pairs. Unused rows are 0."""
    num_tiles = starts.shape[0]
    p = tile_px * tile_px
    totals = torch.zeros(row_tile.shape[0], p, dtype=torch.float32,
                         device=data.device)
    rows = torch.nonzero(row_tile < num_tiles).flatten()
    if data.shape[1] == 0 or rows.numel() == 0:
        return totals
    starts = starts.long()
    ends = starts + counts.long()
    group = max(1, (1 << 22) // (chunk * p))
    for g0 in range(0, rows.numel(), group):
        r = rows[g0:g0 + group]
        st, tiles, _, _ = _row_state(data, starts, ends, blk_off, row_tile, r,
                                     boundary_t, tiles_x=tiles_x,
                                     tile_px=tile_px, chunk=chunk)
        totals[r] = PC.ordered_sum(st["w"] * _pair_g(st["f"], cot[tiles]), 1)
    return totals


def suffix_reference(totals, starts, counts, blk_off, *, chunk: int):
    """Plain PyTorch version of the suffix kernel → [R, P]: per tile the
    rows' totals summed over this and all later rows of the tile (last row
    first, as the kernel adds them). Unused rows are 0."""
    suffix = torch.zeros_like(totals)
    s = starts.long()
    e = s + counts.long()
    nblk = torch.where(counts > 0, (e - 1) // chunk - s // chunk + 1,
                       torch.zeros_like(s))
    live = torch.nonzero(nblk > 0).flatten()
    if live.numel() == 0:
        return suffix
    row0, nb = blk_off[live].long(), nblk[live]
    run = torch.zeros(live.numel(), totals.shape[1], dtype=totals.dtype,
                      device=totals.device)
    for k in reversed(range(int(nb.max()))):
        has = k < nb
        at = (row0 + k)[has]
        run[has] = run[has] + totals[at]
        suffix[at] = run[has]
    return suffix


def pass2_reference(data, starts, counts, blk_off, row_tile, cot, fwd_out,
                    boundary_t, suffix, *, tiles_x: int, tile_px: int,
                    chunk: int):
    """Plain PyTorch version of pass 2 → per-pair gradients [10, Pc] in
    stream order (rows mx, my, conic a, b, c, opacity, r, g, b, depth; 0 at
    positions outside every tile's range). The in-block suffix is a flipped
    ``cumsum``; the later blocks' part is ``suffix`` minus the block's own
    total."""
    dev = data.device
    num_tiles = starts.shape[0]
    p = tile_px * tile_px
    pc = data.shape[1]
    grads = torch.zeros(FEAT, pc, dtype=torch.float32, device=dev)
    rows = torch.nonzero(row_tile < num_tiles).flatten()
    if pc == 0 or rows.numel() == 0:
        return grads
    starts = starts.long()
    ends = starts + counts.long()
    group = max(1, (1 << 22) // (chunk * p))
    for g0 in range(0, rows.numel(), group):
        r = rows[g0:g0 + group]
        st, tiles, idx, in_range = _row_state(
            data, starts, ends, blk_off, row_tile, r, boundary_t,
            tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
        f, w, dx, dy = st["f"], st["w"], st["dx"], st["dy"]
        cot_g = cot[tiles]  # [G, 5, P]
        g = _pair_g(f, cot_g)
        wg = w * g
        suf_in = torch.flip(torch.cumsum(torch.flip(wg, [1]), 1), [1]) - wg
        later = suffix[r][:, None, :] - PC.ordered_sum(wg, 1)[:, None, :]
        tfin_term = (cot_g[:, 4] * fwd_out[tiles, 4])[:, None, :]
        contrib = (st["eff"] > 0.0) & st["applied"]
        dalpha = torch.where(
            contrib,
            st["t_prev"] * g - (suf_in + later + tfin_term) / st["one_minus"],
            torch.zeros_like(g))
        # chain through alpha = min(0.99, op·exp(power)): none when clamped
        da = torch.where((st["raw"] < ALPHA_MAX) & st["keep"], dalpha,
                         torch.zeros_like(g))
        dpow = da * st["raw"]
        vals = torch.stack([PC.ordered_sum(x, -1) for x in (
            dpow * (-(f[2] * dx + f[3] * dy)),
            dpow * (-(f[4] * dy + f[3] * dx)),
            dpow * (-0.5) * dx * dx,
            dpow * (-(dx * dy)),
            dpow * (-0.5) * dy * dy,
            da * st["ex"],
            w * cot_g[:, None, 0],
            w * cot_g[:, None, 1],
            w * cot_g[:, None, 2],
            w * cot_g[:, None, 3],
        )])  # [FEAT, G, C]
        grads[:, idx[in_range]] = vals[:, in_range]
    return grads


def _check(name: str, tensors, chunk: int, tile_px: int):
    """Shared argument checks; returns True when every tensor is on the CPU
    (the plain version runs) and False when all share one CUDA device."""
    for what, t, dtype in tensors:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} "
                             f"tensor, got {t.dtype}")
    devices = {t.device for _, t, _ in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: all tensors must share one CUDA device, "
                         f"got {devices}")
    if not 1 <= tile_px <= 32:
        raise ValueError(f"tile_px {tile_px}: four pixels a thread, 256 "
                         "threads a block need tile_px**2 <= 1024")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    return False


def pairs_row_totals(data, starts, counts, blk_off, row_tile, cot,
                     boundary_t, *, tiles_x: int, tile_px: int, chunk: int):
    """The pass-1 row kernel's wrapper → totals [R, P] of ``w·g`` per (tile,
    stream block) row, each row walked from its ``boundary_t``. On CUDA
    tensors it launches the kernel (rows not in use are left unwritten), or
    raises; on CPU tensors it takes the plain version."""
    num_tiles = starts.shape[0]
    n_rows = row_tile.shape[0]
    p = tile_px * tile_px
    f32, i32 = torch.float32, torch.int32
    on_cpu = _check("pairs_row_totals", (
        ("data", data, f32), ("starts", starts, i32), ("counts", counts, i32),
        ("blk_off", blk_off, i32), ("row_tile", row_tile, i32),
        ("cot", cot, f32), ("boundary_t", boundary_t, f32)), chunk, tile_px)
    if data.dim() != 2 or data.shape[0] != FEAT:
        raise ValueError(f"data must be [{FEAT}, Pc], got {tuple(data.shape)}")
    if cot.shape != (num_tiles, 5, p) or blk_off.shape != (num_tiles,):
        raise ValueError("cot must be [T, 5, P] and blk_off [T]")
    if boundary_t.shape != (n_rows, p):
        raise ValueError("boundary_t must be [R, P], R = rows")
    if on_cpu:
        return row_totals_reference(data, starts, counts, blk_off, row_tile,
                                    cot, boundary_t, tiles_x=tiles_x,
                                    tile_px=tile_px, chunk=chunk)
    lib = _load()
    totals = torch.empty(n_rows, p, dtype=f32, device=data.device)
    with torch.cuda.device(data.device):
        err = lib.pairs_row_totals(
            data.data_ptr(), data.shape[1], starts.data_ptr(),
            counts.data_ptr(), blk_off.data_ptr(), row_tile.data_ptr(),
            n_rows, cot.data_ptr(), boundary_t.data_ptr(), num_tiles, tiles_x,
            tile_px, chunk, totals.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairs_row_totals launch failed: cudaError {err}")
    launch_counts["pairs_pass1"] += 1
    return totals


def pairs_suffix(totals, starts, counts, blk_off, *, tile_px: int,
                 chunk: int):
    """The suffix kernel's wrapper → [R, P]: per tile the inclusive sum of
    ``totals`` over this and all later rows. On CUDA tensors it launches the
    kernel (rows not in use are left unwritten), or raises; on CPU tensors
    it takes the plain version."""
    num_tiles = starts.shape[0]
    f32, i32 = torch.float32, torch.int32
    on_cpu = _check("pairs_suffix", (
        ("totals", totals, f32), ("starts", starts, i32),
        ("counts", counts, i32), ("blk_off", blk_off, i32)), chunk, tile_px)
    if totals.dim() != 2 or totals.shape[1] != tile_px * tile_px:
        raise ValueError("totals must be [R, P]")
    if on_cpu:
        return suffix_reference(totals, starts, counts, blk_off, chunk=chunk)
    lib = _load()
    suffix = torch.empty_like(totals)
    with torch.cuda.device(totals.device):
        err = lib.pairs_rows_suffix(
            totals.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            blk_off.data_ptr(), num_tiles, tile_px, chunk, suffix.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairs_rows_suffix launch failed: cudaError {err}")
    launch_counts["pairs_suffix"] += 1
    return suffix


def pairs_pass1(data, starts, counts, blk_off, n_rows: int, cot, *,
                tiles_x: int, tile_px: int, chunk: int,
                boundary_t: Optional[torch.Tensor] = None,
                row_tile: Optional[torch.Tensor] = None):
    """Pass 1 → (boundary_T, suffix), each [n_rows, P] (on CUDA tensors rows
    not in use are left unwritten). With ``boundary_t`` handed over by the
    forward only the row kernel and the suffix kernel run. Without, it comes
    from the forward's row and combine kernels; on CPU tensors that route is
    ``pass1_reference``."""
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    if boundary_t is None and data.device.type == "cpu":
        f32, i32 = torch.float32, torch.int32
        _check("pairs_pass1", (
            ("data", data, f32), ("starts", starts, i32),
            ("counts", counts, i32), ("blk_off", blk_off, i32),
            ("cot", cot, f32)), chunk, tile_px)
        if cot.shape != (starts.shape[0], 5, tile_px * tile_px):
            raise ValueError("cot must be [T, 5, P] and blk_off [T]")
        return pass1_reference(data, starts, counts, blk_off, n_rows, cot,
                               **kw)
    if row_tile is None:
        _, row_tile, _ = block_rows(starts, counts, chunk, data.shape[1])
    if boundary_t is None:
        _, boundary_t = PC.composite_pairs_stream(
            data, starts, counts, boundary_rows=(blk_off, n_rows),
            row_tile=row_tile, **kw)
    totals = pairs_row_totals(data, starts, counts, blk_off, row_tile, cot,
                              boundary_t, **kw)
    return boundary_t, pairs_suffix(totals, starts, counts, blk_off,
                                    tile_px=tile_px, chunk=chunk)


def pairs_pass2(data, starts, counts, blk_off, row_tile, cot, fwd_out,
                boundary_t, suffix, *, tiles_x: int, tile_px: int, chunk: int):
    """Pass 2's wrapper → per-pair gradients [10, Pc] in stream order. On
    CUDA tensors it launches the kernel, or raises; on CPU tensors it takes
    the plain version."""
    num_tiles = starts.shape[0]
    n_rows = row_tile.shape[0]
    p = tile_px * tile_px
    f32, i32 = torch.float32, torch.int32
    on_cpu = _check("pairs_pass2", (
        ("data", data, f32), ("starts", starts, i32), ("counts", counts, i32),
        ("blk_off", blk_off, i32), ("row_tile", row_tile, i32),
        ("cot", cot, f32), ("fwd_out", fwd_out, f32),
        ("boundary_t", boundary_t, f32), ("suffix", suffix, f32)),
        chunk, tile_px)
    if cot.shape != (num_tiles, 5, p) or fwd_out.shape != (num_tiles, 5, p):
        raise ValueError("cot and fwd_out must be [T, 5, P]")
    if boundary_t.shape != (n_rows, p) or suffix.shape != (n_rows, p):
        raise ValueError("boundary_t and suffix must be [R, P], R = rows")
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    if on_cpu:
        return pass2_reference(data, starts, counts, blk_off, row_tile, cot,
                               fwd_out, boundary_t, suffix, **kw)
    lib = _load()
    # zeros: positions outside every tile's range are never written
    grads = torch.zeros(FEAT, data.shape[1], dtype=f32, device=data.device)
    with torch.cuda.device(data.device):
        err = lib.pairs_pass2(
            data.data_ptr(), data.shape[1], starts.data_ptr(),
            counts.data_ptr(), blk_off.data_ptr(), row_tile.data_ptr(),
            n_rows, cot.data_ptr(), fwd_out.data_ptr(), boundary_t.data_ptr(),
            suffix.data_ptr(), num_tiles, tiles_x, tile_px, chunk,
            grads.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairs_pass2 launch failed: cudaError {err}")
    launch_counts["pairs_pass2"] += 1
    return grads


def fold_reference(pair_grads, layout, used):
    """Plain PyTorch version of the layout and fold kernels → [10, N]: each
    emission slot's stream position (``layout.perm`` inverted, plus
    ``layout.shift``), then per Gaussian the gradients at its own slots'
    positions below ``used`` (a 0-dim tensor) and the stream's end, added
    one by one in slot order (its tier-1 slots, then its tier-2 row's),
    from 0."""
    n, m1, m2 = layout.emission
    pc = pair_grads.shape[1]
    dev = pair_grads.device
    out = torch.zeros(pair_grads.shape[0], n, dtype=pair_grads.dtype,
                      device=dev)
    if pc == 0 or n == 0:
        return out
    e = layout.perm.shape[0]
    pos = torch.empty(e, dtype=torch.int64, device=dev)
    pos[layout.perm] = torch.arange(e, device=dev) + layout.shift
    lim = torch.clamp(used.long(), max=pc)
    # each Gaussian's slots' positions, one row each; pc marks no slot
    tier2 = torch.full((n, m2), pc, dtype=torch.int64, device=dev)
    ids = layout.tier2_ids.long()
    full = torch.nonzero(ids < n).flatten()
    tier2[ids[full]] = pos[n * m1:].view(-1, m2)[full]
    rows = torch.cat([pos[:n * m1].view(n, m1), tier2], 1)
    for j in range(rows.shape[1]):
        p = rows[:, j]
        out = torch.where(p < lim, out + pair_grads[:, p.clamp(max=pc - 1)],
                          out)
    return out


def ids_layout(pair_ids, num_gaussians: int):
    """A fold layout for a stream that no binning made (test fixtures):
    every Gaussian in tier 1, its k-th pair in stream order in its slot k.
    Not on any render or training path, which take the binning's."""
    dev = pair_ids.device
    pc = pair_ids.shape[0]
    ids = pair_ids.long()
    per = torch.bincount(ids, minlength=num_gaussians)
    m1 = max(int(per.max()), 1) if per.numel() else 1
    order = torch.sort(ids, stable=True).indices
    first = torch.cumsum(per, 0) - per
    rank = torch.empty(pc, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(pc, device=dev) - first[ids[order]]
    slots = ids * m1 + rank
    free = torch.ones(num_gaussians * m1, dtype=torch.bool, device=dev)
    free[slots] = False
    perm = torch.cat([slots, torch.nonzero(free).flatten()])
    return binning.FoldLayout(perm, torch.empty(0, dtype=torch.int32,
                                                device=dev),
                              (num_gaussians, m1, 1))


def _check_layout(layout, num_gaussians: int, pc: int, dev):
    """The layout's tensors and emission as the fold kernels read them."""
    if layout is None:
        raise ValueError("fold_to_gaussians: a CUDA call needs the binning's "
                         "layout (PairBins.fold_layout)")
    n, m1, m2 = layout.emission
    perm, rows = layout.perm, layout.tier2_ids
    if perm.dtype != torch.int64 or rows.dtype != torch.int32 or not (
            perm.is_contiguous() and rows.is_contiguous()):
        raise ValueError("layout: perm must be a contiguous int64 tensor and "
                         "tier2_ids a contiguous int32 one")
    if perm.device != dev or rows.device != dev:
        raise ValueError(f"layout: tensors must be on {dev}")
    e = perm.shape[0]
    if (n != num_gaussians or rows.dim() != 1 or m1 < 1 or m2 < 1
            or e != n * m1 + rows.shape[0] * m2
            or not 0 <= layout.shift < 2 ** 31 - max(e, FEAT * n)
            or pc >= 2 ** 31):
        raise ValueError(f"layout: emission {layout.emission}, {e} slots, "
                         f"shift {layout.shift} do not fit {num_gaussians} "
                         f"Gaussians and a stream of {pc}")


def fold_to_gaussians(pair_grads, pair_ids, num_gaussians: int, used=None,
                      layout=None):
    """The fold's wrapper: per-pair gradients [10, Pc] → per-Gaussian
    [10, N], each Gaussian's sum over its pairs taken in stream order from
    0, so the result depends only on the stream (the TPU version's
    ``.at[].add``, pallas_backward.py:341, fixes no order). On CPU tensors
    it is one ``index_add_`` over ``pair_ids``, which adds serially in
    stream order. On CUDA tensors it launches the layout kernel and the
    fold kernel over ``layout`` (``binning.FoldLayout``: which emission
    slots are each Gaussian's and where the sort put them), or raises;
    ``pair_ids`` is not read there.

    ``used`` (a 0-dim int32 tensor, the end of the last tile's range)
    leaves the stream's tail out: its gradients are 0, and adding a +0.0
    leaves a sum's bits as they are, so the result is the same with or
    without. The kernels need it: the slots that the binning culled or
    left unused sort into that tail, and past ``used`` they are no
    Gaussian's pairs."""
    if pair_grads.dtype != torch.float32 or not pair_grads.is_contiguous():
        raise ValueError("fold_to_gaussians: pair_grads must be a contiguous "
                         f"torch.float32 tensor, got {pair_grads.dtype}")
    if pair_grads.dim() != 2 or pair_ids.shape != (pair_grads.shape[1],):
        raise ValueError("pair_grads must be [F, Pc] and pair_ids [Pc]")
    dev = pair_grads.device
    if dev.type == "cpu" and pair_ids.device.type == "cpu":
        out = torch.zeros(pair_grads.shape[0], num_gaussians,
                          dtype=torch.float32)
        return out.index_add_(1, pair_ids.long(), pair_grads)
    if pair_ids.device != dev or dev.type != "cuda":
        raise ValueError("fold_to_gaussians: both tensors must share one "
                         f"CUDA device, got {dev} and {pair_ids.device}")
    pc = pair_grads.shape[1]
    if pair_grads.shape[0] != FEAT:
        raise ValueError(f"pair_grads must be [{FEAT}, Pc]")
    _check_layout(layout, num_gaussians, pc, dev)
    if used is None or used.shape != () or used.device != dev \
            or used.dtype != torch.int32:
        raise ValueError(f"used must be a 0-dim int32 tensor on {dev}")
    _, m1, m2 = layout.emission
    pos = torch.empty(layout.perm.shape[0], dtype=torch.int32, device=dev)
    # the layout kernel writes its zeros
    out = torch.empty(FEAT, num_gaussians, dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.pairs_fold(
            pair_grads.data_ptr(), pc, layout.perm.data_ptr(),
            layout.perm.shape[0], layout.shift, layout.tier2_ids.data_ptr(),
            layout.tier2_ids.shape[0], num_gaussians, m1, m2,
            used.data_ptr(), pos.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairs_fold launch failed: cudaError {err}")
    launch_counts["pairs_fold"] += 1
    return out


def stream_backward(data, pair_ids, starts, counts, cot, fwd_out,
                    num_gaussians: int, *, tiles_x: int, tile_px: int,
                    chunk: int, rows=None, layout=None):
    """Pass 1 → pass 2 → fold; returns the per-Gaussian cotangents [10, N]
    of (mean2d x, y, conic a, b, c, opacity, r, g, b, depth). ``rows`` is
    what the forward handed over: ``(blk_off, row_tile, boundary_t)``;
    ``layout`` is the binning's (``fold_to_gaussians``; CUDA tensors need
    it)."""
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    if rows is None:
        blk_off, row_tile, _ = block_rows(starts, counts, chunk,
                                          data.shape[1])
        boundary_t = None
    else:
        blk_off, row_tile, boundary_t = rows
    boundary_t, suffix = pairs_pass1(
        data, starts, counts, blk_off, row_tile.shape[0], cot,
        boundary_t=boundary_t, row_tile=row_tile, **kw)
    pair_grads = pairs_pass2(data, starts, counts, blk_off, row_tile, cot,
                             fwd_out, boundary_t, suffix, **kw)
    used = (starts + counts).max()
    return fold_to_gaussians(pair_grads, pair_ids, num_gaussians, used=used,
                             layout=layout)


def image_to_tiles(x, tiles_x: int, tiles_y: int, tile_px: int):
    """[H, W, ...] → [T, P, ...] tile-major, zero-padded to whole tiles (the
    inverse of ``pairs_composite.untile``)."""
    h, w = x.shape[:2]
    trailing = tuple(x.shape[2:])
    xp = x.new_zeros((tiles_y * tile_px, tiles_x * tile_px) + trailing)
    xp[:h, :w] = x
    xp = xp.reshape((tiles_y, tile_px, tiles_x, tile_px) + trailing)
    return xp.transpose(1, 2).reshape(
        (tiles_y * tiles_x, tile_px * tile_px) + trailing)


class _StreamComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean2d, conic, rgb, depth, opac, pair_ids, starts,
                counts, geom, layout):
        height, width, tiles_x, tiles_y, tile_px, chunk = geom
        data = PC.assemble_stream_data(pair_ids, mean2d, conic, rgb, depth,
                                       opac)
        blk_off, row_tile, n_rows = block_rows(starts, counts, chunk,
                                               data.shape[1])
        out, boundary_t = PC.composite_pairs_stream(
            data, starts, counts, tiles_x=tiles_x, tile_px=tile_px,
            chunk=chunk, boundary_rows=(blk_off, n_rows), row_tile=row_tile)
        ctx.save_for_backward(data, pair_ids, starts, counts, out, blk_off,
                              row_tile, boundary_t)
        ctx.geom = geom
        ctx.layout = layout
        ctx.num_gaussians = mean2d.shape[0]
        g = (tiles_x, tiles_y, tile_px, height, width)
        return (PC.untile(out[:, 0:3].transpose(1, 2), *g),
                PC.untile(out[:, 3], *g), PC.untile(out[:, 4], *g))

    @staticmethod
    def backward(ctx, d_color, d_depth, d_tfin):
        (data, pair_ids, starts, counts, out, blk_off, row_tile,
         boundary_t) = ctx.saved_tensors
        height, width, tiles_x, tiles_y, tile_px, chunk = ctx.geom
        cot_img = torch.cat([d_color, d_depth[..., None], d_tfin[..., None]],
                            dim=-1).float()  # [H, W, 5]
        cot = image_to_tiles(cot_img, tiles_x, tiles_y, tile_px).transpose(
            1, 2).contiguous()  # [T, 5, P]
        g = stream_backward(data, pair_ids, starts, counts, cot, out,
                            ctx.num_gaussians, tiles_x=tiles_x,
                            tile_px=tile_px, chunk=chunk,
                            rows=(blk_off, row_tile, boundary_t),
                            layout=ctx.layout)
        return (g[0:2].T, g[2:5].T, g[6:9].T, g[9], g[5],
                None, None, None, None, None)


def stream_composite(mean2d, conic, rgb, depth, opac, pair_ids, starts,
                     counts, *, height: int, width: int, tiles_x: int,
                     tiles_y: int, tile_px: int, chunk: int, layout=None):
    """Differentiable pair-stream compositing → (color [H, W, 3], depth
    [H, W], final_T [H, W]) over a zero background. Forward: the compositing
    kernel; backward: the backward kernels and the fold (plain versions on
    the CPU). ``starts``/``counts`` are contiguous int32 [T]; ``layout`` is
    the binning's ``FoldLayout`` of the stream, which the fold kernel needs
    on a card."""
    return _StreamComposite.apply(
        mean2d, conic, rgb, depth, opac, pair_ids, starts, counts,
        (height, width, tiles_x, tiles_y, tile_px, chunk), layout)
