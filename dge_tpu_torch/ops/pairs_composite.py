"""Pair-stream compositing: the CUDA kernels' wrappers, their plain
PyTorch versions, and the stream assembly.

JAX counterpart: ``dge_tpu/ops/pallas_composite.py`` (``_pairs_kernel``,
``composite_pairs_pallas``, ``assemble_stream_data``). The kernels are
``dge_tpu_torch/csrc/pairs_composite.cu`` (over ``pair_rows_forward.cuh``);
its source note states what they compute, the block rule they share with
the TPU kernel, why the walk splits exactly, and their bounds.

- ``assemble_stream_data`` gathers the 10 per-Gaussian features into stream
  order, ``[10, Pc]``. (The JAX version pads to 16 rows for the TPU's
  sublane tiling; nothing on the GPU needs the 6 zero rows.)
- ``block_rows`` lays the (tile, stream block) rows out compactly; the
  forward's two kernels and the backward's all work on them.
- ``composite_pairs_reference`` is the plain version of the whole function:
  a loop over the chunk-aligned stream blocks with ``torch.cumprod`` inside
  a block, over groups of tiles to bound memory. The plain versions here and
  in ``pairs_backward`` / ``composite`` sum over pairs and pixels with
  ``ordered_sum`` (and multiply with ``ordered_prod``), so that they repeat
  their bits from call to call.
- ``rows_forward`` (row kernel → scratch ``[R, 7, P]``, each row as if
  entered with T = 1, and a keep mask, one bit per (row, 32 pixels, pair))
  and ``rows_combine`` (combine kernel → ``[T, 5, P]`` and optionally
  ``boundary_T``) are the two kernels' wrappers, with plain
  versions ``rows_forward_reference`` and ``rows_combine_reference``
  (``check_rows`` holds what the row kernels take; the launches go through
  ``cuda_build.launch``);
  ``log_space=True`` selects the log-space arm K5 of tools/proto_logdot.py
  (scratch ``[R, 8, P]``). ``combine_cases`` counts how often each of the
  combine's three cases fires.
- ``composite_pairs_stream`` is K1's wrapper: on CUDA tensors it launches
  the row kernel and the combine kernel, or raises; on CPU tensors it takes
  ``composite_pairs_reference``. With ``boundary_rows=(blk_off, n_rows)``
  both also return ``boundary_T`` ``[n_rows, P]``, the committed
  transmittance entering each row, from which the backward starts every row.
- ``composite_pairs`` is the image-level function: assemble, composite
  through the wrapper or the plain version, add ``bg·T``, untile.

All versions write ``[T, 5, P]`` (rows r, g, b, depth, final T) and visit
each chunk-aligned block of a tile's range once. The TPU wrapper clamps its
block index to the stream's last block, so a tile whose range reaches that
block re-runs it; the port does not copy that (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dge_tpu_torch.ops import cuda_build

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
FEAT = 10  # mx, my, conic a, b, c, opacity, r, g, b, depth

# the row kernel stages a row in 48 bytes a pair of shared memory: 48 KB,
# the default a block may have, at chunk 1024
MAX_CHUNK = 1024
ROW_FIELDS = 7  # scratch per (row, pixel): cp_last, cp_first, j0, L (4)

# per form (log_space): C entries, launch counters
_FORMS = {False: ("pairs_rows_forward", "pairs_rows_combine",
                  "pairs_composite", "pairs_composite_combine"),
          True: ("logdot_rows_forward", "logdot_rows_combine",
                 "pairs_logdot", "pairs_logdot_combine")}


def assemble_stream_data(pair_ids, mean2d, conic, rgb, depth, opac
                         ) -> torch.Tensor:
    """Gather per-Gaussian features into pair-stream order → [FEAT, Pc]."""
    feat = torch.stack(
        [
            mean2d[:, 0], mean2d[:, 1],
            conic[:, 0], conic[:, 1], conic[:, 2],
            opac,
            rgb[:, 0], rgb[:, 1], rgb[:, 2],
            depth,
        ],
        dim=0,
    ).float()
    return feat.index_select(1, pair_ids.long()).contiguous()


def block_rows(starts, counts, chunk: int, pc: int
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Compact row layout of the (tile, stream block) pairs.

    A tile with range [start, start + count) touches the chunk-aligned
    blocks start//chunk .. (end-1)//chunk. Returns ``blk_off`` [T] int32 (the
    first row of each tile: the exclusive prefix sum of the block counts),
    ``row_tile`` [R] int32 (the tile of each row; T marks an unused row) and
    R = ceil(pc/chunk) + T, an upper bound of the rows in use that needs no
    host sync (the tiles' ranges are disjoint and lie in [0, pc))."""
    num_tiles = starts.shape[0]
    # in int32 throughout (pc < 2**31): few small launches on the render path
    nblk = ((starts + counts - 1) // chunk - starts // chunk + 1) * (counts > 0)
    cum = torch.cumsum(nblk, 0, dtype=torch.int32)
    n_rows = -(-pc // chunk) + num_tiles
    row_tile = torch.searchsorted(
        cum, torch.arange(n_rows, dtype=torch.int32, device=starts.device),
        right=True, out_int32=True)
    return cum - nblk, row_tile, n_rows


def pixel_coords(tiles, tiles_x: int, tile_px: int, dev):
    """Pixel coordinates of ``tiles`` [G] -> (px, py), each [G, 1, P]."""
    pid = torch.arange(tile_px * tile_px, device=dev)
    px = ((tiles % tiles_x) * tile_px)[:, None] + pid[None, :] % tile_px
    py = ((tiles // tiles_x) * tile_px)[:, None] + pid[None, :] // tile_px
    return px.float()[:, None, :], py.float()[:, None, :]


def ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in one fixed order: the last element of
    ``torch.cumsum``, a serial scan of each line (on the CPU in double; on a
    card, along any but the innermost dim, in the kernels' own pair order).
    The plain versions reduce over pairs and pixels with it: PyTorch's
    ``sum`` / ``prod`` / ``einsum`` choose how they split and group a
    reduction at run time, so their bits need not repeat from call to
    call."""
    if x.shape[dim] == 0:
        return x.sum(dim)
    return torch.cumsum(x, dim).select(dim, -1)


def ordered_prod(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``ordered_sum`` with products (``torch.cumprod``)."""
    if x.shape[dim] == 0:
        return x.prod(dim)
    return torch.cumprod(x, dim).select(dim, -1)


def _block_alpha(data, idx, in_range, px, py):
    """Features of the stream positions ``idx`` [G, C] (``f`` [FEAT, G, C,
    1]), their alpha at the pixels ``px``/``py`` [G, 1, P] and whether each
    (pair, pixel) is kept, both [G, C, P]."""
    f = data[:, idx.clamp(0, data.shape[1] - 1)][..., None]
    dx = f[0] - px
    dy = f[1] - py
    power = -0.5 * (f[2] * dx * dx + f[4] * dy * dy) - f[3] * dx * dy
    alpha = torch.clamp(f[5] * torch.exp(power), max=ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_EPS) & in_range[..., None]
    return f, alpha, keep


def _prefix(one_minus, log_space: bool):
    """The inclusive in-block prefix of transmittance over dim 1."""
    if log_space:
        return torch.exp(torch.cumsum(torch.log(one_minus), dim=1))
    return torch.cumprod(one_minus, dim=1)


def _block_walk(f, alpha, keep, trans, log_space: bool, stop: float = T_EPS):
    """One block entered at ``trans`` [G, 1, P] → (rgbd added [G, 4, P],
    the factor [G, 1, P] that takes ``trans`` to the committed T); a pair
    is applied while ``trans·cp >= stop``."""
    eff = torch.where(keep, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - eff
    cp = _prefix(one_minus, log_space)  # inclusive, [G, C, P]
    applied = trans * cp >= stop
    w = torch.where(applied, eff * trans * (cp / one_minus),
                    torch.zeros_like(cp))
    add = torch.stack([ordered_sum(w * f[6 + r], 1) for r in range(4)],
                      dim=1)
    return add, torch.where(applied, cp, torch.ones_like(cp)).amin(
        dim=1, keepdim=True)


def _tile_blocks(starts, counts, chunk: int):
    """Per tile: first stream position, end, first block, block count."""
    s = starts.long()
    e = s + counts.long()
    first = s // chunk
    nblk = torch.where(counts > 0, (e - 1) // chunk - first + 1,
                       torch.zeros_like(first))
    return s, e, first, nblk


def composite_pairs_reference(data, starts, counts, *, tiles_x: int,
                              tile_px: int, chunk: int,
                              log_prefix: bool = False,
                              boundary_rows: Optional[Tuple[torch.Tensor,
                                                            int]] = None,
                              stop: float = T_EPS):
    """Plain PyTorch version of the whole forward, on any device → [T, 5, P],
    or (that, boundary_T [n_rows, P]) with ``boundary_rows=(blk_off,
    n_rows)`` (rows not in use are 0).

    Follows the block rule literally: blocks at absolute stream offsets
    ``k·chunk``; inside a block an inclusive ``torch.cumprod`` of ``1-eff``,
    a pair applied iff ``T_block·cp >= 1e-4``, ``w = eff·T_block·cp/(1-eff)``;
    the committed T after the block is ``T_block·cp`` at its last applied
    pair. ``log_prefix`` forms ``cp`` as ``exp(cumsum(log(1-eff)))`` instead:
    the plain version of the log-space kernel of tools/proto_logdot.py.
    ``stop`` replaces the early stop's 1e-4: a check moves it a little to
    find the pixels where rounding decides a refusal."""
    dev = data.device
    num_tiles = starts.shape[0]
    p = tile_px * tile_px
    out = torch.zeros(num_tiles, 5, p, dtype=torch.float32, device=dev)
    out[:, 4] = 1.0
    boundary_t = None
    if boundary_rows is not None:
        blk_off, n_rows = boundary_rows
        boundary_t = torch.zeros(n_rows, p, dtype=torch.float32, device=dev)

    def result():
        return out if boundary_t is None else (out, boundary_t)

    live = torch.nonzero(counts > 0).flatten()
    if data.shape[1] == 0 or live.numel() == 0:
        return result()
    starts, ends, first, nblk = _tile_blocks(starts, counts, chunk)
    slot = torch.arange(chunk, device=dev)
    # tiles per group: keep each [G, chunk, P] temporary near 2^23 floats
    group = max(1, (1 << 23) // (chunk * p))
    for g0 in range(0, live.numel(), group):
        tiles = live[g0:g0 + group]
        px, py = pixel_coords(tiles, tiles_x, tile_px, dev)
        s, e, fb, nb = starts[tiles], ends[tiles], first[tiles], nblk[tiles]
        trans = torch.ones(tiles.numel(), 1, p, device=dev)
        acc = 0.0
        for k in range(int(nb.max())):
            if boundary_t is not None:
                has = k < nb
                boundary_t[(blk_off[tiles].long() + k)[has]] = \
                    trans[has, 0].detach()
            idx = (fb + k)[:, None] * chunk + slot[None, :]  # [G, C]
            in_range = (idx >= s[:, None]) & (idx < e[:, None])
            add, factor = _block_walk(*_block_alpha(data, idx, in_range, px,
                                                    py), trans, log_prefix,
                                      stop)
            acc = acc + add
            trans = trans * factor
        out[tiles, 0:4] = acc
        out[tiles, 4] = trans[:, 0]
    return result()


def mask_shape(n_rows: int, tile_px: int, chunk: int) -> Tuple[int, int, int]:
    """[R, G, W]: groups of 32 pixels (four per 128), words of 32 pairs."""
    return (n_rows, 4 * -(-tile_px * tile_px // 128), -(-chunk // 32))


def pixel_groups(p: int, dev=None) -> torch.Tensor:
    """The keep-mask group of each of a tile's ``p`` pixels, [P] int64.

    The row kernel holds pixels 4·tid .. 4·tid + 3 in thread tid; group
    4·warp + a is lanes 2a and 2a + 1 of each eight of the warp (in a tile
    32 pixels wide, an 8x4 patch): group(q) = 4·(q // 128) + (q // 8) % 4."""
    q = torch.arange(p, device=dev)
    return 4 * (q // 128) + (q // 8) % 4


def _pack_bits(bits):
    """[..., W·32] bool → [..., W] int32, bit b of word w = bits[32w + b]."""
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64,
                           device=bits.device)
    words = (bits.reshape(bits.shape[:-1] + (-1, 32)).long()
             * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def rows_forward_reference(data, starts, counts, blk_off, row_tile, *,
                           tiles_x: int, tile_px: int, chunk: int,
                           log_space: bool = False):
    """Plain PyTorch version of the row kernel → (scratch [R, 7, P] (8 with
    ``log_space``), keep mask [R, G, W] int32). Per (tile, stream block) row
    and pixel, walked as if entered with T = 1: ``cp_last``, ``cp_first``,
    ``j0`` (the first kept pair's index from the row's first stream
    position, or the row's length), ``L`` (r, g, b, depth: the sum of
    ``eff·cp/(1-eff)·colour`` over the applied pairs) and, in log space,
    ``cp_min``. The walk stops at the first kept pair whose ``cp`` falls
    below 1e-4: that pair and all later ones add nothing to ``L``, and
    ``cp_last`` (``cp_min``) is that pair's ``cp``. Bit j of a (row, group of
    32 pixels: ``pixel_groups``) mask word is set iff some pixel of the
    group keeps pair j before its walk has stopped. Unused rows are 0."""
    num_tiles = starts.shape[0]
    p = tile_px * tile_px
    n_rows = row_tile.shape[0]
    scratch = torch.zeros(n_rows, ROW_FIELDS + int(log_space), p,
                          dtype=torch.float32, device=data.device)
    _, groups, words = mask_shape(n_rows, tile_px, chunk)
    mask = torch.zeros(n_rows, groups, words, dtype=torch.int32,
                       device=data.device)
    rows = torch.nonzero(row_tile < num_tiles).flatten()
    if data.shape[1] == 0 or rows.numel() == 0:
        return scratch, mask
    s_all, e_all, _, _ = _tile_blocks(starts, counts, chunk)
    slot = torch.arange(chunk, device=data.device)
    group = max(1, (1 << 22) // (chunk * p))
    for g0 in range(0, rows.numel(), group):
        r = rows[g0:g0 + group]
        tiles = row_tile[r].long()
        s, e = s_all[tiles], e_all[tiles]
        base = (s // chunk + r - blk_off[tiles].long()) * chunk
        lo = torch.maximum(s, base)
        n = torch.minimum(e, base + chunk) - lo
        idx = base[:, None] + slot[None, :]
        in_range = (idx >= s[:, None]) & (idx < e[:, None])
        px, py = pixel_coords(tiles, tiles_x, tile_px, data.device)
        f, alpha, keep = _block_alpha(data, idx, in_range, px, py)
        eff = torch.where(keep, alpha, torch.zeros_like(alpha))
        one_minus = 1.0 - eff
        cp = _prefix(one_minus, log_space)  # [G, C, P]
        stop = keep & (cp < T_EPS)
        n_stop = torch.cumsum(stop.int(), dim=1)
        first_stop = stop & (n_stop == 1)
        stopped = n_stop[:, -1] > 0
        w = torch.where(keep & (n_stop == 0), eff * (cp / one_minus),
                        torch.zeros_like(cp))
        cp_last = torch.where(
            stopped, torch.where(first_stop, cp, torch.zeros_like(cp)).sum(1),
            cp[:, -1])
        any_keep = keep.any(dim=1)
        j0_slot = keep.int().argmax(dim=1)  # [G, P]
        fields = [
            cp_last,
            torch.where(any_keep, cp.gather(1, j0_slot[:, None, :])[:, 0],
                        torch.ones_like(cp_last)),
            torch.where(any_keep, j0_slot - (lo - base)[:, None],
                        n[:, None]).float()]
        fields += [ordered_sum(w * f[6 + c], 1) for c in range(4)]
        if log_space:
            fields.append(torch.where((n_stop == 0) | first_stop, cp,
                                      torch.full_like(cp, float("inf"))
                                      ).amin(dim=1))
        scratch[r] = torch.stack(fields, dim=1)
        # the mask: slots shifted to the row's own index j = slot - (lo -
        # base)
        live_keep = keep & (n_stop - stop.int() == 0)  # [G, C, P]
        by_group = torch.zeros(r.numel(), chunk, groups, dtype=torch.int32,
                               device=data.device).index_add_(
            2, pixel_groups(p, data.device), live_keep.int()) > 0
        j = torch.arange(words * 32, device=data.device)
        slot_of = j[None, :] + (lo - base)[:, None]  # [G, W·32]
        bits = by_group.gather(1, slot_of.clamp(max=chunk - 1)[..., None]
                               .expand(-1, -1, groups))
        bits &= (j[None, :] < n[:, None])[..., None]
        mask[r] = _pack_bits(bits.transpose(1, 2))
    return scratch, mask


def rows_combine_reference(scratch, mask, data, starts, counts, blk_off, *,
                           tiles_x: int, tile_px: int, chunk: int,
                           log_space: bool = False, boundary: bool = False):
    """Plain PyTorch version of the combine kernel → [T, 5, P], or (that,
    boundary_T [R, P]) with ``boundary`` (rows not in use are 0): per tile
    over its rows in order from T = 1, with the row kernel's ``scratch``:
    every kept pair applied (``T·cp_last >= 1e-4``; log space ``T·cp_min``):
    ``rgbd += T·L``, ``T = T·cp_last``; none applied (``T·cp_first <
    1e-4``): nothing; else the row's block walked from T as
    ``composite_pairs_reference`` walks it (whole: the keep ``mask`` only
    spares the kernel work and is not read here)."""
    dev = data.device
    num_tiles = starts.shape[0]
    n_rows, _, p = scratch.shape
    out = torch.zeros(num_tiles, 5, p, dtype=torch.float32, device=dev)
    out[:, 4] = 1.0
    boundary_t = (torch.zeros(n_rows, p, dtype=torch.float32, device=dev)
                  if boundary else None)
    live = torch.nonzero(counts > 0).flatten()
    if data.shape[1] > 0 and live.numel() > 0:
        starts_l, ends, first, nblk = _tile_blocks(starts, counts, chunk)
        slot = torch.arange(chunk, device=dev)
        group = max(1, (1 << 23) // (chunk * p))
        for g0 in range(0, live.numel(), group):
            tiles = live[g0:g0 + group]
            px, py = pixel_coords(tiles, tiles_x, tile_px, dev)
            s, e, fb, nb = (starts_l[tiles], ends[tiles], first[tiles],
                            nblk[tiles])
            row0 = blk_off[tiles].long()
            trans = torch.ones(tiles.numel(), p, device=dev)
            acc = torch.zeros(tiles.numel(), 4, p, device=dev)
            for k in range(int(nb.max())):
                has = (k < nb)[:, None]
                if boundary_t is not None:
                    boundary_t[(row0 + k)[has[:, 0]]] = trans[has[:, 0]]
                sc = scratch[(row0 + k).clamp(max=n_rows - 1)]
                cp_last = sc[:, 0]
                every = has & (trans * (sc[:, 7] if log_space else cp_last)
                               >= T_EPS)
                walk = has & ~every & (trans * sc[:, 1] >= T_EPS)
                new_acc = torch.where(every[:, None],
                                      acc + trans[:, None] * sc[:, 3:7], acc)
                new_trans = torch.where(every, trans * cp_last, trans)
                wt = torch.nonzero(walk.any(dim=1)).flatten()
                if wt.numel():
                    idx = (fb[wt] + k)[:, None] * chunk + slot[None, :]
                    in_range = (idx >= s[wt, None]) & (idx < e[wt, None])
                    add, factor = _block_walk(
                        *_block_alpha(data, idx, in_range, px[wt], py[wt]),
                        trans[wt, None], log_space)
                    wm = walk[wt]
                    new_acc[wt] = torch.where(wm[:, None], acc[wt] + add,
                                              new_acc[wt])
                    new_trans[wt] = torch.where(wm, trans[wt] * factor[:, 0],
                                                new_trans[wt])
                acc, trans = new_acc, new_trans
            out[tiles, 0:4] = acc
            out[tiles, 4] = trans
    return out if boundary_t is None else (out, boundary_t)


def combine_cases(scratch, boundary_t, row_tile, num_tiles: int, *,
                  log_space: bool = False) -> dict:
    """How often each case of the combine fired over the rows in use, from
    the row kernel's scratch and the T entering each row: ``empty`` (no kept
    pair), ``all`` (every kept pair applied), ``none`` (the first kept pair
    refused) and ``walk`` (the row walked again from the entering T), in
    (row, pixel) visits."""
    used = row_tile < num_tiles
    sc, tb = scratch[used], boundary_t[used]
    empty = sc[:, 1] == 1.0
    every = ~empty & (tb * sc[:, 7 if log_space else 0] >= T_EPS)
    none = ~empty & ~every & ~(tb * sc[:, 1] >= T_EPS)
    walk = ~empty & ~every & ~none
    return {k: int(v.sum()) for k, v in (("empty", empty), ("all", every),
                                         ("none", none), ("walk", walk))}


def check_rows(owner: str, tensors, data, num_tiles: int, tile_px: int,
               chunk: int) -> bool:
    """The row kernels' checks: ``tensors`` (``cuda_build.check_tensors``),
    ``data`` [FEAT, Pc], the row offsets [T] and, on a card, the tile and
    chunk limits and int32 stream offsets. Returns True when every tensor
    is on the CPU (the plain version runs)."""
    on_cpu = cuda_build.check_tensors(owner, tensors)
    if data.dim() != 2 or data.shape[0] != FEAT:
        raise ValueError(f"data must be [{FEAT}, Pc], got {tuple(data.shape)}")
    for what, t, _, _ in tensors:
        if what in ("starts", "counts", "blk_off") and \
                t.shape != (num_tiles,):
            raise ValueError("starts, counts and blk_off must be [T] each")
    if not on_cpu:
        check_limits(tile_px, chunk, MAX_CHUNK)
        if data.shape[1] >= 2 ** 31:
            raise ValueError("stream too long for int32 offsets")
    return on_cpu


def check_limits(tile_px: int, chunk: int, max_chunk: int) -> None:
    """A row kernel's block: four pixels a thread, 256 threads, and a
    chunk of at most ``max_chunk`` pairs staged in shared memory."""
    if not 1 <= tile_px <= 32:
        raise ValueError(f"tile_px {tile_px}: four pixels a thread, 256 "
                         "threads a block need tile_px**2 <= 1024")
    if not 1 <= chunk <= max_chunk:
        raise ValueError(f"chunk {chunk} outside [1, {max_chunk}]")


def rows_forward(data, starts, counts, blk_off, row_tile, *, tiles_x: int,
                 tile_px: int, chunk: int, log_space: bool = False):
    """The row kernel's wrapper → (scratch [R, 7, P] (8 with
    ``log_space``), keep mask [R, G, W] int32; rows not in use are left
    unwritten on the card). On CUDA tensors it launches K1's row kernel
    (K5's with ``log_space``), or raises; on CPU tensors it takes
    ``rows_forward_reference``."""
    f32, i32 = torch.float32, torch.int32
    num_tiles = starts.shape[0]
    on_cpu = check_rows("rows_forward", (
        ("data", data, f32, None), ("starts", starts, i32, None),
        ("counts", counts, i32, None), ("blk_off", blk_off, i32, None),
        ("row_tile", row_tile, i32, None)), data, num_tiles, tile_px, chunk)
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk,
              log_space=log_space)
    if on_cpu:
        return rows_forward_reference(data, starts, counts, blk_off,
                                      row_tile, **kw)
    entry, _, counter, _ = _FORMS[log_space]
    n_rows = row_tile.shape[0]
    scratch = torch.empty(n_rows, ROW_FIELDS + int(log_space),
                          tile_px * tile_px, dtype=f32, device=data.device)
    mask = torch.empty(mask_shape(n_rows, tile_px, chunk), dtype=i32,
                       device=data.device)
    cuda_build.launch(entry, counter, data.device, data, data.shape[1],
                      starts, counts, blk_off, row_tile, n_rows, num_tiles,
                      tiles_x, tile_px, chunk, scratch, mask)
    return scratch, mask


def rows_combine(scratch, mask, data, starts, counts, blk_off, *,
                 tiles_x: int,
                 tile_px: int, chunk: int, log_space: bool = False,
                 boundary: bool = False):
    """The combine kernel's wrapper → [T, 5, P], or (that, boundary_T
    [R, P]) with ``boundary`` (rows not in use are left unwritten on the
    card). On CUDA tensors it launches K1's combine kernel (K5's with
    ``log_space``), or raises; on CPU tensors it takes
    ``rows_combine_reference``."""
    f32, i32 = torch.float32, torch.int32
    num_tiles = starts.shape[0]
    on_cpu = check_rows("rows_combine", (
        ("scratch", scratch, f32, None), ("mask", mask, i32, None),
        ("data", data, f32, None), ("starts", starts, i32, None),
        ("counts", counts, i32, None), ("blk_off", blk_off, i32, None)),
        data, num_tiles, tile_px, chunk)
    p = tile_px * tile_px
    if scratch.dim() != 3 or scratch.shape[1:] != (
            ROW_FIELDS + int(log_space), p):
        raise ValueError(f"scratch must be [R, {ROW_FIELDS + int(log_space)}"
                         f", P], got {tuple(scratch.shape)}")
    if mask.shape != mask_shape(scratch.shape[0], tile_px, chunk):
        raise ValueError(f"mask must be [R, G, W], got {tuple(mask.shape)}")
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk,
              log_space=log_space, boundary=boundary)
    if on_cpu:
        return rows_combine_reference(scratch, mask, data, starts, counts,
                                      blk_off, **kw)
    _, entry, _, counter = _FORMS[log_space]
    out = torch.empty(num_tiles, 5, p, dtype=f32, device=data.device)
    boundary_t = (torch.empty(scratch.shape[0], p, dtype=f32,
                              device=data.device) if boundary else None)
    cuda_build.launch(entry, counter, data.device, scratch, mask, data,
                      data.shape[1], starts, counts, blk_off, num_tiles,
                      tiles_x, tile_px, chunk, out, boundary_t)
    return out if boundary_t is None else (out, boundary_t)


def composite_rows(data, starts, counts, *, tiles_x: int, tile_px: int,
                   chunk: int, log_space: bool = False,
                   boundary_rows: Optional[Tuple[torch.Tensor, int]] = None,
                   row_tile: Optional[torch.Tensor] = None):
    """The row kernel then the combine kernel on CUDA tensors → [T, 5, P],
    or (that, boundary_T [n_rows, P]) with ``boundary_rows=(blk_off,
    n_rows)``. ``row_tile`` is ``block_rows``' when the caller has it."""
    if boundary_rows is None or row_tile is None:
        blk_off, rt, n_rows = block_rows(starts, counts, chunk, data.shape[1])
        row_tile = rt if row_tile is None else row_tile
    if boundary_rows is not None:
        blk_off, n_rows = boundary_rows
    if row_tile.shape != (n_rows,):
        raise ValueError(f"row_tile must be [{n_rows}] (block_rows)")
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk,
              log_space=log_space)
    scratch, mask = rows_forward(data, starts, counts, blk_off, row_tile,
                                 **kw)
    return rows_combine(scratch, mask, data, starts, counts, blk_off,
                        boundary=boundary_rows is not None, **kw)


def composite_pairs_stream(data, starts, counts, *, tiles_x: int,
                           tile_px: int, chunk: int,
                           boundary_rows: Optional[Tuple[torch.Tensor,
                                                         int]] = None,
                           row_tile: Optional[torch.Tensor] = None):
    """K1's wrapper → [T, 5, P], or (that, boundary_T [n_rows, P]) with
    ``boundary_rows=(blk_off, n_rows)`` (the combine kernel leaves rows not
    in use unwritten). On CUDA tensors it launches the row kernel and the
    combine kernel, or raises on anything they do not take; it never falls
    back. On CPU tensors, where no kernel runs, it takes the plain version.
    ``row_tile`` is ``block_rows``' when the caller has it."""
    num_tiles = starts.shape[0]
    checked = [("data", data, torch.float32, None),
               ("starts", starts, torch.int32, None),
               ("counts", counts, torch.int32, None)]
    if boundary_rows is not None:
        checked.append(("blk_off", boundary_rows[0], torch.int32, None))
    if check_rows("composite_pairs_stream", checked, data, num_tiles, tile_px,
                  chunk):
        return composite_pairs_reference(data, starts, counts, tiles_x=tiles_x,
                                         tile_px=tile_px, chunk=chunk,
                                         boundary_rows=boundary_rows)
    return composite_rows(data, starts, counts, tiles_x=tiles_x,
                          tile_px=tile_px, chunk=chunk,
                          boundary_rows=boundary_rows, row_tile=row_tile)


def untile(x: torch.Tensor, tiles_x: int, tiles_y: int, tile_px: int,
           height: int, width: int) -> torch.Tensor:
    """[T, P, ...] tile-major pixels → [H, W, ...] image."""
    trailing = tuple(x.shape[2:])
    img = x.reshape((tiles_y, tiles_x, tile_px, tile_px) + trailing)
    img = img.transpose(1, 2).reshape(
        (tiles_y * tile_px, tiles_x * tile_px) + trailing)
    return img[:height, :width]


def composite_pairs(
    pair_ids, starts, counts, mean2d, conic, rgb, depth, opac, *,
    height: int, width: int, tiles_x: int, tiles_y: int, tile_px: int,
    bg: torch.Tensor, chunk: int = 128, use_kernel: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (color [H, W, 3], depth [H, W], final_T [H, W]) through the
    kernel's wrapper (``use_kernel``) or the plain version."""
    data = assemble_stream_data(pair_ids, mean2d, conic, rgb, depth, opac)
    starts = starts.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    fn = composite_pairs_stream if use_kernel else composite_pairs_reference
    out = fn(data, starts, counts, tiles_x=tiles_x, tile_px=tile_px,
             chunk=chunk)
    trans = out[:, 4, :]  # [T, P]
    color = out[:, 0:3, :].transpose(1, 2) + trans[..., None] * bg[None, None, :]
    geom = (tiles_x, tiles_y, tile_px, height, width)
    return untile(color, *geom), untile(out[:, 3, :], *geom), untile(trans, *geom)
