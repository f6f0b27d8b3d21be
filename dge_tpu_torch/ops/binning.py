"""Tile binning: duplicate (tile, Gaussian) pairs, sort by
``[tile | quantized depth]`` int32 keys, recover per-tile ranges.

JAX counterpart: ``dge_tpu/ops/binning.py``. Two forms of the result:

- ``bin_gaussians_pairs`` (``binning.py:371-641``, bucketed emission): the
  sorted pair stream itself, for the pair-stream compositors;
- ``bin_gaussians`` (``binning.py:248-347``): capped per-tile lists
  ``[T, K]`` gathered out of the same sort, for the per-tile-list
  compositors and the mask lift; ``bin_gaussians_scan``
  (``binning.py:160-245``) is its prefix-sum oracle.

The reference's dynamic-size pipeline is rasterizer_impl.cu:179-285. The
caps are the same as in the JAX version, so ``pair_ids``, ``starts``,
``counts``, ``lists``, ``spill`` and ``spill_parts`` come out identical for
identical inputs: both sorts are stable sorts on int32, ties keep submission
order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Safety margin on the q <= 2*ln(255*opacity) cull test, as in the JAX
# version: an absolute floor plus a term proportional to the quadratic's
# cancellation magnitude (qabs).
CULL_Q_MARGIN = 1e-3
CULL_Q_REL = 2e-5


class TileBins(NamedTuple):
    """Capped per-tile Gaussian lists."""

    lists: torch.Tensor  # [T, K] int32 per-tile Gaussian lists (depth order)
    counts: torch.Tensor  # [T] int32 number of valid entries (capped at K)
    # [N] int32 depth permutation the lists index into, or None when the
    # lists hold original ids
    order: Optional[torch.Tensor]
    spill: torch.Tensor  # scalar int32 total overflow dropped
    tiles_x: int
    tiles_y: int
    # [4] int32 (slot, cap, tile, stream) attribution of ``spill`` in
    # PairBins.spill_parts' layout (the lists have only the slot and tile
    # caps), or None
    spill_parts: Optional[torch.Tensor] = None


class FoldLayout(NamedTuple):
    """Where each Gaussian's pairs lie in a pair stream, for the ordered
    fold (``pairs_backward.fold_to_gaussians``). The binning emits slot
    ``g*m1 + j`` for the j-th tile of a tier-1 Gaussian g and slot
    ``N*m1 + s*m2 + j`` for the j-th tile of the Gaussian in tier-2 row s;
    one Gaussian's keys share its depth field and rise with its slot, so
    its pairs lie in the stream in slot order. Emission slot ``perm[p]``
    sits at stream position ``p + shift``."""

    perm: torch.Tensor  # [E] int64, the sort's indices
    tier2_ids: torch.Tensor  # [rows] int32 Gaussian of each tier-2 row, >= N
    # for an empty row
    emission: tuple  # (N, m1, m2)
    shift: int = 0  # unused stream positions before the first pair


class PairBins(NamedTuple):
    """The depth-ordered (tile, Gaussian) pair stream."""

    pair_ids: torch.Tensor  # [<= max_pairs] int32 Gaussian ids, tile-major
    starts: torch.Tensor  # [T] int32 stream offset of each tile's range
    counts: torch.Tensor  # [T] int32 (capped at max_per_tile)
    spill: torch.Tensor  # scalar int32
    tiles_x: int
    tiles_y: int
    # [4] int32 (slot, cap, tile, stream): which cap class overflowed —
    # slot = max_tiles_per_gaussian, cap = big_capacity / small_slots,
    # tile = max_per_tile, stream = max_pairs
    spill_parts: torch.Tensor = None
    # 0-dim: the end of the last tile's range before the caps cut it (a
    # tile's range starts after every earlier tile's pairs, capped or not)
    length: torch.Tensor = None
    # the emission behind the stream (FoldLayout), all of it computed for
    # the sort anyway: the sort's indices [E] int64, the Gaussian of each
    # tier-2 row [min(b2, N)] int32 (>= N for an empty row), (N, m1, m2)
    perm: torch.Tensor = None
    tier2_ids: torch.Tensor = None
    emission: tuple = None

    def fold_layout(self, shift: int = 0) -> FoldLayout:
        """The fold's layout of this stream with ``shift`` unused positions
        before its first pair (``render._shift_stream``)."""
        return FoldLayout(self.perm, self.tier2_ids, self.emission, shift)


def _i32(x):
    return x.to(torch.int32)


def tile_rects(mean2d, radius, visible, tile_px, tiles_x, tiles_y):
    """Conservative tile bbox per Gaussian (getRect, auxiliary.h:45-56)."""
    x0 = torch.clamp(torch.floor((mean2d[:, 0] - radius) / tile_px), 0, tiles_x)
    y0 = torch.clamp(torch.floor((mean2d[:, 1] - radius) / tile_px), 0, tiles_y)
    x1 = torch.clamp(
        torch.floor((mean2d[:, 0] + radius + tile_px - 1) / tile_px), 0, tiles_x
    )
    y1 = torch.clamp(
        torch.floor((mean2d[:, 1] + radius + tile_px - 1) / tile_px), 0, tiles_y
    )
    empty = ((x1 - x0) * (y1 - y0)) == 0
    vis = visible & ~empty
    return _i32(x0), _i32(x1), _i32(y0), _i32(y1), vis


def _tile_min_q_T(mean2d, conic, txT, tyT, tile_px):
    """Minimum over a tile's pixel box of the quadratic
    q = a*dx^2 + 2b*dx*dy + c*dy^2, in [M, N] layout; returns (qmin, qabs),
    qabs being the cancellation scale a*u^2 + |2b*u*v| + c*v^2 at the
    chosen minimizer."""
    t = float(tile_px)
    mx = mean2d[None, :, 0]
    my = mean2d[None, :, 1]
    a = conic[None, :, 0]
    b = conic[None, :, 1]
    c = conic[None, :, 2]
    txf = txT.float() * t
    tyf = tyT.float() * t
    u0 = mx - (txf + (t - 1.0))  # dx over the box spans [u0, u1]
    u1 = mx - txf
    v0 = my - (tyf + (t - 1.0))
    v1 = my - tyf
    inside = (u0 <= 0.0) & (0.0 <= u1) & (v0 <= 0.0) & (0.0 <= v1)

    asafe = torch.clamp(a, min=1e-12)
    csafe = torch.clamp(c, min=1e-12)

    def q_pair(u, v):
        cross = 2.0 * b * u * v
        return a * u * u + cross + c * v * v, \
            a * u * u + torch.abs(cross) + c * v * v

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def edge_u(uf):  # u fixed, minimize the 1-D quadratic in v
        return q_pair(uf, clip(-b * uf / csafe, v0, v1))

    def edge_v(vf):
        return q_pair(clip(-b * vf / asafe, u0, u1), vf)

    m, ma = edge_u(u0)
    for cand, ca in (edge_u(u1), edge_v(v0), edge_v(v1)):
        better = cand < m
        m = torch.where(better, cand, m)
        ma = torch.where(better, ca, ma)
    zero = torch.zeros_like(m)
    return (
        torch.where(inside, zero, torch.clamp(m, min=0.0)),
        torch.where(inside, zero, ma),
    )


def _tile_keep_mask_T(mean2d, conic, opacity, txT, tyT, tile_px):
    """keep[j, i]: some pixel of tile (txT, tyT)[j, i] can see Gaussian i at
    alpha >= 1/255 (exact w.r.t. the compositor's alpha skip)."""
    qmin, qabs = _tile_min_q_T(mean2d, conic, txT, tyT, tile_px)
    qcut = 2.0 * torch.log(torch.clamp(opacity, min=1e-12) * 255.0)
    return qmin <= qcut[None, :] + CULL_Q_MARGIN + CULL_Q_REL * qabs


def _cull_valid(mean2d, conic, opacity, x0, y0, w, j, tile_px):
    """Keep-mask [N, M] for slot j of each Gaussian's row-major rect."""
    wsafeT = torch.clamp(w, min=1)[None, :]
    txT = x0[None, :] + j[:, None] % wsafeT
    tyT = y0[None, :] + j[:, None] // wsafeT
    return _tile_keep_mask_T(mean2d, conic, opacity, txT, tyT, tile_px).T


def _compact_tier(
    member, b, m, r_cap, x0, y0, w, cnt, dq, tiles_x, num_tiles, depth_bits,
    mean2d=None, conic=None, opacity=None, tile_px=None,
):
    """Pack the ``member`` Gaussians' ids into ``b`` slots (one 1-D sort,
    member ids first in id order) and emit up to ``m`` tiles each into a
    [min(b, N), m] key grid; with culling inputs, cull-then-compact over up
    to ``r_cap`` rect tiles. Returns (keys, ids, slot_spill, overflowed,
    rows), ``rows`` [min(b, N)] int32 the Gaussian of each row, members in
    id order, then values >= N for the empty rows."""
    dev = cnt.device
    n = cnt.shape[0]
    ids_all = torch.arange(n, dtype=torch.int32, device=dev)
    rank = torch.cumsum(member.to(torch.int32), 0, dtype=torch.int32) - 1
    overflowed = member & (rank >= b)
    slot_ids = torch.sort(torch.where(member, ids_all, n + ids_all)).values[:b]
    occupied = slot_ids < n
    sid = torch.where(occupied, slot_ids, torch.zeros_like(slot_ids))
    sidl = sid.long()
    j2 = torch.arange(m, dtype=torch.int32, device=dev)
    sentinel = torch.tensor(num_tiles, dtype=torch.int32, device=dev)
    if conic is not None:
        r = min(num_tiles, r_cap)
        jr = torch.arange(r, dtype=torch.int32, device=dev)
        wbT = torch.clamp(w[sidl], min=1)[None, :]
        txT = x0[sidl][None, :] + jr[:, None] % wbT  # [R, b]
        tyT = y0[sidl][None, :] + jr[:, None] // wbT
        candT = (jr[:, None] < cnt[sidl][None, :]) & occupied[None, :]
        keepT = candT & _tile_keep_mask_T(
            mean2d[sidl], conic[sidl], opacity[sidl], txT, tyT, tile_px
        )
        tid_candT = torch.where(keepT, tyT * tiles_x + txT, sentinel)
        # kept tiles first, in row-major order: stable per-column sort on
        # the emission rank (r for culled)
        rankkeyT = torch.where(keepT, jr[:, None], torch.tensor(
            r, dtype=torch.int32, device=dev))
        perm = torch.sort(rankkeyT, dim=0, stable=True).indices
        tid_packedT = torch.gather(tid_candT, 0, perm)
        kept_cnt = keepT.sum(0, dtype=torch.int32)  # [b]
        valid2 = occupied[:, None] & (
            j2[None, :] < torch.clamp(kept_cnt, max=m)[:, None]
        )
        packed = tid_packedT[:m].T  # [b, min(m, r)]
        if r < m:  # tiny tile grids: fewer candidates than slots
            packed = torch.nn.functional.pad(packed, (0, m - r),
                                             value=num_tiles)
        tid2 = torch.where(valid2, packed, sentinel)
        # true spill: kept tiles beyond the m slots, plus rect tiles beyond
        # the R enumeration bound (uninspected, counted raw)
        zero = torch.zeros_like(kept_cnt)
        slot_spill = torch.where(
            occupied, torch.clamp(kept_cnt - m, min=0), zero).sum() + \
            torch.where(
                occupied, torch.clamp(cnt[sidl] - r, min=0), zero).sum()
    else:
        wb_safe = torch.clamp(w[sidl], min=1)[:, None]
        tx2 = x0[sidl][:, None] + j2[None, :] % wb_safe
        ty2 = y0[sidl][:, None] + j2[None, :] // wb_safe
        valid2 = occupied[:, None] & (j2[None, :] < cnt[sidl][:, None])
        tid2 = torch.where(valid2, ty2 * tiles_x + tx2, sentinel)
        slotted = member & ~overflowed
        slot_spill = torch.where(
            slotted, torch.clamp(cnt - m, min=0), torch.zeros_like(cnt)).sum()
    keys2 = (tid2 << depth_bits) | dq[sidl][:, None]
    ids2 = sid[:, None].expand(keys2.shape)
    return keys2, ids2, slot_spill, overflowed, slot_ids


def _bucketed_pair_keys(
    x0, y0, w, cnt, dq, vis, tiles_x, num_tiles, depth_bits, m1, m2, b2,
    mean2d=None, conic=None, opacity=None, tile_px=None,
):
    """Two-tier (tile, Gaussian) key emission: Gaussians touching at most
    ``m1`` tiles emit into an [N, m1] grid; the larger ones are compacted
    into a [b2, m2] grid, and those beyond the b2 capacity degrade to their
    first m1 tiles. Returns (keys, ids, spill_slot, spill_cap, tier2_ids),
    ``tier2_ids`` the Gaussian of each tier-2 row (>= N: empty). Each
    Gaussian emits real keys into one tier only, in row-major tile order
    (tight culling packs the kept tiles first, in that order)."""
    cull = dict(mean2d=mean2d, conic=conic, opacity=opacity, tile_px=tile_px)
    common = (x0, y0, w, cnt, dq, tiles_x, num_tiles, depth_bits)
    big = vis & (cnt > m1)
    # 2*m2 candidate headroom so max_tiles_per_gaussian growth keeps buying
    # inspected rect tiles past 256
    keys_b, ids_b, spill_b, overflowed, tier2_ids = _compact_tier(
        big, b2, m2, max(256, 2 * m2), *common, **cull)

    dev = cnt.device
    n = cnt.shape[0]
    ids_all = torch.arange(n, dtype=torch.int32, device=dev)
    j1 = torch.arange(m1, dtype=torch.int32, device=dev)
    wsafe = torch.clamp(w, min=1)[:, None]
    tx1 = x0[:, None] + j1[None, :] % wsafe
    ty1 = y0[:, None] + j1[None, :] // wsafe
    in_small = vis & (~big | overflowed)
    valid1 = (j1[None, :] < cnt[:, None]) & in_small[:, None]
    if conic is not None:
        valid1 &= _cull_valid(mean2d, conic, opacity, x0, y0, w, j1, tile_px)
    tid1 = torch.where(valid1, ty1 * tiles_x + tx1,
                       torch.tensor(num_tiles, dtype=torch.int32, device=dev))
    keys1 = (tid1 << depth_bits) | dq[:, None]
    ids1 = ids_all[:, None].expand(keys1.shape)

    keys = torch.cat([keys1.reshape(-1), keys_b.reshape(-1)])
    ids = torch.cat([ids1.reshape(-1), ids_b.reshape(-1)])
    spill_cap = torch.where(
        overflowed, torch.clamp(cnt - m1, min=0), torch.zeros_like(cnt)).sum()
    return keys, ids, spill_b, spill_cap, tier2_ids


def _quantize_depth(depth, vis, num_tiles):
    """The depth field of the int32 ``tile << depth_bits | dq`` keys: view
    depth of the visible Gaussians quantised to the bits the tile id leaves
    over. Returns (depth_bits, dq [N] int32)."""
    bits_tile = max(int(num_tiles + 1).bit_length(), 1)
    depth_bits = 31 - bits_tile
    if depth_bits < 16:
        raise ValueError(f"too many tiles ({num_tiles}) for int32 "
                         "[tile|depth] keys; raise tile_px")
    inf = torch.tensor(float("inf"), device=depth.device)
    dmin = torch.where(vis, depth, inf).min()
    dmax = torch.where(vis, depth, -inf).max()
    dq = torch.clamp(
        (depth - dmin) / torch.clamp(dmax - dmin, min=1e-12), 0.0, 1.0
    ) * ((1 << depth_bits) - 1)
    # clamp AFTER the int cast: (2^27 - 1) rounds up to 2^27 in f32, which
    # would overflow the depth field into the tile id
    return depth_bits, torch.clamp(dq.to(torch.int32), 0,
                                   (1 << depth_bits) - 1)


def _depth_keys(depth, vis, num_tiles, depth_keys):
    """``_quantize_depth`` for this viewport, or for the image of
    ``depth_keys=(tiles, seen)``: ``tiles`` tiles (at least this
    viewport's), ``seen`` the Gaussians on its screen."""
    if depth_keys is None:
        return _quantize_depth(depth, vis, num_tiles)
    tiles, seen = depth_keys
    return _quantize_depth(depth, seen, max(num_tiles, tiles))


def _tile_ranges(keys, num_tiles, depth_bits):
    """[start, end) of each tile's run in the sorted keys
    (identifyTileRanges analog)."""
    tids = torch.arange(num_tiles, dtype=torch.int32,
                        device=keys.device) << depth_bits
    starts = torch.searchsorted(keys, tids, right=False).to(torch.int32)
    ends = torch.searchsorted(
        keys, tids + (1 << depth_bits), right=False).to(torch.int32)
    return starts, ends


def _pair_sort(
    mean2d, depth, radius, visible, *, height, width, tile_px, max_per_tile,
    max_tiles_per_gaussian, max_pairs, small_slots=4, big_capacity=None,
    conic=None, opacity=None, depth_keys=None,
) -> PairBins:
    """Pair-stream binning body (the JAX ``emission="bucketed"`` branch)."""
    n = mean2d.shape[0]
    tiles_x = -(-width // tile_px)
    tiles_y = -(-height // tile_px)
    num_tiles = tiles_x * tiles_y

    x0, x1, y0, y1, vis = tile_rects(
        mean2d, radius, visible, tile_px, tiles_x, tiles_y
    )
    depth_bits, dq = _depth_keys(depth, vis, num_tiles, depth_keys)

    w = x1 - x0
    h = y1 - y0
    cnt = w * h

    b2 = big_capacity or (1 << max(int(n // 32 - 1).bit_length(), 6))
    keys, ids, spill_slot, spill_cap, tier2_ids = _bucketed_pair_keys(
        x0, y0, w, cnt, dq, vis, tiles_x, num_tiles, depth_bits,
        m1=small_slots, m2=max_tiles_per_gaussian, b2=b2,
        mean2d=mean2d, conic=conic, opacity=opacity, tile_px=tile_px,
    )
    keys, perm = torch.sort(keys, stable=True)
    ids = ids[perm]
    starts, ends = _tile_ranges(keys, num_tiles, depth_bits)
    raw = ends - starts
    counts_mpt = torch.clamp(raw, max=max_per_tile)
    counts = torch.minimum(counts_mpt, torch.clamp(max_pairs - starts, min=0))
    tile_spill = (raw - counts_mpt).sum()
    stream_spill = (counts_mpt - counts).sum()
    spill = tile_spill + stream_spill + spill_slot + spill_cap
    return PairBins(
        pair_ids=ids[:max_pairs],
        starts=starts,
        counts=_i32(counts),
        spill=_i32(spill),
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        spill_parts=_i32(torch.stack(
            [spill_slot, spill_cap, tile_spill, stream_spill])),
        length=ends[-1],
        perm=perm,
        tier2_ids=tier2_ids,
        emission=(n, small_slots, max_tiles_per_gaussian),
    )


def bin_gaussians_pairs(
    mean2d: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    visible: torch.Tensor,
    *,
    height: int,
    width: int,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    max_tiles_per_gaussian: int = 32,
    max_pairs: int = 0,
    big_capacity: int = 0,
    small_slots: int = 4,
    conic: torch.Tensor = None,
    opacity: torch.Tensor = None,
    depth_keys=None,
) -> PairBins:
    """The sorted pair stream truncated to ``max_pairs`` (valid pairs sort
    before the sentinel tile, so the prefix is the concatenation of all
    tiles' depth-ordered lists). ``max_pairs=0`` is max(2^18, 2N) rounded up
    to a power of two; ``big_capacity=0`` is N/32 rounded up (at least 64).
    Every cap reports its overflow in ``spill`` / ``spill_parts``. Passing
    ``conic`` + ``opacity`` enables exact tight tile culling.
    ``depth_keys=(tiles, seen)`` quantises depth as an image of ``tiles``
    tiles in which ``seen`` [N] bool are the Gaussians on screen would: a
    band of a larger image passes the whole image's (``tile_rects``'s
    visibility), so its depths quantise, and its ties order, as there."""
    n = mean2d.shape[0]
    if max_pairs <= 0:
        max_pairs = max(1 << 18, 1 << int(2 * n - 1).bit_length())
    return _pair_sort(
        mean2d, depth, radius, visible, height=height, width=width,
        tile_px=tile_px, max_per_tile=max_per_tile,
        max_tiles_per_gaussian=max_tiles_per_gaussian, max_pairs=max_pairs,
        small_slots=small_slots, big_capacity=big_capacity or None,
        conic=conic, opacity=opacity, depth_keys=depth_keys,
    )


def bin_gaussians(
    mean2d: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    visible: torch.Tensor,
    *,
    height: int,
    width: int,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    max_tiles_per_gaussian: int = 32,
    conic: torch.Tensor = None,
    opacity: torch.Tensor = None,
    depth_keys=None,
) -> TileBins:
    """Duplicate-and-sort binning into capped per-tile lists: each Gaussian
    emits up to ``max_tiles_per_gaussian`` keys ``tile << depth_bits | dq``
    over its row-major tile rect, one stable sort carrying the Gaussian id
    orders them by (tile, depth), ``searchsorted`` recovers the per-tile
    ranges and one gather builds ``lists [T, max_per_tile]`` of ORIGINAL ids
    (``order`` is None). Entries past ``counts[t]`` are whatever follows the
    tile's run in the sorted stream: mask by slot, never by id. ``spill``
    counts both caps: list entries beyond ``max_per_tile`` and rect tiles
    beyond ``max_tiles_per_gaussian`` (raw, before culling). Passing
    ``conic`` + ``opacity`` enables exact tight tile culling; ``depth_keys``
    as in ``bin_gaussians_pairs``."""
    dev = mean2d.device
    n = mean2d.shape[0]
    tiles_x = -(-width // tile_px)
    tiles_y = -(-height // tile_px)
    num_tiles = tiles_x * tiles_y
    m = max_tiles_per_gaussian

    x0, x1, y0, y1, vis = tile_rects(
        mean2d, radius, visible, tile_px, tiles_x, tiles_y
    )
    depth_bits, dq = _depth_keys(depth, vis, num_tiles, depth_keys)

    w = x1 - x0
    cnt = w * (y1 - y0)
    j = torch.arange(m, dtype=torch.int32, device=dev)
    wsafe = torch.clamp(w, min=1)[:, None]
    tx = x0[:, None] + j[None, :] % wsafe
    ty = y0[:, None] + j[None, :] // wsafe
    valid = (j[None, :] < cnt[:, None]) & vis[:, None]
    if conic is not None:
        valid &= _cull_valid(mean2d, conic, opacity, x0, y0, w, j, tile_px)
    tile_id = torch.where(
        valid, ty * tiles_x + tx,
        torch.tensor(num_tiles, dtype=torch.int32, device=dev))
    keys = ((tile_id << depth_bits) | dq[:, None]).reshape(-1)
    ids = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(
        n, m).reshape(-1)
    keys, perm = torch.sort(keys, stable=True)
    ids = ids[perm]

    starts, ends = _tile_ranges(keys, num_tiles, depth_bits)
    counts = torch.clamp(ends - starts, max=max_per_tile)
    pos = torch.clamp(
        starts[:, None].long()
        + torch.arange(max_per_tile, device=dev)[None, :],
        0, keys.shape[0] - 1)
    lists = ids[pos]

    zero = torch.zeros_like(cnt)
    tile_spill = torch.clamp(ends - starts - max_per_tile, min=0).sum()
    slot_spill = torch.where(vis, torch.clamp(cnt - m, min=0), zero).sum()
    parts = torch.stack([slot_spill.to(torch.int32),
                         torch.zeros((), dtype=torch.int32, device=dev),
                         tile_spill.to(torch.int32),
                         torch.zeros((), dtype=torch.int32, device=dev)])
    return TileBins(lists=lists, counts=_i32(counts), order=None,
                    spill=_i32(tile_spill + slot_spill), tiles_x=tiles_x,
                    tiles_y=tiles_y, spill_parts=parts)


def bin_gaussians_scan(
    mean2d: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    visible: torch.Tensor,
    *,
    height: int,
    width: int,
    tile_px: int = 32,
    max_per_tile: int = 2048,
    chunk: int = 2048,
) -> TileBins:
    """The cross-check oracle of ``bin_gaussians``: one global depth sort
    (``order``, culled rows last), then a chunked rect-intersection test with
    prefix-sum compaction into the capped lists, which index into ``order``.
    No per-Gaussian tile cap and no culling."""
    dev = mean2d.device
    n = mean2d.shape[0]
    tiles_x = -(-width // tile_px)
    tiles_y = -(-height // tile_px)
    num_tiles = tiles_x * tiles_y

    inf = torch.tensor(float("inf"), device=dev)
    order = torch.sort(torch.where(visible, depth, inf), stable=True).indices
    x0, x1, y0, y1, vis_s = tile_rects(
        mean2d[order], radius[order], visible[order], tile_px, tiles_x,
        tiles_y)

    tid = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    tx = (tid % tiles_x)[:, None]
    ty = (tid // tiles_x)[:, None]
    lists = torch.zeros(num_tiles, max_per_tile, dtype=torch.int32, device=dev)
    offsets = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    for base in range(0, n, chunk):
        s = slice(base, min(base + chunk, n))
        hit = (vis_s[s][None, :] & (tx >= x0[s][None, :])
               & (tx < x1[s][None, :]) & (ty >= y0[s][None, :])
               & (ty < y1[s][None, :]))  # [T, C]
        pos = offsets[:, None] + torch.cumsum(hit.to(torch.int32), 1) - 1
        rows, cols = torch.nonzero(hit & (pos < max_per_tile), as_tuple=True)
        lists[rows, pos[rows, cols].long()] = (base + cols).to(torch.int32)
        offsets = offsets + hit.sum(1, dtype=torch.int32)
    return TileBins(
        lists=lists,
        counts=torch.clamp(offsets, max=max_per_tile),
        order=_i32(order),
        spill=_i32(torch.clamp(offsets - max_per_tile, min=0).sum()),
        tiles_x=tiles_x, tiles_y=tiles_y)
