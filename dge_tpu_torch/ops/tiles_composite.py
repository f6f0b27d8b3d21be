"""Per-tile-list compositing (K2) on the forward's row and combine kernels:
the list stream's layout, the wrapper and the image-level function.

JAX counterpart: ``dge_tpu/ops/pallas_composite.py`` (``_composite_kernel``,
``composite_tiles_pallas``). What it computes: each tile walks the slots
``[0, counts[t])`` of its depth-ordered list ``lists[t, :]`` (through
``order`` when it is given), cut into chunks counted from the tile's OWN
slot 0; a refused slot blocks its pixel to the end of its chunk. Its plain
version is ``ops/composite.composite_lists`` at the same chunk.

The layout is a chunk-aligned compact list stream. Tile t starts at
``starts[t] = chunk · Σ_{u<t} ceil(counts[u] / chunk)``, and slot s of its
list sits at stream position ``starts[t] + s``: the TPU wrapper's gather
of ``feat[:, order[lists]]`` (``pallas_composite.py:187-189``), kept compact
instead of ``[T, 16, Kp]``. With every start a multiple of ``chunk``, the
pair-stream kernels' blocks at absolute offsets ``k·chunk`` ARE the tile's
own chunks, so K1's row kernel and combine kernel (csrc/pair_rows_forward.cuh,
through ``pairs_composite.rows_forward`` / ``rows_combine``) compute K2's
function exactly, in parallel over (tile, chunk) rows: no block walks a
whole list, so the fullest tile does not set the time. A list row is
``(t, k)``: slots ``[k·chunk, min((k+1)·chunk, counts[t]))``, row
``blk_off[t] + k`` with ``blk_off = starts / chunk``. Positions past
``counts[t]`` in a tile's last chunk are never read.

- ``feature_table`` stacks the 10 per-Gaussian features as rows, ``[N, 10]``.
- ``list_rows`` lays the tiles out; the row count ``R = Σ ceil(counts /
  chunk)`` is one host read (the no-sync bound ``ceil(Pc / chunk) + T`` of
  the pair stream would reserve ``T · ceil(K / chunk)`` rows of scratch, 16k
  at 512², ~470 MB).
- ``list_stream`` is the layout kernel's wrapper (csrc/list_stream.cu,
  counter ``list_stream``): the features gathered into the aligned stream
  ``[10, R·chunk]`` and each row's tile, in one launch where the same in
  PyTorch ops (``list_stream_reference``, its plain version) is about twenty
  small kernels whose host time exceeds the compositing at 256².
- ``composite_tiles_kernel`` is K2's wrapper: the layout, then the row and
  combine kernels on CUDA tensors (or raise), the plain layout and row +
  combine arithmetic (``rows_forward_reference`` →
  ``rows_combine_reference``) on CPU tensors.
- ``composite_tiles`` is the image-level function: feature table, wrapper,
  ``bg·T``, untile. Forward only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dge_tpu_torch.ops import composite as C
from dge_tpu_torch.ops import cuda_build
from dge_tpu_torch.ops import pairs_composite as PC
from dge_tpu_torch.ops.pairs_composite import FEAT


def feature_table(mean2d, conic, rgb, depth, opac) -> torch.Tensor:
    """Per-Gaussian features as rows → [N, FEAT] (mx, my, conic a, b, c,
    opacity, r, g, b, depth)."""
    return torch.cat([mean2d, conic, opac[:, None], rgb, depth[:, None]],
                     dim=1).float().contiguous()


def list_rows(counts, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The aligned list stream's tiles → (``starts`` [T], ``blk_off`` [T],
    ``cum`` [T], all int32, and R): tile t owns rows ``blk_off[t]`` ..
    ``cum[t] - 1`` (``cum`` the inclusive prefix sum of ``ceil(counts /
    chunk)``) and stream positions from ``starts[t] = blk_off[t] · chunk``.
    R is read on the host, once."""
    nblk = (counts + (chunk - 1)) // chunk
    cum = torch.cumsum(nblk, 0, dtype=torch.int32)
    n_rows = int(cum[-1]) if cum.numel() else 0
    blk_off = cum - nblk
    return blk_off * chunk, blk_off, cum, n_rows


def list_stream_reference(feat, lists, counts, order, cum, n_rows: int,
                          chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the layout kernel → (data [FEAT, R·chunk],
    row_tile [R] int32): row r = (tile t, its chunk k) holds slots
    k·chunk .. of lists[t] (through ``order``), 0 past counts[t]."""
    k = lists.shape[1]
    dev = lists.device
    row_tile = torch.searchsorted(
        cum, torch.arange(n_rows, dtype=torch.int32, device=dev), right=True,
        out_int32=True)
    tile = row_tile.long()
    nblk = (counts[tile] + (chunk - 1)) // chunk
    slot = ((torch.arange(n_rows, device=dev) - cum[tile] + nblk)
            * chunk)[:, None] + torch.arange(chunk, device=dev)
    valid = (slot < counts[tile][:, None]).reshape(-1)
    ids = lists.reshape(-1)[tile[:, None] * k + slot.clamp(max=k - 1)]
    ids = torch.where(valid, ids.reshape(-1), 0)
    if order is not None:
        ids = order[ids]
    data = feat.T.index_select(1, ids)
    return torch.where(valid, data, torch.zeros_like(data)), row_tile


def list_stream(feat, lists, counts, order, cum, n_rows: int, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layout kernel's wrapper → (data [FEAT, R·chunk], row_tile [R]
    int32), as ``list_stream_reference``. On CUDA tensors it launches the
    kernel, or raises; on CPU tensors it takes the plain version. The
    caller (``composite_tiles_kernel``) has checked the tensors."""
    if feat.device.type == "cpu":
        return list_stream_reference(feat, lists, counts, order, cum, n_rows,
                                     chunk)
    data = torch.empty(FEAT, n_rows * chunk, dtype=torch.float32,
                       device=feat.device)
    row_tile = torch.empty(n_rows, dtype=torch.int32, device=feat.device)
    cuda_build.launch("list_stream", "list_stream", feat.device, feat, lists,
                      lists.shape[1], counts, order, cum, counts.shape[0],
                      chunk, n_rows, data, row_tile)
    return data, row_tile


def composite_tiles_kernel(feat, lists, counts, order=None, *, tiles_x: int,
                           tile_px: int, chunk: int) -> torch.Tensor:
    """K2's wrapper → [T, 5, P] (rows r, g, b, depth, final T). On CUDA
    tensors it launches the layout kernel, then K1's row and combine kernels
    over the aligned list stream, or raises on anything they do not take; it
    never falls back. On CPU tensors, where no kernel runs, the plain
    versions of the three take their place."""
    cuda_build.check_tensors("composite_tiles_kernel", (
        ("feat", feat, torch.float32, None),
        ("lists", lists, torch.int32, None),
        ("counts", counts, torch.int32, None),
        ("order", order, torch.int32, None)))
    if feat.dim() != 2 or feat.shape[1] != FEAT:
        raise ValueError(f"feat must be [N, {FEAT}], got {tuple(feat.shape)}")
    if lists.dim() != 2 or counts.shape != (lists.shape[0],):
        raise ValueError("lists must be [T, K] and counts [T]")
    if order is not None and order.shape != (feat.shape[0],):
        raise ValueError("order must be [N]")
    counts = counts.clamp(max=lists.shape[1])
    starts, blk_off, cum, n_rows = list_rows(counts, chunk)
    data, row_tile = list_stream(feat, lists, counts, order, cum, n_rows,
                                 chunk)
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    scratch, mask = PC.rows_forward(data, starts, counts, blk_off, row_tile,
                                    **kw)
    out = PC.rows_combine(scratch, mask, data, starts, counts, blk_off, **kw)
    if feat.device.type == "cuda":
        cuda_build.count("tiles_composite")
    return out


def composite_tiles(
    lists, counts, mean2d, conic, rgb, depth, opac, *, height: int,
    width: int, tiles_x: int, tiles_y: int, tile_px: int, bg: torch.Tensor,
    chunk: int = 128, order: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (color [H, W, 3], depth [H, W], final_T [H, W]) through K2's
    wrapper. The features are in ORIGINAL index space; ``lists`` index them
    directly, or through ``order`` when it is given."""
    out = composite_tiles_kernel(
        feature_table(mean2d, conic, rgb, depth, opac).detach(),
        lists.to(torch.int32).contiguous(),
        counts.to(torch.int32).contiguous(),
        None if order is None else order.to(torch.int32).contiguous(),
        tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    return C.tiles_to_image(out, bg, height=height, width=width,
                            tiles_x=tiles_x, tiles_y=tiles_y, tile_px=tile_px)
