"""Pair-stream compositing: the CUDA kernel's wrapper, its build and load,
its plain PyTorch version, and the stream assembly.

JAX counterpart: ``dge_tpu/ops/pallas_composite.py`` (``_pairs_kernel``,
``composite_pairs_pallas``, ``assemble_stream_data``). The kernel is
``dge_tpu_torch/csrc/pairs_composite.cu``; its source note states what it
computes, the block rule it shares with the TPU kernel, and its bound.

- ``assemble_stream_data`` gathers the 10 per-Gaussian features into stream
  order, ``[10, Pc]``. (The JAX version pads to 16 rows for the TPU's
  sublane tiling; nothing on the GPU needs the 6 zero rows.)
- ``composite_pairs_reference`` is the plain version: a loop over the
  chunk-aligned stream blocks with ``torch.cumprod`` inside a block, over
  groups of tiles to bound memory.
- ``composite_pairs_stream`` is the kernel's wrapper: it launches the
  kernel on CUDA tensors, or raises; on CPU tensors it takes the plain
  version. With ``boundary_rows=(blk_off, n_rows)`` both also return
  ``boundary_T`` ``[n_rows, P]``, the committed transmittance entering each
  (tile, stream block) row of ``pairs_backward.block_rows``: the walk holds
  it anyway, and the backward starts every row from it.
- ``composite_pairs`` is the image-level function: assemble, composite
  through the wrapper or the plain version, add ``bg·T``, untile.

Both versions write ``[T, 5, P]`` (rows r, g, b, depth, final T) and visit
each chunk-aligned block of a tile's range once. The TPU wrapper clamps its
block index to the stream's last block, so a tile whose range reaches that
block re-runs it; the port does not copy that (ROADMAP.md §3).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dge_tpu_torch.ops import cuda_build

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
FEAT = 10  # mx, my, conic a, b, c, opacity, r, g, b, depth

_SRC = cuda_build.source_path("pairs_composite")
BUILD_DIR = cuda_build.BUILD_DIR

# kernel launches since the last reset (one per launch, counted where the
# kernel is launched and nowhere else); pairs_pass1, pairs_suffix and
# pairs_pass2 are the backward kernels of ops/pairs_backward.py,
# tiles_composite the per-tile-list kernel of ops/tiles_composite.py,
# pairs_logdot the log-space arm of tools/proto_logdot.py
launch_counts = {"pairs_composite": 0, "pairs_pass1": 0, "pairs_suffix": 0,
                 "pairs_pass2": 0, "tiles_composite": 0, "pairs_logdot": 0}
_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def composite_pairs_reference(data, starts, counts, *, tiles_x: int,
                              tile_px: int, chunk: int,
                              log_prefix: bool = False,
                              boundary_rows: Optional[Tuple[torch.Tensor,
                                                            int]] = None):
    """Plain PyTorch version of the kernel, on any device → [T, 5, P], or
    (that, boundary_T [n_rows, P]) with ``boundary_rows=(blk_off, n_rows)``
    (rows not in use are 0).

    Follows the block rule literally: blocks at absolute stream offsets
    ``k·chunk``; inside a block an inclusive ``torch.cumprod`` of ``1-eff``,
    a pair applied iff ``T_block·cp >= 1e-4``, ``w = eff·T_block·cp/(1-eff)``;
    the committed T after the block is ``T_block·cp`` at its last applied
    pair. ``log_prefix`` forms ``cp`` as ``exp(cumsum(log(1-eff)))`` instead:
    the plain version of the log-space kernel of tools/proto_logdot.py."""
    dev = data.device
    num_tiles = starts.shape[0]
    p = tile_px * tile_px
    pc = data.shape[1]
    out = torch.zeros(num_tiles, 5, p, dtype=torch.float32, device=dev)
    out[:, 4] = 1.0
    boundary_t = None
    if boundary_rows is not None:
        blk_off, n_rows = boundary_rows
        boundary_t = torch.zeros(n_rows, p, dtype=torch.float32, device=dev)

    def result():
        return out if boundary_t is None else (out, boundary_t)

    if pc == 0:
        return result()
    starts = starts.long()
    ends = starts + counts.long()
    first = starts // chunk
    nblk = torch.where(counts > 0, (ends - 1) // chunk - first + 1,
                       torch.zeros_like(first))
    live = torch.nonzero(counts > 0).flatten()
    if live.numel() == 0:
        return result()
    pid = torch.arange(p, device=dev)
    slot = torch.arange(chunk, device=dev)
    # tiles per group: keep each [G, chunk, P] temporary near 2^23 floats
    group = max(1, (1 << 23) // (chunk * p))
    for g0 in range(0, live.numel(), group):
        tiles = live[g0:g0 + group]
        px = ((tiles % tiles_x) * tile_px)[:, None] + pid[None, :] % tile_px
        py = ((tiles // tiles_x) * tile_px)[:, None] + pid[None, :] // tile_px
        px = px.float()[:, None, :]  # [G, 1, P]
        py = py.float()[:, None, :]
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
            f = data[:, idx.clamp(max=pc - 1)][..., None]  # [FEAT, G, C, 1]
            dx = f[0] - px
            dy = f[1] - py
            power = -0.5 * (f[2] * dx * dx + f[4] * dy * dy) - f[3] * dx * dy
            alpha = torch.clamp(f[5] * torch.exp(power), max=ALPHA_MAX)
            keep = (power <= 0.0) & (alpha >= ALPHA_EPS) & in_range[..., None]
            eff = torch.where(keep, alpha, torch.zeros_like(alpha))
            one_minus = 1.0 - eff
            if log_prefix:
                cp = torch.exp(torch.cumsum(torch.log(one_minus), dim=1))
            else:
                cp = torch.cumprod(one_minus, dim=1)  # inclusive, [G, C, P]
            applied = trans * cp >= T_EPS
            w = torch.where(applied, eff * trans * (cp / one_minus),
                            torch.zeros_like(cp))
            acc = acc + torch.stack(
                [(w * f[6 + r]).sum(dim=1) for r in range(4)], dim=1)
            trans = trans * torch.where(applied, cp, torch.ones_like(cp)).amin(
                dim=1, keepdim=True)
        out[tiles, 0:4] = acc
        out[tiles, 4] = trans[:, 0]
    return result()


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build_library("pairs_composite"))
        lib.pairs_composite.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pairs_composite.restype = ctypes.c_int
        _lib = lib
    return _lib


def composite_pairs_stream(data, starts, counts, *, tiles_x: int,
                           tile_px: int, chunk: int,
                           boundary_rows: Optional[Tuple[torch.Tensor,
                                                         int]] = None):
    """The kernel's wrapper → [T, 5, P], or (that, boundary_T [n_rows, P])
    with ``boundary_rows=(blk_off, n_rows)`` (the kernel leaves rows not in
    use unwritten). On CUDA tensors it launches the kernel, or raises on
    anything the kernel does not take; it never falls back. On CPU tensors,
    where no kernel runs, it takes the plain version."""
    num_tiles = starts.shape[0]
    checked = [("data", data, torch.float32), ("starts", starts, torch.int32),
               ("counts", counts, torch.int32)]
    if boundary_rows is not None:
        checked.append(("blk_off", boundary_rows[0], torch.int32))
        if boundary_rows[0].shape != (num_tiles,):
            raise ValueError("blk_off must be [T]")
    for name, t, dtype in checked:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"composite_pairs_stream: {name} must be a "
                             f"contiguous {dtype} tensor, got {t.dtype}")
    if data.dim() != 2 or data.shape[0] != FEAT:
        raise ValueError(f"data must be [{FEAT}, Pc], got {tuple(data.shape)}")
    if counts.shape != (num_tiles,) or starts.dim() != 1:
        raise ValueError("starts and counts must be [T] each")
    devices = {t.device for _, t, _ in checked}
    if devices == {torch.device("cpu")}:
        return composite_pairs_reference(data, starts, counts, tiles_x=tiles_x,
                                         tile_px=tile_px, chunk=chunk,
                                         boundary_rows=boundary_rows)
    if len(devices) != 1 or data.device.type != "cuda":
        raise ValueError("composite_pairs_stream: all tensors must share "
                         f"one CUDA device, got {devices}")
    if not 1 <= tile_px <= 32:
        raise ValueError(f"tile_px {tile_px}: one thread per pixel needs "
                         "tile_px**2 <= 1024")
    if not 1 <= chunk <= 1024:
        raise ValueError(f"chunk {chunk} outside [1, 1024]")
    if data.shape[1] >= 2 ** 31:
        raise ValueError("stream too long for int32 offsets")
    lib = _load()
    out = torch.empty(num_tiles, 5, tile_px * tile_px, dtype=torch.float32,
                      device=data.device)
    blk_off = boundary_t = None
    if boundary_rows is not None:
        blk_off = boundary_rows[0]
        boundary_t = torch.empty(boundary_rows[1], tile_px * tile_px,
                                 dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pairs_composite(
            data.data_ptr(), data.shape[1], starts.data_ptr(),
            counts.data_ptr(), num_tiles, tiles_x, tile_px, chunk,
            out.data_ptr(),
            None if blk_off is None else blk_off.data_ptr(),
            None if boundary_t is None else boundary_t.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pairs_composite launch failed: cudaError {err}")
    launch_counts["pairs_composite"] += 1
    return out if boundary_t is None else (out, boundary_t)


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
