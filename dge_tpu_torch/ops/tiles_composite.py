"""Per-tile-list compositing through the CUDA kernel: the wrapper, its
build and load, and the image-level function.

JAX counterpart: ``dge_tpu/ops/pallas_composite.py`` (``_composite_kernel``,
``composite_tiles_pallas``). The kernel is
``dge_tpu_torch/csrc/tiles_composite.cu``; its source note states what it
computes, its chunk rule (chunks count from the tile's own slot 0) and its
bound. Its plain version is ``ops/composite.composite_lists`` at the same
chunk.

- ``feature_table`` stacks the 10 per-Gaussian features as rows, ``[N, 10]``:
  the kernel gathers rows through the lists itself, so the TPU wrapper's
  ``[T, 16, Kp]`` gathered buffer is never built.
- ``composite_tiles_kernel`` is the kernel's wrapper: it launches the kernel
  on CUDA tensors, or raises; on CPU tensors it takes the plain version.
- ``composite_tiles`` is the image-level function: feature table, kernel
  wrapper, ``bg·T``, untile. Forward only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dge_tpu_torch.ops import composite as C
from dge_tpu_torch.ops import cuda_build
from dge_tpu_torch.ops.pairs_composite import FEAT, launch_counts

_lib = None


def feature_table(mean2d, conic, rgb, depth, opac) -> torch.Tensor:
    """Per-Gaussian features as rows → [N, FEAT] (mx, my, conic a, b, c,
    opacity, r, g, b, depth)."""
    return torch.cat([mean2d, conic, opac[:, None], rgb, depth[:, None]],
                     dim=1).float().contiguous()


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build_library("tiles_composite"))
        lib.tiles_composite.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.tiles_composite.restype = ctypes.c_int
        _lib = lib
    return _lib


def composite_tiles_kernel(feat, lists, counts, order=None, *, tiles_x: int,
                           tile_px: int, chunk: int) -> torch.Tensor:
    """The kernel's wrapper → [T, 5, P] (rows r, g, b, depth, final T). On
    CUDA tensors it launches the kernel, or raises on anything the kernel
    does not take; it never falls back. On CPU tensors, where no kernel
    runs, it takes the plain version."""
    tensors = [("feat", feat, torch.float32), ("lists", lists, torch.int32),
               ("counts", counts, torch.int32)]
    if order is not None:
        tensors.append(("order", order, torch.int32))
    for name, t, dtype in tensors:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"composite_tiles_kernel: {name} must be a "
                             f"contiguous {dtype} tensor, got {t.dtype}")
    if feat.dim() != 2 or feat.shape[1] != FEAT:
        raise ValueError(f"feat must be [N, {FEAT}], got {tuple(feat.shape)}")
    if lists.dim() != 2 or counts.shape != (lists.shape[0],):
        raise ValueError("lists must be [T, K] and counts [T]")
    if order is not None and order.shape != (feat.shape[0],):
        raise ValueError("order must be [N]")
    devices = {t.device for _, t, _ in tensors}
    if devices == {torch.device("cpu")}:
        return C.composite_lists(
            lists, counts, feat[:, 0:2], feat[:, 2:5], feat[:, 6:9],
            feat[:, 9], feat[:, 5], tiles_x=tiles_x, tile_px=tile_px,
            chunk=chunk, order=order)
    if len(devices) != 1 or feat.device.type != "cuda":
        raise ValueError("composite_tiles_kernel: all tensors must share one "
                         f"CUDA device, got {devices}")
    if not 1 <= tile_px <= 32:
        raise ValueError(f"tile_px {tile_px}: one thread per pixel needs "
                         "tile_px**2 <= 1024")
    if not 1 <= chunk <= 1024:
        raise ValueError(f"chunk {chunk} outside [1, 1024]")
    if lists.numel() >= 2 ** 31 or feat.shape[0] * FEAT >= 2 ** 31:
        raise ValueError("lists or feature table too long for int32 offsets")
    lib = _load()
    num_tiles, k = lists.shape
    out = torch.empty(num_tiles, 5, tile_px * tile_px, dtype=torch.float32,
                      device=feat.device)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tiles_composite(
            feat.data_ptr(), lists.data_ptr(), k, counts.data_ptr(),
            None if order is None else order.data_ptr(), num_tiles, tiles_x,
            tile_px, chunk, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tiles_composite launch failed: cudaError {err}")
    launch_counts["tiles_composite"] += 1
    return out


def composite_tiles(
    lists, counts, mean2d, conic, rgb, depth, opac, *, height: int,
    width: int, tiles_x: int, tiles_y: int, tile_px: int, bg: torch.Tensor,
    chunk: int = 128, order: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (color [H, W, 3], depth [H, W], final_T [H, W]) through the
    kernel's wrapper. The features are in ORIGINAL index space; ``lists``
    index them directly, or through ``order`` when it is given."""
    out = composite_tiles_kernel(
        feature_table(mean2d, conic, rgb, depth, opac).detach(),
        lists.to(torch.int32).contiguous(),
        counts.to(torch.int32).contiguous(),
        None if order is None else order.to(torch.int32).contiguous(),
        tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    return C.tiles_to_image(out, bg, height=height, width=width,
                            tiles_x=tiles_x, tiles_y=tiles_y, tile_px=tile_px)
