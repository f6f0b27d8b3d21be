"""Front-to-back alpha compositing over capped per-tile lists, in plain
PyTorch, and the mask lift over the same lists.

JAX counterpart: ``dge_tpu/ops/composite.py`` (``composite``,
``lift_weights``); reference analogs forward.cu:261-379 and the DGE fork's
apply_weights.cu:239-398. Each tile walks its depth-ordered list in chunks
of ``chunk`` slots counted from the tile's OWN slot 0, with an inclusive
``torch.cumprod`` of ``1 - alpha`` inside a chunk; plain autograd
differentiates it (the threshold masks are piecewise constant).

The stop rule is the chunked one: a pair is applied iff ``T·cp >= 1e-4``
with ``T`` the product of the factors applied in earlier chunks, so a
refused pair blocks its pixel only to the end of its chunk of the tile's
list, and a pair of a later chunk can be applied again. The sequential walk
of the CUDA reference breaks for good; the two agree only while no pixel
saturates before the last chunk it reaches. The pair-stream compositors
(ops/pairs_composite.py) cut their chunks at absolute stream offsets
instead, so they and this module can differ at pixels that saturate across
a chunk edge, as this module does with itself at two chunk sizes.

``composite_lists`` at the kernel's chunk is the plain version of the list
kernel K2 of ops/tiles_composite.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dge_tpu_torch.ops.pairs_composite import (ALPHA_EPS, ALPHA_MAX, T_EPS,
                                               ordered_prod, ordered_sum,
                                               untile)


class CompositeOut(NamedTuple):
    color: torch.Tensor  # [H, W, 3]
    depth: torch.Tensor  # [H, W] expected depth
    final_T: torch.Tensor  # [H, W] residual transmittance
    spill: torch.Tensor  # scalar int32 from binning


def _tile_group(chunk: int, p: int) -> int:
    """Tiles per group: keeps each [G, chunk, P] temporary near 2^23
    floats."""
    return max(1, (1 << 23) // (chunk * p))


def _pixel_coords(tiles, tiles_x, tile_px):
    """Pixel centres of the given tiles → (px, py), each [G, 1, P] f32."""
    pid = torch.arange(tile_px * tile_px, device=tiles.device)
    px = ((tiles % tiles_x) * tile_px)[:, None] + pid[None, :] % tile_px
    py = ((tiles // tiles_x) * tile_px)[:, None] + pid[None, :] // tile_px
    return px.float()[:, None, :], py.float()[:, None, :]


def _effective_alpha(mean2d, conic, opac, valid, px, py):
    """Per-(tile, slot, pixel) alpha with the skip rules of forward.cu:335-348
    → [G, C, P]. mean2d [G, C, 2], conic [G, C, 3], opac [G, C], valid
    [G, C]."""
    dx = mean2d[..., 0, None] - px
    dy = mean2d[..., 1, None] - py
    a = conic[..., 0, None]
    b = conic[..., 1, None]
    c = conic[..., 2, None]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(opac[..., None] * torch.exp(power), max=ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_EPS) & valid[..., None]
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def _chunks(lists, counts, chunk):
    """The tiles that hold anything, and the list padded so that every chunk
    is whole. Only chunks below the fullest live tile's count are visited."""
    num_tiles, k = lists.shape
    live = torch.nonzero(counts > 0).flatten()
    steps = -(-k // chunk)
    if steps * chunk != k:
        lists = torch.nn.functional.pad(lists, (0, steps * chunk - k))
    return live, lists


def composite_lists(lists, counts, mean2d, conic, rgb, depth, opac, *,
                    tiles_x: int, tile_px: int, chunk: int,
                    order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Composite every tile's list → [T, 5, P] (rows r, g, b, depth, final
    T), differentiable with respect to the five feature tensors.

    ``lists [T, K]`` index the feature tensors' rows, through ``order`` when
    it is given; slots at or past ``counts[t]`` are masked by slot."""
    dev = mean2d.device
    num_tiles = lists.shape[0]
    p = tile_px * tile_px
    live, lists = _chunks(lists, counts, chunk)
    out_rgbd = torch.zeros(num_tiles, 4, p, dtype=torch.float32, device=dev)
    out_t = torch.ones(num_tiles, p, dtype=torch.float32, device=dev)
    slot = torch.arange(chunk, device=dev)
    group = _tile_group(chunk, p)
    for g0 in range(0, live.numel(), group):
        tiles = live[g0:g0 + group]
        px, py = _pixel_coords(tiles, tiles_x, tile_px)
        cnt = counts[tiles].long()
        trans = torch.ones(tiles.numel(), 1, p, device=dev)
        acc = 0.0
        for base in range(0, int(cnt.max()), chunk):
            idx = lists[tiles, base:base + chunk].long()  # [G, C]
            if order is not None:
                idx = order[idx].long()
            valid = (base + slot)[None, :] < cnt[:, None]
            eff = _effective_alpha(mean2d[idx], conic[idx], opac[idx], valid,
                                   px, py)
            one_minus = 1.0 - eff
            cp = torch.cumprod(one_minus, dim=1)  # inclusive, [G, C, P]
            ex = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
            applied = trans * cp >= T_EPS
            w = torch.where(applied, eff * trans * ex, torch.zeros_like(cp))
            feats = torch.cat([rgb[idx], depth[idx][..., None]], dim=-1)
            acc = acc + torch.stack([ordered_sum(w * feats[..., d, None], 1)
                                     for d in range(4)], dim=1)
            trans = trans * ordered_prod(torch.where(
                applied, one_minus, torch.ones_like(cp)), 1)[:, None]
        out_rgbd = out_rgbd.index_copy(0, tiles, acc)
        out_t = out_t.index_copy(0, tiles, trans[:, 0])
    return torch.cat([out_rgbd, out_t[:, None, :]], dim=1)


def tiles_to_image(out, bg, *, height: int, width: int, tiles_x: int,
                   tiles_y: int, tile_px: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[T, 5, P] → (color [H, W, 3] with ``bg·T`` added, depth, final T)."""
    trans = out[:, 4, :]
    color = out[:, 0:3, :].transpose(1, 2) + trans[..., None] * bg[None, None]
    geom = (tiles_x, tiles_y, tile_px, height, width)
    return (untile(color, *geom), untile(out[:, 3, :], *geom),
            untile(trans, *geom))


def composite(lists, counts, mean2d_s, conic_s, rgb_s, depth_s, opac_s, *,
              height: int, width: int, tiles_x: int, tiles_y: int,
              tile_px: int, bg: torch.Tensor,
              spill: Optional[torch.Tensor] = None,
              chunk: int = 64) -> CompositeOut:
    """Composite depth-ordered, tile-binned Gaussians into an image. The
    ``*_s`` tensors are in the index space ``lists`` holds."""
    out = composite_lists(lists, counts, mean2d_s, conic_s, rgb_s, depth_s,
                          opac_s, tiles_x=tiles_x, tile_px=tile_px,
                          chunk=chunk)
    color, depth, trans = tiles_to_image(
        out, bg, height=height, width=width, tiles_x=tiles_x,
        tiles_y=tiles_y, tile_px=tile_px)
    if spill is None:
        spill = torch.zeros((), dtype=torch.int32, device=out.device)
    return CompositeOut(color, depth, trans, spill)


def lift_weights(lists, counts, order, mean2d_s, conic_s, opac_s, mask_img, *,
                 num_gaussians: int, height: int, width: int, tiles_x: int,
                 tiles_y: int, tile_px: int, chunk: int = 64
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lift a per-pixel mask to per-Gaussian (weight, hit count) sums: every
    Gaussian that CONTRIBUTES to a pixel (applied, and alpha > 0 after the
    skip rules) adds the pixel's mask value and one hit. Returns ([N], [N])
    in original Gaussian index space (through ``order`` when given)."""
    dev = mean2d_s.device
    p = tile_px * tile_px
    live, lists = _chunks(lists, counts, chunk)
    hp, wp = tiles_y * tile_px, tiles_x * tile_px
    m = torch.nn.functional.pad(mask_img.float(),
                                (0, wp - width, 0, hp - height))
    m = m.reshape(tiles_y, tile_px, tiles_x, tile_px).transpose(1, 2).reshape(
        tiles_x * tiles_y, p)  # [T, P]
    weights = torch.zeros(num_gaussians, dtype=torch.float32, device=dev)
    hits = torch.zeros(num_gaussians, dtype=torch.float32, device=dev)
    slot = torch.arange(chunk, device=dev)
    group = _tile_group(chunk, p)
    for g0 in range(0, live.numel(), group):
        tiles = live[g0:g0 + group]
        px, py = _pixel_coords(tiles, tiles_x, tile_px)
        cnt = counts[tiles].long()
        trans = torch.ones(tiles.numel(), 1, p, device=dev)
        for base in range(0, int(cnt.max()), chunk):
            idx = lists[tiles, base:base + chunk].long()
            valid = (base + slot)[None, :] < cnt[:, None]
            eff = _effective_alpha(mean2d_s[idx], conic_s[idx], opac_s[idx],
                                   valid, px, py)
            one_minus = 1.0 - eff
            applied = trans * torch.cumprod(one_minus, dim=1) >= T_EPS
            contrib = (applied & (eff > 0.0)).float()  # [G, C, P]
            orig = (idx if order is None else order[idx].long()).reshape(-1)
            weights.index_add_(0, orig, torch.einsum(
                "gcp,gp->gc", contrib, m[tiles]).reshape(-1))
            hits.index_add_(0, orig, contrib.sum(dim=2).reshape(-1))
            trans = trans * ordered_prod(torch.where(
                applied, one_minus, torch.ones_like(one_minus)), 1)[:, None]
    return weights, hits
