"""Plain 3D Gaussian Splatting: preprocess, a tiled per-pixel compositor and
its gradients by autograd.

The semantics are those of the upstream rasterizer
(``cuda_rasterizer/forward.cu``): near cull at view z 0.2, the EWA
projection with the 0.3 low-pass and the 1.3 x FoV clamp, radius
ceil(3 sqrt(lambda_max)), SH colour + 0.5 clamped at 0, each Gaussian
visited by the pixels of the tiles its screen rectangle covers, in exact
depth order; a pixel skips alpha < 1/255 and power > 0, clamps alpha at
0.99 and stops before the Gaussian that would take its transmittance below
1e-4. Written from those rules, in plain torch, with no code of the program:
every product goes through ``Precision`` so that the control can round its
operands.

Each pixel's walk is a masked cumulative product over the depth-sorted list
of its tile, evaluated for blocks of tiles at a time. ``render`` gives the
image without a graph; ``render_grads`` gives the image and the gradients
of a scalar loss of it with respect to the raw parameters, recomputing one
block of tiles at a time under autograd so that memory stays bounded.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from benchmark.reference.precision import Precision

NEAR_Z = 0.2
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-4
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
# (pair, pixel) evaluations held at once by one block of tiles, on the CPU
# and on a card
BLOCK_ELEMENTS = {"cpu": 1 << 22, "cuda": 1 << 26}
PARAM_NAMES = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
               "rotation")


class Projected(NamedTuple):
    mean2d: torch.Tensor  # [N, 2] pixel coordinates
    depth: torch.Tensor  # [N] view z
    conic: torch.Tensor  # [N, 3] (a, b, c) of the inverse 2D covariance
    radius: torch.Tensor  # [N] pixels, 0 where not visible
    rgb: torch.Tensor  # [N, 3]
    opacity: torch.Tensor  # [N]
    visible: torch.Tensor  # [N] bool


class Image(NamedTuple):
    color: torch.Tensor  # [H, W, 3], background blended in
    depth: torch.Tensor  # [H, W]
    final_t: torch.Tensor  # [H, W]
    evaluated: int  # (Gaussian, pixel) pairs visited before each stop
    contributed: int  # of them, those that blended


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """[N, 3] unit directions -> [N, (degree+1)^2] real SH basis."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
                SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if degree >= 3:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def quat_rotation(q: torch.Tensor) -> torch.Tensor:
    """Normalised wxyz quaternions [N, 4] -> rotations [N, 3, 3]."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def project(params: Dict[str, torch.Tensor], cam: Dict[str, torch.Tensor],
            sh_degree: int, prec: Optional[Precision] = None) -> Projected:
    """Raw parameters (log scales, opacity logits, unnormalised quaternions)
    and a camera -> screen-space Gaussians."""
    p = prec or Precision()
    xyz = params["xyz"]
    n = xyz.shape[0]
    w2c, full = cam["w2c"], cam["full_proj"]
    h, w = int(cam["height"]), int(cam["width"])
    xyz_h = torch.cat([xyz, torch.ones(n, 1, dtype=xyz.dtype,
                                       device=xyz.device)], dim=1)
    view = p(xyz_h) @ p(w2c.T)
    depth = view[:, 2]
    in_front = depth > NEAR_Z
    hom = p(xyz_h) @ p(full.T)
    inv_w = 1.0 / (hom[:, 3] + 1e-7)
    mean2d = torch.stack([((hom[:, 0] * inv_w + 1.0) * w - 1.0) * 0.5,
                          ((hom[:, 1] * inv_w + 1.0) * h - 1.0) * 0.5], -1)

    rot = quat_rotation(params["rotation"])
    m = rot * torch.exp(params["scaling"])[:, None, :]
    cov3 = p(m) @ p(m.transpose(1, 2))
    tan_x, tan_y = float(cam["tan_half_fovx"]), float(cam["tan_half_fovy"])
    fx, fy = w / (2.0 * tan_x), h / (2.0 * tan_y)
    tz = torch.where(in_front, depth, torch.ones_like(depth))
    tx = torch.clamp(view[:, 0] / tz, -1.3 * tan_x, 1.3 * tan_x) * tz
    ty = torch.clamp(view[:, 1] / tz, -1.3 * tan_y, 1.3 * tan_y) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
        torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)], 1)
    t = p(jac) @ p(w2c[:3, :3])
    cov2 = p(t) @ p(cov3) @ p(t.transpose(1, 2))
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det > 0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det,
                                                    torch.ones_like(det)),
                          torch.zeros_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=1e-12)))
    on_screen = ((mean2d[:, 0] + radius > 0) & (mean2d[:, 0] - radius < w)
                 & (mean2d[:, 1] + radius > 0)
                 & (mean2d[:, 1] - radius < h))
    visible = in_front & det_ok & on_screen

    dirs = xyz - cam["campos"][None, :]
    dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
                   + 1e-12)
    feats = torch.cat([params["features_dc"], params["features_rest"]], 1)
    k = (sh_degree + 1) ** 2
    basis = sh_basis(dirs, sh_degree)
    rgb = (p(basis[:, None, :]) @ p(feats[:, :k])).squeeze(1) + 0.5
    rgb = torch.clamp(rgb, min=0.0)
    radius = torch.where(visible, radius, torch.zeros_like(radius))
    return Projected(mean2d, depth, conic, radius.detach(), rgb,
                     torch.sigmoid(params["opacity"]).reshape(n), visible)


class Pairs(NamedTuple):
    gauss: torch.Tensor  # [P] Gaussian of each (tile, Gaussian) pair,
    # tile-major, depth order within a tile
    starts: torch.Tensor  # [T]
    counts: torch.Tensor  # [T]
    tiles_x: int
    tiles_y: int


def bin_pairs(pr: Projected, height: int, width: int, tile_px: int,
              depth_levels: bool = False) -> Pairs:
    """Every (tile, Gaussian) pair of a visible Gaussian and a tile that its
    screen rectangle (mean ± radius, on the tile grid) covers, sorted by
    tile and then by exact depth. ``depth_levels`` (a diagnosis only)
    orders by depth cut to the levels of a 31-bit [tile | depth] key
    instead, ties by Gaussian."""
    tiles_x = -(-width // tile_px)
    tiles_y = -(-height // tile_px)
    m, r = pr.mean2d.detach(), pr.radius
    x0 = torch.clamp(torch.floor((m[:, 0] - r) / tile_px), 0, tiles_x)
    y0 = torch.clamp(torch.floor((m[:, 1] - r) / tile_px), 0, tiles_y)
    x1 = torch.clamp(torch.floor((m[:, 0] + r + tile_px - 1) / tile_px), 0,
                     tiles_x)
    y1 = torch.clamp(torch.floor((m[:, 1] + r + tile_px - 1) / tile_px), 0,
                     tiles_y)
    nx = (x1 - x0).long()
    cnt = torch.where(pr.visible, nx * (y1 - y0).long(),
                      torch.zeros_like(nx))
    dev = m.device
    ids = torch.repeat_interleave(torch.arange(len(cnt), device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    local = torch.arange(len(ids), device=dev) - first[ids]
    tx = x0.long()[ids] + local % nx[ids]
    ty = y0.long()[ids] + local // nx[ids]
    tile = ty * tiles_x + tx
    depth = pr.depth.detach()
    if depth_levels:
        bits = 31 - max(int(tiles_x * tiles_y + 1).bit_length(), 1)
        d = depth[pr.visible]
        lo, hi = d.min(), d.max()
        depth = torch.clamp(((depth - lo) / torch.clamp(hi - lo, min=1e-12))
                            .clamp(0, 1) * ((1 << bits) - 1), 0,
                            (1 << bits) - 1).to(torch.int32).to(torch.int64)
    rank = torch.empty_like(cnt)
    rank[torch.argsort(depth, stable=True)] = torch.arange(
        len(cnt), device=dev)
    order = torch.argsort(tile * len(cnt) + rank[ids], stable=True)
    num = tiles_x * tiles_y
    counts = torch.bincount(tile, minlength=num)
    starts = torch.cumsum(counts, 0) - counts
    return Pairs(ids[order], starts, counts, tiles_x, tiles_y)


def _tile_blocks(counts: torch.Tensor, pixels: int):
    """Tiles in blocks of similar length whose (slot, pixel) evaluations fit
    ``BLOCK_ELEMENTS``: (tile ids, padded length) a block."""
    budget = BLOCK_ELEMENTS[counts.device.type]
    c = counts.cpu()
    order = torch.argsort(c, descending=True, stable=True)
    c = c[order]
    out, i = [], 0
    while i < len(order):
        length = max(int(c[i]), 1)
        take = max(1, budget // (length * pixels))
        out.append((order[i:i + take], length))
        i += take
    return out


def _composite_block(pr: Projected, feats, pairs: Pairs, tiles, length: int,
                     tile_px: int, height: int, width: int):
    """One block of tiles: (color [B,P,3], depth [B,P], final T [B,P],
    evaluated, contributed, flat pixel ids [B,P], inside [B,P])."""
    mean2d, conic, rgb, depth, opac = feats
    dev = mean2d.device
    tiles = tiles.to(dev)
    slot = torch.arange(length, device=dev)
    ok = slot[None, :] < pairs.counts[tiles][:, None]
    pos = torch.clamp(pairs.starts[tiles][:, None] + slot[None, :], max=max(
        len(pairs.gauss) - 1, 0))
    g = torch.where(ok, pairs.gauss[pos] if len(pairs.gauss) else
                    torch.zeros_like(pos), torch.zeros_like(pos))
    pix = torch.arange(tile_px * tile_px, device=dev)
    px = ((tiles % pairs.tiles_x) * tile_px)[:, None] + pix[None, :] % tile_px
    py = ((tiles // pairs.tiles_x) * tile_px)[:, None] + pix[None, :] // tile_px
    inside = (px < width) & (py < height)
    dx = mean2d[g][:, :, None, 0] - px[:, None, :].float()
    dy = mean2d[g][:, :, None, 1] - py[:, None, :].float()
    cg = conic[g]
    power = (-0.5 * (cg[:, :, None, 0] * dx * dx + cg[:, :, None, 2] * dy * dy)
             - cg[:, :, None, 1] * dx * dy)
    alpha = torch.clamp(opac[g][:, :, None] * torch.exp(power),
                        max=ALPHA_MAX)
    valid = ok[:, :, None] & (power <= 0) & (alpha >= ALPHA_MIN)
    a = torch.where(valid, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - a
    t_incl = torch.cumprod(one_minus, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    keep = valid & (t_incl >= T_STOP)
    wgt = torch.where(keep, a * t_excl, torch.zeros_like(a))
    color = torch.einsum("blp,blc->bpc", wgt, rgb[g])
    dimg = (wgt * depth[g][:, :, None]).sum(1)
    final_t = torch.where(keep, one_minus, torch.ones_like(a)).prod(1)
    seen = ok[:, :, None] & (t_excl >= T_STOP) & inside[:, None, :]
    evaluated = int(seen.sum())
    contributed = int((keep & inside[:, None, :]).sum())
    flat = torch.clamp(py, max=height - 1) * width + torch.clamp(
        px, max=width - 1)
    return color, dimg, final_t, evaluated, contributed, flat, inside


def _features(pr: Projected):
    return (pr.mean2d, pr.conic, pr.rgb, pr.depth, pr.opacity)


def composite(pr: Projected, height: int, width: int, bg: torch.Tensor,
              tile_px: int, feats=None, depth_levels: bool = False) -> Image:
    """The image of projected Gaussians (no graph unless ``feats`` carry
    one)."""
    feats = feats or tuple(f.detach() for f in _features(pr))
    pairs = bin_pairs(pr, height, width, tile_px, depth_levels)
    dev = pr.mean2d.device
    color = torch.zeros(height * width, 3, device=dev)
    dimg = torch.zeros(height * width, device=dev)
    tfin = torch.ones(height * width, device=dev)
    n_eval = n_contrib = 0
    for tiles, length in _tile_blocks(pairs.counts, tile_px * tile_px):
        c, d, t, ev, co, flat, inside = _composite_block(
            pr, feats, pairs, tiles, length, tile_px, height, width)
        sel = flat[inside]
        color = color.index_put((sel,), c[inside])
        dimg = dimg.index_put((sel,), d[inside])
        tfin = tfin.index_put((sel,), t[inside])
        n_eval += ev
        n_contrib += co
    color = color + tfin[:, None] * bg[None, :]
    return Image(color.reshape(height, width, 3), dimg.reshape(height, width),
                 tfin.reshape(height, width), n_eval, n_contrib)


def render(params, cam, sh_degree: int, bg: torch.Tensor, tile_px: int,
           prec: Optional[Precision] = None,
           depth_levels: bool = False) -> Image:
    """Render without gradients."""
    with torch.no_grad():
        pr = project(params, cam, sh_degree, prec)
        return composite(pr, int(cam["height"]), int(cam["width"]), bg,
                         tile_px, depth_levels=depth_levels)


def render_grads(params: Dict[str, torch.Tensor], cam, sh_degree: int,
                 bg: torch.Tensor, tile_px: int,
                 loss_fn: Callable[[torch.Tensor], torch.Tensor],
                 prec: Optional[Precision] = None):
    """(loss, image, gradients of ``loss_fn(image)`` by parameter name).

    The image is composited without a graph; the loss's gradient with
    respect to it is then carried back one block of tiles at a time,
    recomputed under autograd from detached screen-space features, and the
    features' gradients through the preprocess to the parameters."""
    h, w = int(cam["height"]), int(cam["width"])
    leaves = {k: params[k].detach().clone().requires_grad_(True)
              for k in PARAM_NAMES}
    pr = project(leaves, cam, sh_degree, prec)
    img = composite(pr, h, w, bg, tile_px)
    img_leaf = img.color.detach().requires_grad_(True)
    loss = loss_fn(img_leaf)
    (g_img,) = torch.autograd.grad(loss, [img_leaf])
    g_flat = g_img.reshape(h * w, 3)
    feats = [f.detach().requires_grad_(True) for f in _features(pr)]
    acc = [torch.zeros_like(f) for f in feats]
    pairs = bin_pairs(pr, h, w, tile_px)
    for tiles, length in _tile_blocks(pairs.counts, tile_px * tile_px):
        c, _, t, _, _, flat, inside = _composite_block(
            pr, feats, pairs, tiles, length, tile_px, h, w)
        g = g_flat[flat] * inside[..., None]
        out = (c * g).sum() + (t * (g * bg).sum(-1)).sum()
        grads = torch.autograd.grad(out, feats, allow_unused=True)
        for a, gr in zip(acc, grads):
            if gr is not None:
                a += gr
    outs = [f for f in _features(pr)]
    use = [(o, a) for o, a in zip(outs, acc) if o.requires_grad]
    torch.autograd.backward([o for o, _ in use], [a for _, a in use])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return loss.detach(), img, grads


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def _window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    return (g / g.sum()).float()


def ssim(a: torch.Tensor, b: torch.Tensor, prec: Optional[Precision] = None,
         size: int = 11) -> torch.Tensor:
    """Mean SSIM of [H, W, C] images: an 11-tap Gaussian window of sigma
    1.5 with zero padding, C1 = 0.01^2, C2 = 0.03^2 (the upstream
    ``loss_utils.ssim``), the blur as two 1-D convolutions."""
    p = prec or Precision()
    win = _window(size).to(a.device)
    maps = torch.stack([a, b, a * a, b * b, a * b]).permute(0, 3, 1, 2)
    k, c = maps.shape[0], maps.shape[1]
    x = maps.reshape(1, k * c, *maps.shape[2:])
    wy = win.reshape(1, 1, size, 1).expand(k * c, 1, size, 1)
    wx = win.reshape(1, 1, 1, size).expand(k * c, 1, 1, size)
    x = torch.nn.functional.conv2d(p(x), p(wy), padding=(size // 2, 0),
                                   groups=k * c)
    x = torch.nn.functional.conv2d(p(x), p(wx), padding=(0, size // 2),
                                   groups=k * c)
    mu1, mu2, s11, s22, s12 = x.reshape(k, c, *x.shape[2:])
    s11, s22, s12 = s11 - mu1 * mu1, s22 - mu2 * mu2, s12 - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)
    return (num / den).mean()


def lr_log_linear(init: float, final: float, max_steps: int,
                  step: int) -> float:
    """The upstream ``get_expon_lr_func`` without its warm-up delay (the
    recipe's delay steps are 0)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def adam(params, grads, state, lrs: Dict[str, float], eps: float,
         b1: float = 0.9, b2: float = 0.999):
    """One Adam step of every group (``torch.optim.Adam``'s rule, bias
    corrections at the new count) -> (params, state)."""
    new_p, new_s = {}, {}
    for k in params:
        st = state[k]
        count = st["count"] + 1
        mu = b1 * st["mu"] + (1 - b1) * grads[k]
        nu = b2 * st["nu"] + (1 - b2) * grads[k] * grads[k]
        m_hat = mu / (1 - b1 ** count)
        v_hat = nu / (1 - b2 ** count)
        new_p[k] = params[k] - lrs[k] * m_hat / (torch.sqrt(v_hat) + eps)
        new_s[k] = {"mu": mu, "nu": nu, "count": count}
    return new_p, new_s
