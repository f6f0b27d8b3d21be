"""Plain DGE edit round: the reference's multi-view InstructPix2Pix edit
(threestudio/models/guidance/dge_guidance.py and utils/dge_utils.py).

One round over ``B`` ring-ordered views in camera batches of ``cbs``: VAE
posterior samples of the renders and means of the original renders; noise
added at ``t_start``; 20 DDIM steps (``diffusers`` DDIMScheduler, SD's
scaled-linear betas, ``steps_offset`` 1, eta 0) over a schedule truncated
to ``t_start``; at each step from t >= 100 one random pivot a camera batch,
an attention pass over the pivots that records each block's states, then
one pass over all views that reuses the pivots' attention outputs under the
epipolar constraint (batch 0 takes its closest key twice, blend 1), plain
attention below t = 100; IP2P's 3-way classifier-free guidance; VAE
decode. Every random number is drawn from the generator in the order the
round draws it: the posterior noise a camera batch of the encoder, the
start noise, then the pivots of each step.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.reference import sd15


# ---- DDIM (diffusers DDIMScheduler, eta 0) ----

def alphas_cumprod(device, n: int = 1000, lo: float = 0.00085,
                   hi: float = 0.012) -> torch.Tensor:
    betas = torch.linspace(lo ** 0.5, hi ** 0.5, n, dtype=torch.float32,
                           device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def timesteps(t_train: int, steps: int, offset: int = 1) -> List[int]:
    ratio = t_train // steps
    return [int(i * ratio) + offset for i in reversed(range(steps))]


def ddim_step(ac, eps, t: int, x, t_train: int, steps: int):
    prev = t - t_train // steps
    a_t = ac[t]
    a_prev = ac[prev] if prev >= 0 else ac[0]
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


# ---- epipolar geometry (graphics_utils.py, dge_utils.py) ----

def pixel_projection(full_proj, h: int, w: int):
    ndc2pix = torch.tensor([[w / 2.0, 0.0, w / 2.0], [0.0, h / 2.0, h / 2.0],
                            [0.0, 0.0, 1.0]], device=full_proj.device)
    return ndc2pix @ full_proj[..., [0, 1, 3], :]


def fundamental(p1, p2):
    """F with x2^T F x1 = 0 from pixel projections [..., 3, 4]
    (Hartley & Zisserman eq. 17.3)."""
    def rows(p):
        return [p[..., 1:3, :], torch.cat([p[..., 2:3, :], p[..., 0:1, :]],
                                          -2), p[..., 0:2, :]]

    x, y = rows(p1), rows(p2)
    dets = [torch.linalg.det(torch.cat([xi, yj], -2)) for yj in y for xi in x]
    return torch.stack(dets, -1).reshape(p1.shape[:-2] + (3, 3))


def pixel_grid(h: int, w: int, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(h * w, device=device)], 1)


def cross_view(full_proj, campos, key_proj, key_pos, pivot: int, lat_h: int,
               lat_w: int, n_key: int, threshold: float) -> sd15.CrossView:
    """One camera batch's keys, blend and epipolar lines."""
    d = torch.linalg.vector_norm(campos[:, None] - key_pos[None], dim=-1)
    closest = torch.argsort(d, dim=-1, stable=True)[:, :n_key]
    ds = torch.sort(d, dim=-1).values
    f = d.shape[0]
    w1 = (torch.sigmoid(ds[:, 1] / (ds[:, 0] + ds[:, 1] + 1e-12))
          if n_key == 2 else torch.ones(f, device=d.device))
    is_pivot = (torch.arange(f, device=d.device) == pivot)[:, None, None,
                                                           None]
    lines, pts = {}, {}
    for down in (1, 2, 4, 8):
        h, w = lat_h // down, lat_w // down
        fm = fundamental(pixel_projection(key_proj[closest.reshape(-1)], h,
                                          w),
                         pixel_projection(full_proj.repeat_interleave(
                             n_key, 0), h, w))
        ln = pixel_grid(h, w, d.device) @ fm
        ln = ln / torch.clamp(torch.linalg.vector_norm(ln[..., :2], dim=-1,
                                                       keepdim=True),
                              min=1e-12)
        lines[h * w] = torch.where(is_pivot, 0.0,
                                   ln.reshape(f, n_key, h * w, 3))
        pts[h * w] = pixel_grid(h, w, d.device)
    if n_key == 1:
        closest = torch.cat([closest, closest], 1)
        w1 = torch.ones_like(w1)
        lines = {s: torch.cat([v, v], 1) for s, v in lines.items()}
    return sd15.CrossView(closest, w1, lines, pts, 2, threshold)


def concat_views(states: List[sd15.CrossView]) -> sd15.CrossView:
    return sd15.CrossView(
        torch.cat([s.closest for s in states]),
        torch.cat([s.blend_w1 for s in states]),
        {k: torch.cat([s.lines[k] for s in states]) for k in states[0].lines},
        states[0].pts, 2, states[0].threshold)


def ring_order(centers: np.ndarray, forwards: np.ndarray) -> List[int]:
    """DGE's sort_the_cameras_idx: the signed angle of each camera's
    forward vector from the leftmost camera's, the sense of rotation fixed
    by its nearest neighbour."""
    f = np.asarray(forwards, np.float64)
    f = f / np.linalg.norm(f, axis=1, keepdims=True)
    mlv = f[int(np.argmin(centers[:, 0]))]
    d0 = np.arccos(np.clip(f @ mlv, 0.0, 1.0))
    second = f[np.argsort(d0, kind="stable")[1]]
    axis = np.cross(mlv, second)
    ang = np.arccos(np.clip(f @ mlv, -1.0, 1.0))
    sign = np.cross(np.broadcast_to(mlv, f.shape), f) @ axis
    signed = np.where(sign >= 0, ang, 2.0 * np.pi - ang)
    return [int(i) for i in np.argsort(signed, kind="stable")]


# ---- the round ----

def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def edit_round(unet: sd15.UNet, vae: sd15.VAE, rgb, cond_rgb, emb_pos,
               emb_neg, full_proj, campos, gen: torch.Generator,
               recipe: dict, t_start: int, latent_channels: int = 4):
    """rgb, cond_rgb [B, H, W, 3] in [0, 1] (ring order), text states
    [B, S, D], the views' full projections [B, 4, 4] and centres [B, 3]
    -> the edited images [B, H, W, 3]."""
    b, h, w, _ = rgb.shape
    cbs = int(recipe["camera_batch_size"])
    steps = int(recipe["diffusion_steps"])
    gs, cs = float(recipe["guidance_scale"]), float(recipe["condition_scale"])
    thr = float(recipe["epipolar_threshold"])
    dev = rgb.device
    lat_h, lat_w = h // vae.down, w // vae.down
    lat, cond = [], []
    for i in range(0, b, cbs):
        noise = torch.randn((min(cbs, b - i), lat_h, lat_w, latent_channels),
                            generator=gen, device=dev)
        lat.append(nhwc(vae.encode(nchw(rgb[i:i + cbs]) * 2 - 1,
                                   nchw(noise))))
        cond.append(nhwc(vae.encode(nchw(cond_rgb[i:i + cbs]) * 2 - 1)))
    lat, cond = torch.cat(lat), torch.cat(cond)
    ac = alphas_cumprod(dev)
    t_train = max(t_start, steps)
    noise = torch.randn(tuple(lat.shape), generator=gen, device=dev)
    x = torch.sqrt(ac[t_start]) * lat + torch.sqrt(1 - ac[t_start]) * noise
    zero = torch.zeros_like(cond)

    def unet_in(idx, lat_x):
        te = torch.cat([emb_pos[idx], emb_neg[idx], emb_neg[idx]])
        cl = torch.cat([cond[idx], cond[idx], zero[idx]])
        x3 = torch.cat([lat_x[idx]] * 3)
        return nchw(torch.cat([x3, cl], -1)), te

    def cfg(eps):
        e_t, e_i, e_u = eps.chunk(3)
        return e_u + gs * (e_t - e_i) + cs * (e_i - e_u)

    n_batches = b // cbs
    for t in timesteps(t_train, steps):
        if t < 100:
            parts = []
            for i in range(n_batches):
                inp, te = unet_in(torch.arange(i * cbs, (i + 1) * cbs,
                                               device=dev), x)
                parts.append(nhwc(unet(inp, t, te)).chunk(3))
            eps = torch.cat([torch.cat([p[k] for p in parts])
                             for k in range(3)])
        else:
            off = torch.randint(0, cbs, (n_batches,), generator=gen,
                                device=dev).cpu().numpy()
            piv = torch.as_tensor(off + np.arange(0, b, cbs), device=dev)
            record: dict = {}
            inp, te = unet_in(piv, x)
            unet(inp, t, te, mode="pivot_record", pivot=record)
            states = []
            for i in range(n_batches):
                sl = slice(i * cbs, (i + 1) * cbs)
                states.append(cross_view(
                    full_proj[sl], campos[sl], full_proj[piv], campos[piv],
                    int(off[i]), lat_h, lat_w, 1 if i == 0 else 2, thr))
            inp, te = unet_in(torch.arange(b, device=dev), x)
            eps = nhwc(unet(inp, t, te, mode="pivot_reuse",
                            cross_view=concat_views(states), pivot=record))
        x = ddim_step(ac, cfg(eps), t, x, t_train, steps)
    out = [nhwc(vae.decode(nchw(x[i:i + cbs]))) * 0.5 + 0.5
           for i in range(0, b, cbs)]
    return torch.clamp(torch.cat(out), 0.0, 1.0)


def pass_flops(unet: sd15.UNet, vae: sd15.VAE, views: int, height: int,
               width: int, cbs: int, text_len: int, text_dim: int,
               device="meta") -> dict:
    """``FlopCounterMode``'s count of each kind of pass the round runs, at
    the round's shapes: the pivot pass over one pivot a camera batch, the
    reuse pass over all views, a plain pass over one camera batch, and the
    VAE's sample, mean and decode of one camera batch. On the meta device
    the networks run on shapes alone."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = torch.device(device)
    unet, vae = unet.to(dev), vae.to(dev)
    lh, lw = height // vae.down, width // vae.down
    nb = views // cbs

    def count(fn) -> float:
        with FlopCounterMode(display=False) as fc:
            fn()
        return float(fc.get_total_flops())

    def zeros(*shape):
        return torch.zeros(*shape, device=dev)

    def pass_in(frames):
        return zeros(3 * frames, 8, lh, lw), zeros(3 * frames, text_len,
                                                   text_dim)

    out, record = {}, {}
    inp, te = pass_in(nb)
    out["pivot"] = count(lambda: unet(inp, 500, te, mode="pivot_record",
                                      pivot=record))
    lines = {}
    for down in (1, 2, 4, 8):
        s = (lh // down) * (lw // down)
        if s:
            lines[s] = zeros(views, 2, s, 3)
    cv = sd15.CrossView(
        torch.zeros(views, 2, dtype=torch.long, device=dev) % max(nb, 1),
        zeros(views), lines, {s: zeros(s, 3) for s in lines}, 2)
    inp, te = pass_in(views)
    out["reuse"] = count(lambda: unet(inp, 500, te, mode="pivot_reuse",
                                      cross_view=cv, pivot=record))
    inp, te = pass_in(cbs)
    out["plain"] = count(lambda: unet(inp, 50, te))
    img = zeros(cbs, 3, height, width)
    out["encode"] = count(lambda: vae.encode(img, zeros(cbs, 4, lh, lw)))
    out["encode_mean"] = count(lambda: vae.encode(img))
    out["decode"] = count(lambda: vae.decode(zeros(cbs, 4, lh, lw)))
    return out


def round_flops(passes: dict, views: int, recipe: dict, t_start: int
                ) -> float:
    """A round's operations from ``pass_flops``' counts: the VAE over every
    camera batch, a pivot and a reuse pass each step from t >= 100, a plain
    pass a camera batch each step below."""
    cbs = int(recipe["camera_batch_size"])
    steps = int(recipe["diffusion_steps"])
    ts = timesteps(max(t_start, steps), steps)
    pivot_steps = sum(1 for t in ts if t >= 100)
    nb = views // cbs
    return (nb * (passes["encode"] + passes["encode_mean"] + passes["decode"])
            + pivot_steps * (passes["pivot"] + passes["reuse"])
            + (steps - pivot_steps) * nb * passes["plain"])
