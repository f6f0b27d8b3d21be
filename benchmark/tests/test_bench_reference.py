"""The plain reference and the work counts on the CPU, at tiny sizes."""

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark.reference import dge, raster, sd15
from benchmark.reference.precision import Precision, round_fp8, round_tf32
from benchmark.yardstick import scene as S
from benchmark.yardstick import work as WK

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_UNET = {"in_channels": 8, "out_channels": 4, "block_out_channels":
             [32, 64], "layers_per_block": 1, "cross_attention_dim": 32,
             "attention_head_dim": 2, "norm_num_groups": 8}
TINY_VAE = {"in_channels": 3, "latent_channels": 4, "block_out_channels":
            [16, 32], "layers_per_block": 1, "norm_num_groups": 8,
            "scaling_factor": 0.18215}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tiny_scene(seed=3, n=60):
    rng = np.random.default_rng(seed)
    arr = S.gt_scene(seed, scale=0.001)
    arr = {k: v[:n] for k, v in arr.items()}
    arr["opacity"] = rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)
    return {k: torch.as_tensor(v) for k, v in arr.items()}


def _pixel_walk(pr, height, width, tile, bg):
    """Upstream renderCUDA's walk, one pixel at a time in Python."""
    m = pr.mean2d.numpy().astype(np.float64)
    r = pr.radius.numpy()
    order = [int(i) for i in np.argsort(pr.depth.numpy(), kind="stable")
             if pr.visible[i]]
    out = np.zeros((height, width, 3))
    for y in range(height):
        for x in range(width):
            tx, ty = x // tile, y // tile
            t, c = 1.0, np.zeros(3)
            for i in order:
                x0 = max(0, math.floor((m[i, 0] - r[i]) / tile))
                y0 = max(0, math.floor((m[i, 1] - r[i]) / tile))
                x1 = math.floor((m[i, 0] + r[i] + tile - 1) / tile)
                y1 = math.floor((m[i, 1] + r[i] + tile - 1) / tile)
                if not (x0 <= tx < x1 and y0 <= ty < y1):
                    continue
                a, b, cc = pr.conic[i].tolist()
                dx, dy = m[i, 0] - x, m[i, 1] - y
                power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
                if power > 0:
                    continue
                alpha = min(0.99, float(pr.opacity[i]) * math.exp(power))
                if alpha < 1 / 255:
                    continue
                if t * (1 - alpha) < 1e-4:
                    break
                c += pr.rgb[i].numpy() * alpha * t
                t *= 1 - alpha
            out[y, x] = c + t * bg.numpy()
    return out


def test_reference_rasterizer_agrees_with_a_per_pixel_walk():
    params = _tiny_scene()
    cam = S.look_at(S.SCENE_TARGET + np.array([0.0, 0.8, -3.3]),
                    S.SCENE_TARGET, 20, 24, fovx=math.radians(60))
    cam = dict(cam, w2c=torch.as_tensor(cam["w2c"]),
               full_proj=torch.as_tensor(cam["full_proj"]),
               campos=torch.as_tensor(cam["campos"]))
    bg = torch.tensor([0.2, 0.5, 0.9])
    pr = raster.project(params, cam, 3)
    assert int(pr.visible.sum()) > 20
    img = raster.composite(pr, 20, 24, bg, tile_px=8)
    want = _pixel_walk(pr, 20, 24, 8, bg)
    np.testing.assert_allclose(img.color.numpy(), want, atol=2e-6)


def _stack(n, op=0.95):
    """``n`` huge Gaussians (alpha = opacity over the whole image) at
    depths 1..n."""
    return raster.Projected(
        mean2d=torch.full((n, 2), 4.0), depth=torch.arange(1.0, n + 1),
        conic=torch.tensor([[1e-9, 0.0, 1e-9]] * n),
        radius=torch.full((n,), 100.0), rgb=torch.rand(n, 3),
        opacity=torch.full((n,), op), visible=torch.ones(n, dtype=torch.bool))


def test_visit_counts_equal_a_hand_count():
    """alpha 0.95: T falls 0.05, 2.5e-3, 1.25e-4 (three blend), the fourth
    would take it to 6.25e-6 and stops the pixel: 4 visits, 3 blends a
    pixel; the fifth is never visited."""
    img = raster.composite(_stack(5), 8, 8, torch.zeros(3), tile_px=8)
    assert (img.evaluated, img.contributed) == (4 * 64, 3 * 64)
    np.testing.assert_allclose(img.final_t.numpy(), 0.05 ** 3, rtol=1e-5)
    f = WK.forward_work(img.evaluated, 5, 64)
    ops = WK.OPS
    assert f["flops"] == 256 * ops["forward_per_visit"]
    assert f["bytes"] == 5 * 40 + 64 * 20


def test_skipped_pairs_are_visited_but_do_not_blend():
    pr = _stack(3)
    pr = pr._replace(opacity=torch.tensor([0.95, 0.001, 0.95]))
    img = raster.composite(pr, 8, 8, torch.zeros(3), tile_px=8)
    assert (img.evaluated, img.contributed) == (3 * 64, 2 * 64)


def test_render_grads_agree_with_autograd_through_one_block():
    params = _tiny_scene(n=40)
    cam = S.look_at(S.SCENE_TARGET + np.array([0.0, 0.8, -3.3]),
                    S.SCENE_TARGET, 16, 16)
    cam = dict(cam, w2c=torch.as_tensor(cam["w2c"]),
               full_proj=torch.as_tensor(cam["full_proj"]),
               campos=torch.as_tensor(cam["campos"]))
    target = torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(1))
    bg = torch.ones(3)

    def loss_fn(img):
        return 0.8 * raster.l1(img, target) + 0.2 * (
            1 - raster.ssim(img, target))

    loss, _, grads = raster.render_grads(params, cam, 3, bg, 8, loss_fn)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    pr = raster.project(leaves, cam, 3)
    feats = (pr.mean2d, pr.conic, pr.rgb, pr.depth, pr.opacity)
    img = raster.composite(pr, 16, 16, bg, 8, feats=feats)
    want = torch.autograd.grad(loss_fn(img.color), list(leaves.values()))
    assert abs(float(loss) - float(loss_fn(img.color).detach())) < 1e-6
    for k, w in zip(leaves, want):
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-8)


def test_operand_rounding():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -9, 3.0])
    np.testing.assert_array_equal(round_tf32(x).numpy(),
                                  [1.0, 1.0 + 2 ** -9, 3.0])
    y = torch.linspace(-2, 2, 101)
    assert float((round_fp8(y) - y).abs().max()) > 1e-3
    g = torch.ones(3, requires_grad=True)
    Precision("tf32")(g * 2).sum().backward()
    np.testing.assert_array_equal(g.grad.numpy(), [2.0, 2.0, 2.0])


def test_edit_flop_count_of_a_tiny_unet_matches_flop_counter_mode():
    """Each pass kind's count on the meta device (what ``edit.mfu`` reads)
    equals ``FlopCounterMode`` over the same networks on real CPU tensors,
    and a round's count is their sum over the round."""
    torch.manual_seed(0)
    unet, vae = sd15.UNet(TINY_UNET), sd15.VAE(TINY_VAE)
    real = dge.pass_flops(unet, vae, 4, 16, 16, 2, 7, 32, device="cpu")
    meta = dge.pass_flops(unet, vae, 4, 16, 16, 2, 7, 32, device="meta")
    assert meta == real and min(real.values()) > 0
    recipe = {"camera_batch_size": 2, "diffusion_steps": 20}
    # t_start 998: timesteps 932, 883, ..., 99, 50, 1; three below 100
    assert dge.timesteps(998, 20)[-4:] == [148, 99, 50, 1]
    assert dge.round_flops(real, 4, recipe, 998) == (
        2 * (real["encode"] + real["encode_mean"] + real["decode"])
        + 17 * (real["pivot"] + real["reuse"]) + 3 * 2 * real["plain"])


def test_reference_round_matches_the_port_in_float32():
    """At float32 the reference round and the program's guidance agree on
    the same inputs, draws and cameras (tiny networks)."""
    from dge_tpu_torch.diffusion import ip2p as P
    from dge_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from dge_tpu_torch.models.unet import UNetConfig
    from dge_tpu_torch.models.vae import VAEConfig
    from dge_tpu_torch.parallel.mesh import stack_cameras
    from dge_tpu_torch.systems import guidance as GD

    from benchmark.drivers import common as C
    from benchmark.yardstick import weights as WT

    with torch.device("meta"):
        nets = {"unet": sd15.UNet(TINY_UNET), "vae": sd15.VAE(TINY_VAE),
                "text_encoder": CLIPTextModel(CLIPTextConfig.tiny())}
    shapes = {k: sd15.names_and_shapes(m) for k, m in nets.items()}
    flat = [(f"{k}/{n}", s) for k, v in shapes.items() for n, s in v]
    d = WT.draw(flat, 5, "cpu", torch.float32)
    w = {k: {n: d[f"{k}/{n}"] for n, _ in v} for k, v in shapes.items()}
    models = P.build_models(UNetConfig.tiny(), VAEConfig.tiny(),
                            CLIPTextConfig.tiny(), params=w, device="cpu")
    unet, vae = sd15.UNet(TINY_UNET), sd15.VAE(TINY_VAE)
    unet.load_state_dict(w["unet"])
    vae.load_state_dict(w["vae"])
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "ip2p-sd15-bf16.json")) as f:
        rc = json.load(f)["recipe"]
    rc.update(camera_batch_size=2, diffusion_steps=3)
    cams = [C.program_camera(c, "cpu") for c in S.orbit_cameras(4, 64, 64)]
    guide = GD.DGEGuidance(GD.GuidanceConfig(
        camera_batch_size=2, diffusion_steps=3, batch_mode="vmap",
        resize_target=64, vae_batch=2), models)
    g = torch.Generator().manual_seed(0)
    rgb, cond = torch.rand(4, 64, 64, 3, generator=g), torch.rand(
        4, 64, 64, 3, generator=g)
    pos, neg = (torch.randn(1, 7, 32, generator=g).expand(4, -1, -1)
                for _ in range(2))
    got = guide(rgb, cond, pos, neg, stack_cameras(cams),
                torch.Generator().manual_seed(11), max_step=999)
    ref = dge.edit_round(unet, vae, rgb, cond, pos, neg,
                         torch.stack([c.full_proj for c in cams]),
                         torch.stack([c.campos for c in cams]),
                         torch.Generator().manual_seed(11), rc, 998)
    assert float((got - ref).abs().max()) < 1e-4


def test_ring_order_agrees_with_the_port():
    from dge_tpu_torch.systems.edit import _ring_order

    poses = S.orbit_cameras(20, 64, 64)
    centers = np.stack([c["campos"] for c in poses])
    fwd = np.stack([c["w2c"][2, :3] for c in poses])
    rng = np.random.default_rng(0)
    perm = rng.permutation(20)
    assert dge.ring_order(centers[perm], fwd[perm]) == _ring_order(
        centers[perm], fwd[perm])
