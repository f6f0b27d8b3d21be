"""The port's diffusion stack (``dge_tpu_torch/diffusion/``) and cross-view
state (``systems/guidance.make_cross_view_state``) against the JAX package's
on the CPU, the same numpy inputs through both.

Tolerances: the DDIM schedule, ``add_noise`` and ``step`` 1e-6;
``cfg_combine`` 1e-6; ``resize_to_64_multiple`` equal; fundamental
matrices 1e-5 relative to their largest entry, and lines, distances and
the dense violation mask from one F 1e-5 relative and equal (from each
package's own F see ``test_epipolar``; in the cross-view state the masks
are equal wherever the distance is farther than 1e-5 px from the 1 px
threshold: entries nearer it differ by float32 rounding);
``epi_blockwise_argmax`` indices equal wherever the JAX top-2 gap exceeds
1e-5. One
``edit_images_single_view`` call (4 views at 32^2, tiny models carried
across with ``*_params_from_jax``, the JAX draws handed to the port)
within 1e-3 absolute. Camera pairs are well conditioned: for cameras whose
baseline runs along their optical axes (opposite cameras of a ring) the
float32 fundamental matrix is ill-conditioned in both packages, and their
masks differ by rounding (ROADMAP.md §3)."""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.diffusion import ddim as JD
from dge_tpu.diffusion import epipolar as JE
from dge_tpu.diffusion import ip2p as JP
from dge_tpu.diffusion import tokenizer as JT
from dge_tpu.models import layers as JL
from dge_tpu.models.clip_text import CLIPTextConfig as JCC
from dge_tpu.models.unet import UNetConfig as JUC
from dge_tpu.models.vae import VAEConfig as JVC
from dge_tpu.parallel.mesh import stack_cameras as j_stack
from dge_tpu.scene import look_at_camera
from dge_tpu.scene.camera_arrays import CameraArrays as JCam
from dge_tpu.systems import guidance as JG
from dge_tpu_torch.diffusion import ddim as TD
from dge_tpu_torch.diffusion import epipolar as TE
from dge_tpu_torch.diffusion import ip2p as TP
from dge_tpu_torch.diffusion import tokenizer as TT
from dge_tpu_torch.diffusion import weights as TW
from dge_tpu_torch.models import layers as TL
from dge_tpu_torch.models.clip_text import CLIPTextConfig
from dge_tpu_torch.models.unet import UNetConfig
from dge_tpu_torch.models.vae import VAEConfig
from dge_tpu_torch.parallel.mesh import stack_cameras as t_stack
from dge_tpu_torch.scene.camera_arrays import CameraArrays as TCam
from dge_tpu_torch.systems import guidance as TG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDIT_TOL = 1e-3


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def arc_cameras(degrees, height=64, width=64, dist=3.5):
    """(JAX, port) cameras looking at the origin from the given azimuths."""
    js, ts = [], []
    for a in degrees:
        ang = math.radians(a)
        eye = np.array([dist * math.sin(ang), 0.3, -dist * math.cos(ang)])
        cam = look_at_camera(eye, np.zeros(3), fovx=math.radians(60),
                             height=height, width=width)
        js.append(JCam.from_camera(cam))
        ts.append(TCam.from_camera(cam, "cpu"))
    return js, ts


def rel_close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# ---- DDIM, CFG, resize ------------------------------------------------------

def test_ddim_schedule_noise_and_step():
    js, ts = JD.make_schedule(), TD.make_schedule(device="cpu")
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(),
                               np.asarray(js.alphas_cumprod), atol=1e-6)
    np.testing.assert_allclose(float(ts.final_alpha_cumprod),
                               float(js.final_alpha_cumprod), atol=1e-6)
    r = np.random.default_rng(0)
    x0, noise, eps = (r.normal(size=(3, 8, 8, 4)).astype(np.float32)
                      for _ in range(3))
    for t_start, steps in ((999, 20), (499, 4), (2, 4)):
        jsub = js._replace(num_train_timesteps=max(t_start, steps))
        tsub = ts._replace(num_train_timesteps=max(t_start, steps))
        jts = JD.inference_timesteps(jsub, steps)
        np.testing.assert_array_equal(TD.inference_timesteps(tsub, steps),
                                      jts)
        np.testing.assert_allclose(
            TD.add_noise(tsub, torch.from_numpy(x0), torch.from_numpy(noise),
                         t_start).numpy(),
            np.asarray(JD.add_noise(jsub, x0, noise,
                                    jnp.full((3,), t_start))), atol=1e-6)
        for t in jts:
            for eta in (0.0, 0.5):
                np.testing.assert_allclose(
                    TD.step(tsub, torch.from_numpy(eps), int(t),
                            torch.from_numpy(x0), steps, eta,
                            torch.from_numpy(noise)).numpy(),
                    np.asarray(JD.step(jsub, eps, jnp.asarray(int(t)), x0,
                                       steps, eta, noise)), atol=1e-6)


def test_cfg_combine_and_resize_rule():
    r = np.random.default_rng(1)
    e = [r.normal(size=(2, 4, 4, 4)).astype(np.float32) for _ in range(3)]
    np.testing.assert_allclose(
        TP.cfg_combine(*[torch.from_numpy(x) for x in e], 7.5, 1.5).numpy(),
        np.asarray(JP.cfg_combine(*e, 7.5, 1.5)), atol=1e-6)
    for h, w, target in ((512, 512, 512), (480, 640, 512), (32, 32, 64),
                         (256, 256, 512), (1080, 1920, 512), (200, 270, 64)):
        assert (TP.resize_to_64_multiple(h, w, target)
                == JP.resize_to_64_multiple(h, w, target))


@pytest.mark.parametrize("src,dst", [((512, 512), (256, 256)),
                                     ((480, 640), (200, 270)),
                                     ((256, 256), (512, 512))])
def test_guidance_resize_matches_jax_image_resize(src, dst):
    """The guidance's bilinear resize: antialiased like jax.image.resize
    when it shrinks (without antialiasing the two differ by ~0.3)."""
    x = np.random.default_rng(2).uniform(size=(2,) + src + (3,)).astype(
        np.float32)
    want = jax.image.resize(x, (2,) + dst + (3,), "bilinear")
    got = TG._resize(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---- epipolar geometry ---------------------------------------------------------

@pytest.mark.parametrize("a,b", [(0, 90), (30, 75), (10, 140), (0, 170)])
@pytest.mark.parametrize("hw", [(16, 16), (8, 12)])
def test_epipolar(a, b, hw):
    """F at 1e-5 relative; lines, distances and the dense mask from the
    same F at 1e-5 relative and equal. From each package's own F the
    lines' normalisation amplifies F's last-bit differences as the pair
    opens up (up to ~4e-5 at 170 degrees), so there the masks are held
    equal wherever the distance is 1e-3 px clear of the threshold."""
    (j1, j2), (t1, t2) = arc_cameras([a, b])
    h, w = hw
    jf = JE.fundamental_between(j1, j2, h, w)
    tf = TE.fundamental_between(t1, t2, h, w)
    rel_close(tf.numpy(), jf)
    same = torch.from_numpy(np.array(jf))
    rel_close(TE.epipolar_lines(same, h, w).numpy(),
              JE.epipolar_lines(jf, h, w))
    jd = np.asarray(JE.epipolar_distances(jf, h, w))
    rel_close(TE.epipolar_distances(same, h, w).numpy(), jd)
    np.testing.assert_array_equal(
        (TE.epipolar_distances(same, h, w) > 1.0).numpy(), jd > 1.0)
    clear = np.abs(jd - 1.0) > 1e-3
    got = TE.violation_mask(t1, t2, h, w).numpy()
    want = np.asarray(JE.violation_mask(j1, j2, h, w))
    np.testing.assert_array_equal(got[clear], want[clear])
    assert clear.mean() > 0.99
    d_t = TE.camera_distances(t_stack([t1, t2]), t_stack([t2]))
    d_j = JE.camera_distances(j_stack([j1, j2]), j_stack([j2]))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)


VIEWS = (0, 25, 50, 75)  # a forward arc: no pair looks along its baseline
KEYS = (12, 63)


@pytest.mark.parametrize("n_key", [1, 2])
@pytest.mark.parametrize("mode", ["banded", "dense"])
def test_cross_view_state(n_key, mode):
    """make_cross_view_state against JAX's at a 16x16 latent (S = 256, 64,
    16, 4): closest keys, blend, lines or masks, pixel grids."""
    jc, tc = arc_cameras(VIEWS)
    jk, tk = arc_cameras(KEYS, dist=3.4)
    jcv = JG.make_cross_view_state(j_stack(jc), j_stack(jk), jnp.asarray(2),
                                   16, 16, n_key, 1.0, mode)
    tcv = TG.make_cross_view_state(t_stack(tc), t_stack(tk), 2, 16, 16,
                                   n_key, 1.0, mode)
    np.testing.assert_array_equal(tcv.closest_cam.numpy(),
                                  np.asarray(jcv.closest_cam))
    np.testing.assert_allclose(tcv.blend_w1.numpy(), np.asarray(jcv.blend_w1),
                               atol=1e-6)
    if mode == "banded":
        assert set(tcv.epi_lines) == set(jcv.epi_lines) == {256, 64, 16, 4}
        for s in jcv.epi_lines:
            rel_close(tcv.epi_lines[s].numpy(), jcv.epi_lines[s])
            np.testing.assert_array_equal(tcv.epi_pts[s].numpy(),
                                          np.asarray(jcv.epi_pts[s]))
        assert not tcv.epi_lines[256][2].any()  # the pivot frame
    else:
        # grid points often lie exactly 1 px from a line: entries within
        # float32 rounding of the threshold may flip between the packages
        band = TG.make_cross_view_state(t_stack(tc), t_stack(tk), 2, 16, 16,
                                        n_key, 1.0, "banded")
        assert set(tcv.epipolar) == set(jcv.epipolar)
        for s in jcv.epipolar:
            dist = torch.einsum("fksc,tc->fkst", band.epi_lines[s],
                                band.epi_pts[s]).abs().numpy()
            clear = np.abs(dist - 1.0) > 1e-5
            got, want = tcv.epipolar[s].numpy(), np.asarray(jcv.epipolar[s])
            np.testing.assert_array_equal(got[clear], want[clear])
            assert (~clear).sum() <= 8


def test_blockwise_argmax_against_jax_and_dense():
    """epi_blockwise_argmax against the JAX function (blocks that do and do
    not divide S), with an all-violating row, equal where the JAX top-2 gap
    exceeds 1e-5; and the banded state against the dense one inside the
    port, through the block's gather."""
    r = np.random.default_rng(3)
    f, k, s, d = 3, 2, 100, 8
    img = r.normal(size=(f, s, d)).astype(np.float32)
    piv = r.normal(size=(f, k, s, d)).astype(np.float32)
    lines = r.normal(size=(f, k, s, 3)).astype(np.float32)
    pts = r.normal(size=(s, 3)).astype(np.float32)
    lines[1, 0, 5] = 100.0  # every pivot token violates in this row
    sim = np.einsum("fsd,fktd->fkst", img, piv)
    viol = np.abs(np.einsum("fksc,tc->fkst", lines, pts)) > 1.0
    masked = np.where(viol & ~viol.all(-1, keepdims=True), 0.0, sim)
    top2 = np.sort(masked, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    for block in (32, 100, 7, 512):
        want = np.asarray(JL.epi_blockwise_argmax(
            jnp.asarray(img), jnp.asarray(piv), jnp.asarray(lines),
            jnp.asarray(pts), 1.0, block=block))
        got = TL.epi_blockwise_argmax(
            torch.from_numpy(img), torch.from_numpy(piv),
            torch.from_numpy(lines), torch.from_numpy(pts), 1.0,
            block=block).numpy()
        np.testing.assert_array_equal(got[clear], want[clear])
        assert clear.mean() > 0.99

    # banded against dense, inside the port, on a real state
    jc, tc = arc_cameras(VIEWS)
    jk, tk = arc_cameras(KEYS, dist=3.4)
    band = TG.make_cross_view_state(t_stack(tc), t_stack(tk), 2, 8, 8, 2,
                                    1.0, "banded")
    dense = TG.make_cross_view_state(t_stack(tc), t_stack(tk), 2, 8, 8, 2,
                                     1.0, "dense")
    h = torch.from_numpy(r.normal(size=(12, 64, 16)).astype(np.float32))
    ph = torch.from_numpy(r.normal(size=(6, 64, 16)).astype(np.float32))
    pa = torch.from_numpy(r.normal(size=(6, 64, 16)).astype(np.float32))
    out_b = TL.BasicTransformerBlock._pivot_reuse(h, band, ph, pa)
    out_d = TL.BasicTransformerBlock._pivot_reuse(h, dense, ph, pa)
    np.testing.assert_allclose(out_b.numpy(), out_d.numpy(), atol=1e-6)


# ---- tokenizer ------------------------------------------------------------------

def test_hash_tokenizer_stable_across_processes():
    """The port's HashTokenizer gives the same ids in two processes with
    different PYTHONHASHSEED (the JAX one hashes with the salted hash)."""
    code = ("from dge_tpu_torch.diffusion.tokenizer import HashTokenizer;"
            "print(HashTokenizer(vocab_size=1000, max_length=8)"
            "('turn him into a clown').tolist())")
    outs = {subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, check=True, timeout=120,
        env={**os.environ, "PYTHONHASHSEED": seed}).stdout
        for seed in ("1", "2")}
    assert len(outs) == 1
    ids = eval(outs.pop())[0]
    assert ids[0] == 49406 % 1000 and ids[6:] == [49407 % 1000] * 2


def test_clip_tokenizer_matches_jax(tmp_path):
    """The BPE tokenizer on a small vocabulary, ids against the JAX copy;
    load_tokenizer falls back to HashTokenizer without vocab files."""
    import json

    bu = TT.bytes_to_unicode()
    chars = sorted(set(bu.values()))
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(vocab) + i for i, c in enumerate(chars)})
    merges = ["t u", "tu r", "c l", "cl o", "clo w", "n</w> a"]
    for m in merges:
        a, b = m.split()
        vocab.setdefault(a + b, len(vocab))
        vocab.setdefault(a + b + "</w>", len(vocab))
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = len(vocab), len(vocab) + 1
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version\n" + "\n".join(merges))
    text = ["Turn him into a clown!", "clown clown, 2 turns"]
    tok = TT.load_tokenizer(str(tmp_path), max_length=16)
    assert isinstance(tok, TT.CLIPTokenizer)
    np.testing.assert_array_equal(
        tok(text), JT.load_tokenizer(str(tmp_path), max_length=16)(text))
    assert isinstance(TT.load_tokenizer(str(tmp_path / "none")),
                      TT.HashTokenizer)


# ---- single-view InstructPix2Pix ------------------------------------------------

def jax_tiny_models():
    return JP.build_models(JUC.tiny(), JVC.tiny(), JCC.tiny(),
                           rng=jax.random.PRNGKey(0))


def port_models_from(jm):
    """The port's tiny models with the JAX models' parameters carried
    across."""

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    return TP.build_models(
        UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
        params={"unet": TW.unet_params_from_jax(host(jm.unet_params)),
                "vae": TW.vae_params_from_jax(host(jm.vae_params)),
                "text_encoder": TW.clip_text_params_from_jax(
                    host(jm.text_params))},
        device="cpu")


class Draws:
    """Hands the port's draw helpers the JAX draws, in order."""

    def __init__(self, normals=(), offsets=()):
        self.normals = [np.asarray(x) for x in normals]
        self.offsets = [np.asarray(x) for x in offsets]

    def normal(self, shape, generator):
        x = self.normals.pop(0)
        assert tuple(shape) == x.shape, (shape, x.shape)
        return torch.from_numpy(x.copy())

    def pivot_offsets(self, n, cbs, generator):
        x = self.offsets.pop(0)
        assert x.shape == (n,)
        return x


def test_edit_images_single_view(monkeypatch):
    """One call on 4 views at 32^2 with t_start 499 and 4 steps, against
    the JAX pipeline with its latent and noise draws."""
    jm = jax_tiny_models()
    tm = port_models_from(jm)
    r = np.random.default_rng(4)
    rgb = r.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    cond = r.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    ids = r.integers(1, 999, size=(2, 16))
    pos, neg = (np.asarray(JP.encode_text(jm, jnp.asarray(i[None].repeat(4, 0),
                                                          jnp.int32)))
                for i in ids)
    np.testing.assert_allclose(
        TP.encode_text(tm, ids[:1].repeat(4, 0)).numpy(), pos, atol=1e-5)
    key = jax.random.PRNGKey(9)
    want = JP.edit_images_single_view(jm, rgb, cond, pos, neg, key,
                                      t_start=499, num_steps=4)
    r_lat, r_noise = jax.random.split(key)
    lat_shape = (4, 16, 16, 4)
    draws = Draws([jax.random.normal(r_lat, lat_shape),
                   jax.random.normal(r_noise, lat_shape)])
    monkeypatch.setattr(TP, "_normal", draws.normal)
    got = TP.edit_images_single_view(
        tm, torch.from_numpy(rgb), torch.from_numpy(cond),
        torch.from_numpy(pos), torch.from_numpy(neg), torch.Generator(),
        t_start=499, num_steps=4)
    assert not draws.normals
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    print(f"edit_images_single_view max |port - JAX| = {err:.3g}")
    assert got.shape == (4, 32, 32, 3) and err < EDIT_TOL, err
