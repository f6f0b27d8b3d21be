"""The port's DGE guidance and edit system (``dge_tpu_torch/systems/
{guidance,edit,prompts,segmentation}.py``) and its ``--train`` mode against
the JAX package's, on the CPU with the tiny models.

- ``DGEGuidance.__call__``: 4 views at 32^2, ``max_step=500`` (3 pivot
  steps and one plain step: extended attention, 1-key and 2-key reuse, CFG),
  the JAX draws handed to the port, and the JAX cross-view states too (the
  port's own equal the JAX ones in their keys and blends, with lines within
  float32 rounding: test_torch_diffusion; but some tens of the ~2M line
  distances then fall on the other side of the 1 px threshold, and a
  flipped mask entry can move a gathered token); edited images within 1e-3
  absolute.
- ``DGESystem``: six steps through both packages with the same edit frames
  fed in (a stub guidance), held at the tolerances of
  ``tests/test_torch_fit.py::test_fit_loop_matches_reference``
  (parameters 1e-4, the same rows alive); ``_ring_order`` equal; in the port
  alone, a resumed run equal to the uninterrupted one and a second run on
  the edit cache skipping the guidance.
- ``--train --smoke --cpu system.model_size=tiny`` through the port's CLI on
  a synthetic capture."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.parallel.mesh import stack_cameras as j_stack
from dge_tpu.systems import edit as JE
from dge_tpu.systems import guidance as JG
from dge_tpu.systems import prompts as JPR
from dge_tpu.utils import misc as JM
from dge_tpu_torch import launch
from dge_tpu_torch.diffusion import ip2p as TP
from dge_tpu_torch.parallel.mesh import stack_cameras as t_stack
from dge_tpu_torch.scene import gaussians as TGS
from dge_tpu_torch.scene.camera_arrays import CameraArrays as TCam
from dge_tpu_torch.systems import edit as TE
from dge_tpu_torch.systems import guidance as TG
from dge_tpu_torch.systems import prompts as TPR
from dge_tpu_torch.systems import segmentation as TS
from dge_tpu_torch.utils import misc as TM
from dge_tpu_torch.utils import saving
from tests.conftest import make_random_scene
from tests.test_parallel import ring_cameras
from tests.test_torch_diffusion import (EDIT_TOL, Draws, jax_tiny_models,
                                        port_models_from)
from tests.test_torch_fit import assert_scene_close, port_scene
from tests.test_torch_render import write_synthetic_capture

KW = dict(camera_batch_size=2, diffusion_steps=4, resize_target=64)


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def port_cam(jc):
    """A JAX CameraArrays carried across."""
    return TCam(*(torch.from_numpy(np.array(getattr(jc, k), np.float32))
                  for k in ("w2c", "full_proj", "campos", "tan_half_fovx",
                            "tan_half_fovy")), height=jc.height, width=jc.width)


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny_models()
    return jm, port_models_from(jm)


def jax_draws(key, lat_shape, ts, n_batches, cbs):
    """The draws of the JAX guidance __call__ in the order it takes them:
    the posterior sample (one VAE chunk), the start noise, one pivot offset
    per camera batch at each step with t >= 100."""
    rng, r_enc = jax.random.split(key)
    normals = [jax.random.normal(r_enc, lat_shape)]
    rng, r_noise = jax.random.split(rng)
    normals.append(jax.random.normal(r_noise, lat_shape))
    offsets = []
    for t in ts:
        rng, r_step = jax.random.split(rng)
        if t >= 100:
            offsets.append(jax.random.randint(r_step, (n_batches,), 0, cbs))
    return Draws(normals, offsets)


def jax_states(jcams, monkeypatch):
    """Makes the port's guidance take the JAX cross-view state of each
    camera batch, after checking its own against it."""
    from dge_tpu.systems.guidance import _gather_cams
    from tests.test_torch_models import port_state

    jall = j_stack(jcams)
    centres = np.asarray(jall.campos)
    port_fn = TG.make_cross_view_state

    def pick(cams):
        return jnp.asarray([int(np.abs(centres - c.numpy()).sum(1).argmin())
                            for c in cams.campos])

    def state(cams_b, key_cams, pivot, lh, lw, n_key, thr, mode):
        jcv = JG.make_cross_view_state(
            _gather_cams(jall, pick(cams_b)), _gather_cams(jall, pick(key_cams)),
            jnp.asarray(pivot), lh, lw, n_key, thr, mode)
        own = port_fn(cams_b, key_cams, pivot, lh, lw, n_key, thr, mode)
        np.testing.assert_array_equal(own.closest_cam.numpy(),
                                      np.asarray(jcv.closest_cam))
        np.testing.assert_allclose(own.blend_w1.numpy(),
                                   np.asarray(jcv.blend_w1), atol=1e-6)
        state.calls += 1
        return port_state(jcv)

    state.calls = 0
    monkeypatch.setattr(TG, "make_cross_view_state", state)
    return state


def test_guidance_call(models, monkeypatch):
    jm, tm = models
    r = np.random.default_rng(5)
    b = 4
    rgb = r.uniform(size=(b, 32, 32, 3)).astype(np.float32)
    cond = r.uniform(size=(b, 32, 32, 3)).astype(np.float32)
    pos = r.normal(size=(b, 7, 32)).astype(np.float32)
    neg = r.normal(size=(b, 7, 32)).astype(np.float32)
    jcams = ring_cameras(b, height=32, width=32)
    key = jax.random.PRNGKey(1)
    jg = JG.DGEGuidance(JG.GuidanceConfig(**KW), jm)
    want = np.asarray(jg(rgb, cond, pos, neg, j_stack(jcams), key,
                         max_step=500))
    tg = TG.DGEGuidance(TG.GuidanceConfig(**KW), tm)
    ts = [373, 249, 125, 1]  # 4 steps over [0, 499]
    draws = jax_draws(key, (b, 32, 32, 4), ts, 2, 2)
    monkeypatch.setattr(TP, "_normal", draws.normal)
    monkeypatch.setattr(TG, "_pivot_offsets", draws.pivot_offsets)
    states = jax_states(jcams, monkeypatch)
    got = tg(*(torch.from_numpy(x) for x in (rgb, cond, pos, neg)),
             t_stack([port_cam(c) for c in jcams]), torch.Generator(),
             max_step=500).numpy()
    assert not draws.normals and not draws.offsets
    assert states.calls == 6  # 3 pivot steps x 2 camera batches
    err = float(np.abs(got - want).max())
    print(f"guidance __call__ max |port - JAX| = {err:.3g}")
    assert got.shape == (b, 32, 32, 3) and err < EDIT_TOL, err
    assert tg.min_step == jg.min_step and tg.max_step == jg.max_step
    tg.update_step(0.1, 0.5)
    assert (tg.min_step, tg.max_step) == (100, 500)


def test_guidance_unported_modes(models):
    """Every mode of the JAX guidance constructs: the sharded reuse (which
    runs as the batched one without a process group), the batched reuse
    and the SDS mode; an unknown mode is refused."""
    _, tm = models
    assert TG.DGEGuidance(TG.GuidanceConfig(batch_mode="shard"),
                          tm).cfg.batch_mode == "shard"
    with pytest.raises(ValueError, match="batch_mode"):
        TG.DGEGuidance(TG.GuidanceConfig(batch_mode="vmpa"), tm)
    g = TG.DGEGuidance(TG.GuidanceConfig(batch_mode="vmap"), tm)
    assert TE.DGESystem(TE.EditConfig(use_sds=True), port_scene(
        make_random_scene(np.random.default_rng(0), n=8)), [],
        guidance=g).cfg.use_sds


class StubGuidance:
    """Returns fixed edited frames (in the renders' ring order)."""

    def __init__(self, frames, to):
        self.frames, self.to, self.calls = frames, to, 0

    def __call__(self, rgb, cond, pos, neg, cams, rng, max_step=None):
        self.calls += 1
        assert tuple(rgb.shape) == self.frames.shape
        return self.to(self.frames)


EDIT_KW = dict(max_steps=6, camera_update_per_step=100, densify_from=1000,
               added_noise_schedule=(300,), tile_px=16, max_per_tile=64,
               chunk=16, lambda_perceptual=0.0)


def test_edit_system_matches_jax(rng):
    """Render -> (fixed) edit -> six refit steps in both packages; the
    port's origin frames against the JAX ones within one u8 step."""
    js = make_random_scene(rng, n=64, capacity=128)
    jcams = ring_cameras(4, height=32, width=32)
    frames = rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    emb = np.zeros((7, 32), np.float32)
    jsys = JE.DGESystem(JE.EditConfig(**EDIT_KW), js, jcams,
                        guidance=StubGuidance(frames, jnp.asarray),
                        text_emb_pos=jnp.asarray(emb),
                        text_emb_neg=jnp.asarray(emb))
    jout = jsys.run(jax.random.PRNGKey(0), steps=6, log_fn=lambda *_: None)
    tsys = TE.DGESystem(TE.EditConfig(**EDIT_KW), port_scene(js),
                        [port_cam(c) for c in jcams],
                        guidance=StubGuidance(frames, torch.from_numpy),
                        text_emb_pos=torch.from_numpy(emb),
                        text_emb_neg=torch.from_numpy(emb))
    tout = tsys.run(0, steps=6, log_fn=lambda *_: None)
    assert sorted(tsys.edit_frames) == sorted(jsys.edit_frames)
    for v in jsys.edit_frames:
        np.testing.assert_array_equal(tsys.edit_frames[v],
                                      jsys.edit_frames[v])
        assert np.abs(tsys.origin_frames[v]
                      - jsys.origin_frames[v]).max() <= 1 / 255 + 1e-6
    assert_scene_close(tout, jout, 1e-4, "after 6 steps")
    assert tsys.total_spill == jsys.total_spill == 0
    assert tsys.render_spill == 0
    assert int(tsys.fit_state.step) == int(jsys.fit_state.step) == 6


def test_caps_probed_spill_free(rng):
    """At caps too small for the scene the port grows the loop's caps over
    the views before the first render (the JAX system would render and
    refit with pairs dropped): no view render and no refit step spills."""
    js = make_random_scene(rng, n=64, capacity=128)
    cams = [port_cam(c) for c in ring_cameras(4, height=32, width=32)]
    frames = rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    sys_ = TE.DGESystem(TE.EditConfig(**{**EDIT_KW, "max_per_tile": 4}),
                        port_scene(js), cams,
                        guidance=StubGuidance(frames, torch.from_numpy),
                        text_emb_pos=torch.zeros(7, 32),
                        text_emb_neg=torch.zeros(7, 32))
    sys_.run(0, steps=2, log_fn=lambda *_: None)
    assert sys_.loop.tight_cull or sys_.loop.max_per_tile > 4
    assert sys_.cfg.max_per_tile == sys_.loop.max_per_tile
    assert sys_.render_spill == 0 and sys_.total_spill == 0


def test_ring_order_matches_jax():
    """_ring_order on the orbit of tests/test_edit_system.py:100-135, on
    scattered forward vectors and on the SVD fallback."""
    n = 8
    angles = [2 * math.pi * i / n for i in range(n)]
    centers = np.array([[3 * math.sin(a), 0.1, -3 * math.cos(a)]
                        for a in angles])
    forwards = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    r = np.random.default_rng(6)
    for c, f in ((centers, forwards), (centers, None),
                 (r.normal(size=(7, 3)), r.normal(size=(7, 3))),
                 (r.normal(size=(5, 3)), None)):
        want = [int(i) for i in JE._ring_order(c, f)]
        assert TE._ring_order(c, f) == want
    x = r.uniform(size=(2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(TE._quantize_u8(x), JE._quantize_u8(x))


def _port_system(models, cache_dir, seed=3):
    """A port system on a random scene with the real tiny guidance and two
    densify steps (2 and 4), whose split draws come from the step's
    generator."""
    r = np.random.default_rng(seed)
    scene = port_scene(make_random_scene(r, n=64, capacity=128))
    cams = [port_cam(c) for c in ring_cameras(4, height=32, width=32)]
    cfg = TE.EditConfig(**{**EDIT_KW, "densify_from": 2,
                           "densify_interval": 2, "densify_until": 4,
                           "densify_grad_threshold": 1e-4})
    g = TG.DGEGuidance(TG.GuidanceConfig(**{**KW, "diffusion_steps": 2}),
                       models[1])
    d = models[1].unet.config.cross_attention_dim
    return TE.DGESystem(cfg, scene, cams, guidance=g,
                        text_emb_pos=torch.zeros(7, d),
                        text_emb_neg=torch.zeros(7, d), cache_dir=cache_dir)


def test_resume_matches_uninterrupted(models, tmp_path):
    cache = str(tmp_path / "cache")
    full = _port_system(models, cache).run(5, steps=6, log_fn=lambda *_: None)
    b = _port_system(models, cache)
    b.run(5, steps=3, log_fn=lambda *_: None)
    ck = b.save_state(str(tmp_path / "ck"), 3)
    c = _port_system(models, cache)
    start = c.restore_state(ck)
    assert start == 3
    resumed = c.run(5, steps=6, start_step=start, log_fn=lambda *_: None)
    assert full.n_alive > 64  # the densify steps cloned or split
    for k in TGS.PARAM_NAMES + ("alive",):
        assert torch.equal(getattr(resumed, k), getattr(full, k)), k


def test_edit_cache_reused(models, tmp_path):
    """A second run on the same cache reloads the origin and edited frames
    (PNG, u8) and never calls the guidance."""
    cache = str(tmp_path / "cache")
    a = _port_system(models, cache)
    a.run(5, steps=2, log_fn=lambda *_: None)
    b = _port_system(models, cache)
    b.guidance = StubGuidance(np.zeros((4, 32, 32, 3), np.float32),
                              torch.from_numpy)
    b.run(5, steps=2, log_fn=lambda *_: None)
    assert b.guidance.calls == 0
    for v in a.edit_frames:
        np.testing.assert_array_equal(b.edit_frames[v], a.edit_frames[v])
        np.testing.assert_array_equal(b.origin_frames[v], a.origin_frames[v])
    assert os.path.exists(os.path.join(cache, "edit_0", "0003.png"))


def test_prompts_misc_and_segmentation(tmp_path):
    """PromptProcessor's md5 cache and view-dependent variants, C()
    schedules and the precomputed segmentor against the JAX copies."""
    enc = lambda ids: torch.from_numpy(ids.astype(np.float32)[..., None] *
                                       np.ones(3, np.float32))
    cfg = dict(prompt="a clown", negative_prompt="", use_view_dependent=True)
    tok = lambda t: np.array([[len(x) for x in t]])
    tp = TPR.PromptProcessor(tok, enc, str(tmp_path / "t"),
                             TPR.PromptConfig(**cfg))()
    jp = JPR.PromptProcessor(tok, lambda ids: np.asarray(enc(ids)),
                             str(tmp_path / "j"), JPR.PromptConfig(**cfg))()
    np.testing.assert_array_equal(tp.cond, jp.cond)
    for az, el in ((0.0, 0.0), (170.0, 10.0), (80.0, 0.0), (0.0, 70.0)):
        for a, b in zip(tp.get_text_embeddings(az, el),
                        jp.get_text_embeddings(az, el)):
            np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    for v in (0.3, 2, [0, 1.0, 3.0, 10], [5, 0.5, 0.1, 20]):
        for step in (0, 7, 30):
            assert TM.C(v, step) == JM.C(v, step)
    mask = np.zeros((8, 8, 3), np.float32)
    mask[2:5, 3:7] = 1.0
    saving.save_image(str(tmp_path / "m" / "0001.png"), mask)
    seg = TS.build_segmentor("precomputed", str(tmp_path / "m"))
    img = np.zeros((16, 16, 3), np.float32)
    assert seg(img, "x").all()  # view 0 has no mask: everything editable
    got = seg(img, "x")  # view 1, resized nearest 8 -> 16
    np.testing.assert_array_equal(got, np.kron(mask[..., 0], np.ones((2, 2))))
    assert TS.build_segmentor()(img, "x").shape == (16, 16)


def test_cli_train_smoke_on_cpu(tmp_path):
    """``--train --smoke --cpu system.model_size=tiny`` on a 4-view
    synthetic capture: trial dir, SMOKE_ONLY.txt, last.ply, the edited
    PNGs of the cache, validation grids; without --smoke it refuses."""
    ply, capture = write_synthetic_capture(str(tmp_path), n_views=4)
    out = str(tmp_path / "out")
    args = ["--train", "--cpu", "--gs_source", ply, "--source", capture,
            "--out", out, "data.height=32", "data.width=32",
            "data.max_view_num=4", "system.model_size=tiny",
            "system.prompt=turn him into a clown",
            "system.guidance.camera_batch_size=2",
            "system.guidance.diffusion_steps=2",
            "system.guidance.resize_target=64", "system.edit.max_steps=3",
            "system.edit.tile_px=16", "system.edit.chunk=16"]
    run = launch.main(args + ["--smoke"])
    assert os.path.exists(os.path.join(run.trial_dir, "SMOKE_ONLY.txt"))
    assert TGS.load_ply(run.ply_path, device="cpu").n_alive == 60
    assert len(run.edit_frames) == 4 and run.losses_finite
    for img in run.edit_frames.values():
        assert img.shape == (32, 32, 3) and 0 <= img.min() <= img.max() <= 1
    assert run.spill == 0 and run.render_spill == 0
    assert run.steps == 3 and run.seconds["edit"] > 0
    (cache,) = os.listdir(os.path.join(out, "edit_cache"))
    assert len(os.listdir(os.path.join(out, "edit_cache", cache,
                                       "edit_0"))) == 4
    assert os.path.exists(os.path.join(run.trial_dir, "val", "it3-val.png"))
    assert os.path.exists(os.path.join(run.trial_dir, "ckpts", "last"))
    with pytest.raises(SystemExit) as e:
        launch.main(args)
    assert e.value.code == 2
