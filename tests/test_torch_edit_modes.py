"""The port's edit modes beyond the per-batch loop against the JAX package,
on the CPU with the tiny networks: the batched reuse (``batch_mode="vmap"``,
the mode ``configs/dge.yaml`` names) and the SDS mode.

- Batched reuse: the port's ``"vmap"`` against its own ``"loop"`` within
  2e-4 (``tests/test_guidance.py``'s tolerance for JAX's two modes), and
  against JAX's ``"vmap"`` on that test's setup with JAX's draws and
  cross-view states handed over (ROADMAP.md §3: the port's own states flip
  a few mask entries at the 1 px threshold) within 1e-4;
  ``--train --config configs/dge.yaml --cpu system.model_size=tiny`` runs
  to its end.
- SDS: ``compute_grad_sds`` and ``sds_multiview`` against JAX with its draws
  handed over, within 1e-4·max|grad|; the refit's loss and its gradients to
  every scene parameter and the screen-space offset against
  ``jax.value_and_grad`` of the same composition of JAX's ``render`` and
  ``encode_images``, within 2e-3·max|g|; ``DGESystem.run`` with ``use_sds``
  on ``tests/test_edit_system.py::test_sds_mode_end_to_end``'s setup; a
  resumed SDS run replays the uninterrupted one."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dge_tpu.diffusion import ip2p as JP
from dge_tpu.ops import render as JR
from dge_tpu.parallel.mesh import stack_cameras as j_stack
from dge_tpu.systems import guidance as JG
from dge_tpu_torch import launch
from dge_tpu_torch.diffusion import ddim as TD
from dge_tpu_torch.diffusion import ip2p as TP
from dge_tpu_torch.parallel.mesh import stack_cameras as t_stack
from dge_tpu_torch.scene import gaussians as TGS
from dge_tpu_torch.systems import edit as TE
from dge_tpu_torch.systems import guidance as TG
from tests.conftest import make_random_scene
from tests.test_parallel import ring_cameras
from tests.test_torch_diffusion import Draws, jax_tiny_models, port_models_from
from tests.test_torch_edit import jax_draws, jax_states, port_cam
from tests.test_torch_fit import port_scene
from tests.test_torch_render import write_synthetic_capture

# tests/test_guidance.py::TestBatchedReuse's guidance
VKW = dict(camera_batch_size=2, diffusion_steps=2, resize_target=64)
GRAD_TOL = 2e-3


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny_models()
    return jm, port_models_from(jm)


def _inputs(b=4, d=32):
    """tests/test_guidance.py::TestBatchedReuse's inputs."""
    r = np.random.default_rng(7)
    return (r.uniform(size=(b, 32, 32, 3)).astype(np.float32),
            r.uniform(size=(b, 32, 32, 3)).astype(np.float32),
            r.normal(size=(b, 7, d)).astype(np.float32),
            r.normal(size=(b, 7, d)).astype(np.float32))


def _port_call(tm, mode, jcams, seed=3):
    g = TG.DGEGuidance(TG.GuidanceConfig(**VKW, batch_mode=mode), tm)
    return g(*(torch.from_numpy(x) for x in _inputs()),
             t_stack([port_cam(c) for c in jcams]),
             torch.Generator().manual_seed(seed), max_step=400).numpy()


def test_vmap_matches_loop(models):
    """One batched reuse pass equals the per-batch loop (batch 0's single
    key duplicated with blend 1 gathers the same tokens)."""
    jcams = ring_cameras(4, height=32, width=32)
    loop = _port_call(models[1], "loop", jcams)
    vmap = _port_call(models[1], "vmap", jcams)
    err = float(np.abs(loop - vmap).max())
    print(f"port vmap vs loop: {err:.3g}")
    assert err < 2e-4, err


def test_vmap_matches_jax(models, monkeypatch):
    jm, tm = models
    jcams = ring_cameras(4, height=32, width=32)
    key = jax.random.PRNGKey(3)
    jg = JG.DGEGuidance(JG.GuidanceConfig(**VKW, batch_mode="vmap"), jm)
    want = np.asarray(jg(*_inputs(), j_stack(jcams), key, max_step=400))
    ts = TD.inference_timesteps(
        tm.schedule._replace(num_train_timesteps=399), 2)
    draws = jax_draws(key, (4, 32, 32, 4), ts, 2, 2)
    monkeypatch.setattr(TP, "_normal", draws.normal)
    monkeypatch.setattr(TG, "_pivot_offsets", draws.pivot_offsets)
    states = jax_states(jcams, monkeypatch)
    got = _port_call(tm, "vmap", jcams)
    assert not draws.normals and not draws.offsets
    assert states.calls == 2 * sum(int(t) >= 100 for t in ts)
    err = float(np.abs(got - want).max())
    print(f"port vmap vs JAX vmap: {err:.3g}")
    assert err < 1e-4, err


def test_cli_dge_yaml_on_cpu(tmp_path):
    """The repo's recipe (batch_mode vmap) with the tiny networks, a local
    edit on the full-image fallback mask."""
    ply, capture = write_synthetic_capture(str(tmp_path), n_views=4)
    run = launch.main([
        "--train", "--smoke", "--cpu", "--config", "configs/dge.yaml",
        "--gs_source", ply, "--source", capture, "--out",
        str(tmp_path / "out"), "data.height=32", "data.width=32",
        "data.max_view_num=4", "system.model_size=tiny",
        "system.seg_prompt=object", "system.guidance.camera_batch_size=2",
        "system.guidance.diffusion_steps=2",
        "system.guidance.resize_target=64", "system.edit.max_steps=3",
        "system.edit.tile_px=16", "system.edit.chunk=16"])
    with open(os.path.join(run.trial_dir, "parsed.yaml")) as f:
        parsed = yaml.safe_load(f)
    assert parsed["system"]["guidance"]["batch_mode"] == "vmap"
    assert run.steps == 3 and run.losses_finite and len(run.edit_frames) == 4
    assert run.spill == run.render_spill == run.system.lift_spill == 0
    assert run.system.lift_caps is not None
    assert float(run.system.scene.grad_mask.sum()) > 0
    assert run.clip_metrics is None  # no system.clip_checkpoint


def test_compute_grad_sds_matches_jax(models, monkeypatch):
    jm, tm = models
    r = np.random.default_rng(9)
    lat = r.normal(size=(2, 16, 16, 4)).astype(np.float32)
    cond = np.concatenate([lat, lat, np.zeros_like(lat)])
    emb = r.normal(size=(6, 7, 32)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jg = JG.DGEGuidance(JG.GuidanceConfig(**VKW), jm)
    want = np.asarray(jg.compute_grad_sds(emb, lat, cond, 500, key))
    draws = Draws([jax.random.normal(key, lat.shape)])
    monkeypatch.setattr(TP, "_normal", draws.normal)
    got = TG.DGEGuidance(TG.GuidanceConfig(**VKW), tm).compute_grad_sds(
        *(torch.from_numpy(x) for x in (emb, lat, cond)), 500,
        torch.Generator()).numpy()
    err = float(np.abs(got - want).max())
    assert err < 1e-4 * float(np.abs(want).max()), err


@pytest.mark.parametrize("mode", ["loop", "vmap"])
def test_sds_multiview_matches_jax(models, monkeypatch, mode):
    """Multi-view SDS at t = 500 (pivot pass and reuse passes)."""
    jm, tm = models
    jcams = ring_cameras(4, height=32, width=32)
    key = jax.random.PRNGKey(5)
    jg = JG.DGEGuidance(JG.GuidanceConfig(**VKW, batch_mode=mode), jm)
    want = {k: np.asarray(v) for k, v in jg.sds_multiview(
        *_inputs(), j_stack(jcams), key, t=500).items()}
    _, r_enc, r_noise, r_piv = jax.random.split(key, 4)
    shape = (4, 32, 32, 4)
    draws = Draws([jax.random.normal(r_enc, shape),
                   jax.random.normal(r_noise, shape)],
                  [jax.random.randint(r_piv, (2,), 0, 2)])
    monkeypatch.setattr(TP, "_normal", draws.normal)
    monkeypatch.setattr(TG, "_pivot_offsets", draws.pivot_offsets)
    states = jax_states(jcams, monkeypatch)
    g = TG.DGEGuidance(TG.GuidanceConfig(**VKW, batch_mode=mode), tm)
    got = {k: v.numpy() for k, v in g.sds_multiview(
        *(torch.from_numpy(x) for x in _inputs()),
        t_stack([port_cam(c) for c in jcams]), torch.Generator(),
        t=500).items()}
    assert not draws.normals and not draws.offsets and states.calls == 2
    tol = 1e-4 * float(np.abs(want["grad"]).max())
    for k in ("grad", "latents", "target"):
        err = float(np.abs(got[k] - want[k]).max())
        assert err < tol, (k, err, tol)
    for k in ("loss_sds", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * float(want[k])


def _sds_system(tm, js, jcams, cache_dir=None, **cfg):
    g = TG.DGEGuidance(TG.GuidanceConfig(**VKW), tm)
    d = tm.unet.config.cross_attention_dim
    kw = dict(use_sds=True, camera_batch_size=4, densify_from=1000,
              tile_px=16, max_per_tile=64, chunk=16, lambda_perceptual=0.0)
    kw.update(cfg)
    return TE.DGESystem(TE.EditConfig(**kw), port_scene(js),
                        [port_cam(c) for c in jcams], guidance=g,
                        text_emb_pos=torch.zeros(7, d),
                        text_emb_neg=torch.zeros(7, d), cache_dir=cache_dir)


def test_sds_loss_and_grads_match_jax(models):
    """Three views rendered in one graph sharing one offset, resized 32 ->
    64, encoded with a handed-over draw: loss and gradients to every scene
    parameter and the offset against jax.value_and_grad of the same
    composition (JAX's render on its CPU training backend)."""
    jm, tm = models
    js = make_random_scene(np.random.default_rng(11), n=64, capacity=128)
    jcams = ring_cameras(4, height=32, width=32)
    system = _sds_system(tm, js, jcams, lambda_sds=0.5)
    vids = [2, 0, 3]
    shape = (3, 32, 32, 4)
    target = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, shape))
    loss, grads, outs = system.sds_loss_and_grads(
        vids, torch.from_numpy(target), torch.from_numpy(noise))
    assert sum(int(o.spill) for o in outs) == 0

    def jloss(params, offset):
        s = js.with_params(params)
        outs = [JR.render(s, jcams[v], jnp.zeros(3), tile_px=16,
                          max_per_tile=64, chunk=16, mean2d_offset=offset,
                          backend="jnp") for v in vids]
        rgb = jax.image.resize(jnp.stack([o.color for o in outs]),
                               (3, 64, 64, 3), "bilinear")
        lat = JP.encode_images(jm, rgb, key)
        return (0.5 * 0.5 * jnp.sum((lat - target) ** 2) / 3,
                sum(o.spill for o in outs))

    (jl, jspill), (jg, jo) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(js.params(),
                                             jnp.zeros((128, 2)))
    assert int(jspill) == 0
    assert abs(float(loss) - float(jl)) <= 1e-5 * float(jl), (loss, jl)
    want = {**{k: np.asarray(v) for k, v in jg.items()},
            "mean2d_offset": np.asarray(jo)}
    for k, w in want.items():
        err = float(np.abs(grads[k].numpy() - w).max())
        scale = float(np.abs(w).max())
        assert scale > 0 and err <= GRAD_TOL * scale, (k, err, scale)


def test_sds_run(models):
    """tests/test_edit_system.py::test_sds_mode_end_to_end's setup: three
    SDS steps over batches of the 4 views, no edit frames, parameters
    moved, densification statistics accumulated, no spill."""
    js = make_random_scene(np.random.default_rng(0), n=64, capacity=128)
    system = _sds_system(models[1], js, ring_cameras(4, height=32,
                                                     width=32), max_steps=3)
    logged = []
    out = system.run(0, steps=3, log_fn=logged.append)
    assert not system.edit_frames and len(logged) == 1
    before = torch.from_numpy(np.asarray(js.features_dc))
    assert float((out.features_dc - before).abs().max()) > 0
    assert float(system.fit_state.denom.max()) > 0
    assert system.fit_state.step == 3 and system.seconds["sds"] > 0
    assert system.total_spill == system.render_spill == 0


class Metrics:
    def __init__(self):
        self.rows = {}

    def log(self, step, row):
        self.rows[step] = row


def test_sds_resume_replays(models, tmp_path):
    """Four SDS steps against two, a checkpoint, a restore and two more
    (the origin frames, the SDS conditioning, from the edit cache as in
    ``launch --train --resume``): the same losses and timesteps at steps 2
    and 3, the same scene."""
    js = make_random_scene(np.random.default_rng(1), n=64, capacity=128)
    jcams = ring_cameras(4, height=32, width=32)
    kw = dict(camera_batch_size=2, max_steps=4,
              cache_dir=str(tmp_path / "cache"))
    full, fm = _sds_system(models[1], js, jcams, **kw), Metrics()
    a = full.run(4, steps=4, log_fn=lambda *_: None, metrics=fm)
    first = _sds_system(models[1], js, jcams, **kw)
    first.run(4, steps=2, log_fn=lambda *_: None)
    ck = first.save_state(str(tmp_path / "ck"), 2)
    second, sm = _sds_system(models[1], js, jcams, **kw), Metrics()
    start = second.restore_state(ck)
    b = second.run(4, steps=4, start_step=start, log_fn=lambda *_: None,
                   metrics=sm)
    assert start == 2 and sorted(sm.rows) == [2, 3]
    for step in (2, 3):
        assert sm.rows[step] == fm.rows[step], step
    for k in TGS.PARAM_NAMES + ("alive",):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
