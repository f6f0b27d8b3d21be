"""The training slice of the PyTorch port against the JAX package: losses
and the LR schedule, per-group Adam against optax, densify / prune /
opacity reset / capacity growth, the point-cloud initialisation with both
KNN routes, ten ``FitLoop`` steps as a whole, the spill ladder rung for rung,
and the ``--fit`` CLI. The port runs on the CPU (render backend "torch");
the same numpy inputs, made from a seed, go through both packages. Each
test states its tolerance."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.ops import losses as JL
from dge_tpu.scene import gaussians as JG
from dge_tpu.systems import densify as JD
from dge_tpu.systems import fit as JF
from dge_tpu.systems import optim as JO
from dge_tpu_torch import native as TN
from dge_tpu_torch.ops import losses as TL
from dge_tpu_torch.scene import colmap as TCOL
from dge_tpu_torch.scene import gaussians as TG
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.systems import densify as TD
from dge_tpu_torch.systems import fit as TF
from dge_tpu_torch.systems import optim as TO
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_render import write_synthetic_capture
from tests.test_torch_scene import ROOT, to_port

PARAMS = TG.PARAM_NAMES


def port_scene(js):
    """to_port plus the two leaves it does not carry."""
    ts = to_port(js)
    return ts.replace(
        grad_mask=torch.from_numpy(np.asarray(js.grad_mask).copy()),
        generation=torch.from_numpy(np.asarray(js.generation).copy()))


def assert_scene_close(ts, js, atol, what=""):
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive),
                                  err_msg=f"{what} alive")
    for k in PARAMS + ("grad_mask",):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), atol=atol,
                                   rtol=0, err_msg=f"{what} {k}")
    np.testing.assert_array_equal(ts.generation.numpy(),
                                  np.asarray(js.generation))


# ---- (c) losses and schedule, 1e-6 --------------------------------------

@pytest.mark.parametrize("shape", [(32, 32, 3), (24, 40, 3), (8, 8, 1)])
def test_losses_match(rng, shape):
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert abs(float(TL.l1_loss(ta, tb)) - float(JL.l1_loss(ja, jb))) < 1e-6
    assert abs(float(TL.ssim(ta, tb)) - float(JL.ssim(ja, jb))) < 1e-6
    np.testing.assert_allclose(TL.ssim_map(ta, tb).numpy(),
                               np.asarray(JL.ssim_map(ja, jb)), atol=2e-6)
    assert float(TL.ssim(ta, ta)) > 0.999
    assert abs(float(TL.psnr(ta, tb)) - float(JL.psnr(ja, jb))) < 1e-4


def test_ssim_gradient_matches(rng):
    a = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    b = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    ta = torch.from_numpy(a).requires_grad_(True)
    TL.ssim(ta, torch.from_numpy(b)).backward()
    want = jax.grad(lambda x: JL.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("delay", [0, 20])
def test_expon_lr_schedule_matches(delay):
    args = (1.6e-4 * 4.4, 1.6e-6 * 4.4, 100)
    kw = dict(lr_delay_steps=delay, lr_delay_mult=0.01)
    ts, js = TL.expon_lr_schedule(*args, **kw), JL.expon_lr_schedule(*args, **kw)
    for step in (0, 1, 7, 50, 99, 100, 250):
        want = float(js(step))
        assert abs(ts(step) - want) <= 1e-6 * want
    assert TL.expon_lr_schedule(0.0, 0.0, 10)(3) == 0.0


# ---- (d) Adam against optax, 1e-6 relative ------------------------------

def optax_inner(jstate):
    """The numpy leaves of an optax multi_transform state, per group."""
    out = {}
    for k, st in jstate.inner_states.items():
        adam = st.inner_state[0]
        out[k] = dict(mu=np.asarray(adam.mu[k]), nu=np.asarray(adam.nu[k]),
                      count=int(adam.count))
    return out


def test_adam_matches_optax_with_zeroed_row(rng):
    """Five steps with a row's moments zeroed after the second; the port's
    state is carried over from the optax state after step 2."""
    cap = 8
    shapes = dict(xyz=(cap, 3), features_dc=(cap, 1, 3),
                  features_rest=(cap, 3, 3), opacity=(cap, 1),
                  scaling=(cap, 3), rotation=(cap, 4))
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 0)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(5)]
    jcfg, tcfg = JO.OptimConfig.scaled(40), TO.OptimConfig.scaled(40)
    assert jcfg == JO.OptimConfig(**TO.dataclasses.asdict(tcfg))
    jopt, topt = JO.make_optimizer(jcfg, 4.4), TO.make_optimizer(tcfg, 4.4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = topt.init(tp)
    rows = np.zeros(cap, bool)
    rows[3] = True
    import optax

    for i, g in enumerate(grads):
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        if i == 1:
            js = JO.zero_adam_rows(js, jnp.asarray(rows))
            js = JO.zero_adam_rows(js, jnp.asarray(~rows), fields=("opacity",))
            ts = TO.state_from_optax(optax_inner(js), device="cpu")
            assert float(ts["xyz"]["mu"][3].abs().max()) == 0.0
            assert float(ts["opacity"]["nu"].abs().max()) == 0.0
            assert ts["xyz"]["count"] == 2
        for k in shapes:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"step {i} {k}")
    for k, st in optax_inner(js).items():
        np.testing.assert_allclose(ts[k]["mu"].numpy(), st["mu"], rtol=1e-5,
                                   atol=1e-12)
        np.testing.assert_allclose(ts[k]["nu"].numpy(), st["nu"], rtol=1e-5,
                                   atol=1e-20)
        assert ts[k]["count"] == st["count"] == 5


def test_grad_mask_and_zero_rows_match(rng):
    g = {k: rng.normal(size=(6, 2)).astype(np.float32) for k in PARAMS}
    mask = np.array([1, 0, 1, 0, 1, 1], np.float32)
    alive = np.array([1, 1, 1, 0, 0, 1], bool)
    want = JO.apply_grad_mask({k: jnp.asarray(v) for k, v in g.items()},
                              jnp.asarray(mask), jnp.asarray(alive))
    got = TO.apply_grad_mask({k: torch.from_numpy(v) for k, v in g.items()},
                             torch.from_numpy(mask), torch.from_numpy(alive))
    for k in PARAMS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert TO.MASKED_FIELDS == JO.MASKED_FIELDS


# ---- (e) densify, prune, reset, grow ------------------------------------

DENSIFY_KW = dict(max_grad=0.5, max_densify_percent=1.0, min_opacity=0.0,
                  extent=1.0, max_screen_size=0.0, percent_dense=0.01)


def densify_both(js, ga, denom, radii, seed=0, **kw):
    key = jax.random.PRNGKey(seed)
    k0, k1 = jax.random.split(key)
    cap = js.capacity
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (cap, 3))))
                  for k in (k0, k1))
    args = dict(DENSIFY_KW, **kw)
    j2, jinfo = JD.densify_and_prune(js, jnp.asarray(ga), jnp.asarray(denom),
                                     jnp.asarray(radii), key, **args)
    t2, tinfo = TD.densify_and_prune(
        port_scene(js), torch.from_numpy(ga), torch.from_numpy(denom),
        torch.from_numpy(radii), None, noise=noise, **args)
    for f in ("n_cloned", "n_split", "n_pruned", "dropped"):
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f
    np.testing.assert_array_equal(tinfo.changed_rows.numpy(),
                                  np.asarray(jinfo.changed_rows))
    assert_scene_close(t2, j2, 1e-6, "densify")
    return t2, tinfo


def densify_case(rng, name):
    cap = 32
    js = make_random_scene(rng, n=20, capacity=cap)
    ga = np.zeros(cap, np.float32)
    denom = np.ones(cap, np.float32)
    radii = np.zeros(cap, np.float32)
    scaling = np.full((cap, 3), -6.0, np.float32)
    kw = {}
    if name == "clone":
        ga[[2, 7, 11]] = 1.0
    elif name == "split":
        scaling[[3, 9]] = np.log(0.5)
        ga[[3, 9, 12]] = 1.0  # two splits and a clone
        kw["generation_num"] = 2
    elif name == "prune":
        op = np.asarray(js.opacity).copy()
        op[[5, 6]] = -10.0
        js = js.replace(opacity=jnp.asarray(op),
                        grad_mask=js.grad_mask.at[6].set(0.0))
        radii[8] = 50.0
        scaling[10] = np.log(0.3)
        kw.update(min_opacity=0.005, max_screen_size=20.0)
    elif name == "overflow":
        js = make_random_scene(rng, n=29, capacity=cap)
        scaling[[1, 4]] = np.log(0.5)
        ga[:29] = 1.0
        denom[5] = 0.0  # never seen: no gradient
    elif name == "percent":
        ga[:20] = rng.uniform(0.6, 2.0, size=20).astype(np.float32)
        ga[4] = np.nan
        kw["max_densify_percent"] = 0.25
    js = js.replace(scaling=jnp.asarray(scaling))
    return js, ga, denom, radii, kw


@pytest.mark.parametrize("name", ["clone", "split", "prune", "overflow",
                                  "percent"])
def test_densify_and_prune_matches(rng, name):
    js, ga, denom, radii, kw = densify_case(rng, name)
    t2, info = densify_both(js, ga, denom, radii, **kw)
    n0 = 29 if name == "overflow" else 20
    if name == "clone":
        assert int(info.n_cloned) == 3 and t2.n_alive == 23
    elif name == "split":
        assert int(info.n_split) == 2 and int(info.n_cloned) == 1
        assert t2.n_alive == n0 + 1 + 2 * 2 - 2
        assert int((t2.generation == 2).sum()) == 5
    elif name == "prune":
        assert int(info.n_pruned) == 3  # 5 (opacity), 8 (screen), 10 (world)
        assert bool(t2.alive[6])  # outside the editable mask: kept
    elif name == "overflow":
        assert t2.n_alive == 32 and int(info.dropped) > 0
    elif name == "percent":
        assert 0 < int(info.n_cloned) < 19


def test_reset_opacity_and_grow_capacity_match(rng):
    js = make_random_scene(rng, n=10, capacity=16)
    j2, jrows = JD.reset_opacity(js)
    t2, trows = TD.reset_opacity(port_scene(js))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    assert_scene_close(t2, j2, 1e-6, "reset")
    assert float(t2.get_opacity[t2.alive].max()) <= 0.0101
    j3 = JD.grow_capacity(j2, 40)
    t3 = TD.grow_capacity(t2, 40)
    assert t3.capacity == 40 and t3.n_alive == 10
    assert_scene_close(t3, j3, 1e-6, "grow")
    assert TD.grow_capacity(t3, 8) is t3
    q = rng.uniform(size=()).astype(np.float32)
    vals = rng.normal(size=16).astype(np.float32)
    alive = np.asarray(js.alive)
    np.testing.assert_allclose(
        float(TD._masked_quantile(torch.from_numpy(vals),
                                  torch.from_numpy(alive), torch.tensor(q))),
        float(JD._masked_quantile(jnp.asarray(vals), jnp.asarray(alive),
                                  jnp.asarray(q))), rtol=1e-6)


# ---- (f) point-cloud initialisation and the KNN routes ------------------

def test_create_from_pcd_and_knn_routes(rng):
    pts = rng.normal(size=(500, 3))
    cols = rng.uniform(size=(500, 3))
    native, scipy_ = TN.knn_native(pts), TN.knn_scipy(pts)
    assert native is not None, "g++ is present here: the native route builds"
    np.testing.assert_allclose(native, scipy_, rtol=1e-5)
    assert os.path.dirname(TN._build()) == TN.BUILD_DIR
    np.testing.assert_allclose(TG.mean_sq_dist_to_3nn(pts),
                               JG.mean_sq_dist_to_3nn(pts), rtol=1e-6)
    js = JG.create_from_pcd(pts, cols, max_sh_degree=2)
    ts = TG.create_from_pcd(pts, cols, max_sh_degree=2, device="cpu")
    assert ts.active_sh_degree == int(js.active_sh_degree) == 0
    assert ts.max_sh_degree == 2 and ts.capacity == js.capacity
    assert_scene_close(ts, js, 1e-6, "create_from_pcd")
    assert ts.one_up_sh_degree().one_up_sh_degree().one_up_sh_degree() \
        .active_sh_degree == 2
    np.testing.assert_array_equal(TG.sh_to_rgb(cols), JG.sh_to_rgb(cols))
    x = rng.uniform(0.05, 0.95, size=9).astype(np.float32)
    np.testing.assert_allclose(TG.inverse_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(JG.inverse_sigmoid(jnp.asarray(x))),
                               rtol=1e-6)
    assert PARAMS == JG.PARAM_NAMES


# ---- (g) the slice as a whole -------------------------------------------

def test_fit_loop_matches_reference(rng):
    """Ten FitLoop steps with one densify (at step 5, with the JAX noise
    handed over) on a 64-Gaussian scene at 32^2: parameters within 1e-4 of
    the JAX FitLoop with backend "jnp", the same rows alive, the Adam state
    and the densification statistics carried alike."""
    js = make_random_scene(rng, n=64, capacity=128)
    cam, jcam = make_test_camera(height=32, width=32)
    tcam = CameraArrays.from_camera(cam, "cpu")
    target = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    bg = np.array([0.1, 0.0, 0.2], np.float32)
    cfg_kw = dict(densify_from_iter=5, densification_interval=5,
                  densify_until_iter=5)
    loop_kw = dict(extent=2.0, spatial_lr_scale=2.0, tile_px=16,
                   max_per_tile=128, chunk=32)
    jloop = JF.FitLoop(JO.OptimConfig.scaled(10, **cfg_kw), backend="jnp",
                       **loop_kw)
    tloop = TF.FitLoop(TO.OptimConfig.scaled(10, **cfg_kw), **loop_kw)
    jopt, jfit = jloop.init(js)
    ts = port_scene(js)
    topt, tfit = tloop.init(ts)
    key = jax.random.PRNGKey(0)
    densified = 0
    for step in range(10):
        js, jopt, jfit, jaux = jloop.train_step(
            js, jopt, jfit, jcam, jnp.asarray(target), jnp.asarray(bg))
        ts, topt, tfit, taux = tloop.train_step(
            ts, topt, tfit, tcam, torch.from_numpy(target),
            torch.from_numpy(bg))
        assert abs(float(taux["loss"]) - float(jaux["loss"])) < 1e-5
        assert int(taux["spill"]) == int(jaux["spill"]) == 0
        key, sub = jax.random.split(key)
        k0, k1 = jax.random.split(sub)
        noise = tuple(torch.from_numpy(np.array(
            jax.random.normal(k, (js.capacity, 3)))) for k in (k0, k1))
        js, jopt, jfit, jinfo = jloop.maybe_densify(js, jopt, jfit, sub)
        ts, topt, tfit, tinfo = tloop.maybe_densify(ts, topt, tfit,
                                                    noise=noise)
        assert (jinfo is None) == (tinfo is None)
        if tinfo is not None:
            densified += 1
            assert int(tinfo.n_cloned) == int(jinfo.n_cloned)
            assert int(tinfo.n_split) == int(jinfo.n_split)
            assert int(tinfo.n_cloned) + int(tinfo.n_split) > 0
        js, jopt, jfit = jloop.maybe_housekeep(js, jopt, jfit)
        ts, topt, tfit = tloop.maybe_housekeep(ts, topt, tfit)
        assert_scene_close(ts, js, 1e-4, f"step {step}")
        assert tfit.step == int(jfit.step) == step + 1
    assert densified == 1 and ts.n_alive > 64
    want = TF.fit_state_from_numpy(
        np.asarray(jfit.grad_accum), np.asarray(jfit.denom),
        np.asarray(jfit.max_radii2d), int(jfit.step), device="cpu")
    np.testing.assert_allclose(tfit.grad_accum.numpy(),
                               want.grad_accum.numpy(), atol=1e-5)
    np.testing.assert_array_equal(tfit.denom.numpy(), want.denom.numpy())
    np.testing.assert_allclose(tfit.max_radii2d.numpy(),
                               want.max_radii2d.numpy(), atol=1e-3)
    for k, st in optax_inner(jopt).items():
        assert topt[k]["count"] == st["count"] == 10


def test_housekeeping_matches(rng):
    """SH degree steps up at 1000; opacity resets at the interval but never
    on the final step."""
    ts = port_scene(make_random_scene(rng, n=8, capacity=16, max_sh_degree=2))
    ts = ts.replace(active_sh_degree=0, opacity=ts.opacity + 3.0)
    loop = TF.FitLoop(TO.OptimConfig.scaled(4000, opacity_reset_interval=2000))
    opt, fit = loop.init(ts)
    opt["opacity"]["mu"] += 1.0
    for step, degree, reset in ((999, 0, False), (1000, 1, False),
                                (2000, 1, True), (4000, 1, False)):
        s2, o2, _ = loop.maybe_housekeep(ts, opt, fit.replace(step=step))
        assert s2.active_sh_degree == degree
        assert (float(s2.get_opacity.max()) <= 0.0101) == reset
        assert (float(o2["opacity"]["mu"][:8].abs().max()) == 0.0) == reset


def test_capacity_growth_pads_state(rng):
    ts = port_scene(make_random_scene(rng, n=15, capacity=16))
    loop = TF.FitLoop(TO.OptimConfig.scaled(
        10, densify_from_iter=1, densification_interval=1))
    opt, fit = loop.init(ts)
    opt["xyz"]["mu"] += 2.0
    s2, o2, f2, info = loop.maybe_densify(ts, opt, fit.replace(step=3))
    assert info is not None and s2.capacity == 32 and f2.step == 3
    assert o2["xyz"]["mu"].shape == (32, 3) and f2.denom.shape == (32,)
    assert float(o2["xyz"]["mu"][16:].abs().max()) == 0.0
    assert float(o2["xyz"]["mu"][:15].min()) == 2.0


def test_no_densify_after_the_final_step(rng):
    """The JAX loop densifies after its last step too, and saves clones and
    split children that no step ever optimised (ROADMAP.md §3); the port
    leaves the scene it is about to save alone."""
    js = make_random_scene(rng, n=20, capacity=32)
    cfg_kw = dict(densify_from_iter=5, densification_interval=5)
    jloop = JF.FitLoop(JO.OptimConfig.scaled(10, **cfg_kw), backend="jnp")
    tloop = TF.FitLoop(TO.OptimConfig.scaled(10, **cfg_kw))
    jopt, jfit = jloop.init(js)
    ts = port_scene(js)
    topt, tfit = tloop.init(ts)
    hot = np.ones(32, np.float32)
    jfit = jfit.replace(grad_accum=jnp.asarray(hot), denom=jnp.asarray(hot),
                        step=jnp.int32(10))
    tfit = tfit.replace(grad_accum=torch.from_numpy(hot),
                        denom=torch.from_numpy(hot), step=10)
    j2, _, _, jinfo = jloop.maybe_densify(js, jopt, jfit,
                                          jax.random.PRNGKey(0))
    t2, _, _, tinfo = tloop.maybe_densify(ts, topt, tfit)
    assert jinfo is not None and int(j2.n_alive) > 20
    assert tinfo is None and t2 is ts
    gen = torch.Generator().manual_seed(0)
    t3, _, f3, tinfo = tloop.maybe_densify(ts, topt, tfit.replace(step=5), gen)
    assert tinfo is not None and t3.n_alive > 20 and f3.step == 5
    assert float(f3.grad_accum.abs().max()) == 0.0  # statistics start anew


SPILL_SCRIPT = [
    (0, None), (5, None), (5, None), (5, None),  # -> cull
    (9, None), (9, None), (0, None), (9, None), (9, None), (9, None),  # all
    (3, (1, 0, 0, 0)), (3, (1, 0, 0, 0)), (3, (1, 0, 0, 0)),  # slot only
    (3, (0, 2, 0, 0)), (3, (0, 2, 0, 0)), (3, (0, 2, 0, 0)),  # cap class
    (3, (0, 0, 7, 1)), (3, (0, 0, 7, 1)), (3, (0, 0, 7, 1)),  # tile + stream
    (3, (4, 0, 1)), (3, (4, 0, 1)), (3, (4, 0, 1)),  # legacy 3-part form
] + [(2, (1, 1, 1, 1))] * 30  # to the ceilings


@pytest.mark.parametrize("capacity", [4096, 200_000])
def test_react_to_spill_matches_reference_rung_for_rung(capacity):
    """The code's behaviour (selective growth), not the reference's
    docstring (ROADMAP.md §3)."""
    jloop = JF.FitLoop(JO.OptimConfig.scaled(4), backend="jnp")
    tloop = TF.FitLoop(TO.OptimConfig.scaled(4))
    fields = ("tight_cull", "max_tiles_per_gaussian", "max_per_tile",
              "max_pairs", "big_capacity", "small_slots")
    changed = 0
    for i, (spill, parts) in enumerate(SPILL_SCRIPT):
        want = jloop.react_to_spill(spill, capacity, parts)
        got = tloop.react_to_spill(spill, capacity, parts)
        assert got == want, i
        changed += got
        for f in fields:
            assert getattr(tloop, f) == getattr(jloop, f), (i, f)
        assert tloop.caps["max_per_tile"] == tloop.max_per_tile
    assert changed >= 7 and tloop.max_tiles_per_gaussian == 256
    assert tloop.small_slots == 32


def test_trainer_backend_pairing(rng):
    ts = port_scene(make_random_scene(rng, n=8))
    cam, _ = make_test_camera(height=16, width=16)
    loop = TF.FitLoop(TO.OptimConfig.scaled(4), backend="cuda_train",
                      tile_px=16)
    opt, fit = loop.init(ts)
    with pytest.raises(ValueError, match="does not run on a scene on cpu"):
        loop.train_step(ts, opt, fit, CameraArrays.from_camera(cam, "cpu"),
                        torch.zeros(16, 16, 3), torch.zeros(3))
    with pytest.raises(RuntimeError, match="is_available\\(\\) is False"):
        TF.FitState.create(8)  # device defaults to the card


# ---- (h) the CLI ---------------------------------------------------------

def test_cli_fit_on_cpu(tmp_path):
    ply, capture = write_synthetic_capture(str(tmp_path), n_views=3)
    src = TG.load_ply(ply, device="cpu")
    pts = src.xyz[src.alive].numpy()
    cols = np.clip(TG.sh_to_rgb(src.features_dc[src.alive, 0].numpy()), 0, 1)
    TCOL.write_points3d_binary(
        pts, cols, os.path.join(capture, "sparse", "0", "points3D.bin"))
    out = str(tmp_path / "out")
    res = subprocess.run(
        [sys.executable, "-m", "dge_tpu_torch.launch", "--fit", "--cpu",
         "--source", capture, "--out", out, "--seed", "1", "data.height=32",
         "data.width=32", "system.sh_degree=1", "trainer.max_steps=20"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    (trial,) = [dp for dp, _, fn in os.walk(out) if "point_cloud.ply" in fn]
    fitted = TG.load_ply(os.path.join(trial, "point_cloud.ply"), device="cpu")
    assert fitted.n_alive == 60 and fitted.max_sh_degree == 1
    assert bool(torch.isfinite(fitted.xyz).all())
    with open(os.path.join(trial, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 10]
    assert recs[1]["train/psnr"] > recs[0]["train/psnr"]
    assert recs[0]["train/n_alive"] == 60
    with open(os.path.join(trial, "cmd.txt")) as f:
        assert "--fit" in f.read()
    # mode flags exclude each other
    bad = subprocess.run(
        [sys.executable, "-m", "dge_tpu_torch.launch", "--fit", "--render"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "not allowed with" in bad.stderr
