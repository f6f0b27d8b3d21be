"""The port's multi-rank modules (``dge_tpu_torch/parallel/``) against the
JAX package's ``dge_tpu/parallel/`` on the CPU.

The JAX functions run here on the 8 virtual devices (tests/conftest.py);
the port's run on 4 gloo ranks started once for the module by
``dist.spawn_local`` (tests/torch_parallel_ranks.py, which imports no JAX),
the inputs handed over as an ``.npz`` from numpy seeds. Sizes are those of
``tests/test_parallel.py``: 60 and 100 Gaussians (capacities 64 and 128),
64^2, tile 16, chunk 16, list cap 128.

- every sharded function on ``"torch_tiles"`` (the JAX functions' ``"jnp"``
  list compositor) against its JAX twin: renders within 1e-5 (depth 1e-4),
  updated
  parameters within 1e-4, losses within 1e-5;
- the same functions on the CPU's default backends (``"torch_tiles"`` for
  renders, ``"torch"`` for steps) against the port's own unsharded render
  and step, at tests/test_parallel.py's tolerances;
- on a saturated scene, where the early stop decides which Gaussians get
  a gradient: the port's view x tile step against its view-sharded step
  (no gradient of another sign) and its stream bands against the whole
  render; JAX's band step exact there too, and JAX's and the port's
  depth-slab steps both parting from their unsharded steps (a fault of
  the reference, ROADMAP.md §3);
- ``halo_rows`` + the band SSIM: loss and gradients equal the whole
  image's; the ``all_gather_cat`` backward equals the JAX transpose;
- the two departures from the reference (ROADMAP.md §3): the JAX view x
  tile step counts a Gaussian once in ``denom`` where its view-sharded step
  counts views, and the port's two steps agree; ``make_sharded_render``
  returns the spill;
- the dry run (``python -m dge_tpu_torch.parallel.dryrun``) at world 4,
  meshes that do not fit the group, and a failing rank."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from chip_smoke import slab_step_one_rank
from dge_tpu.ops import projection as JPR
from dge_tpu.parallel import gauss_shard as JGS
from dge_tpu.parallel import mesh as JM
from dge_tpu.parallel import shard as JS
from dge_tpu.parallel import tile_shard as JTS
from dge_tpu.systems import fit as JF
from dge_tpu.systems import optim as JO
from dge_tpu.systems.fit import FitState as JFit
from dge_tpu_torch.ops import losses as TL
from dge_tpu_torch.ops import render as TR
from dge_tpu_torch.parallel import dist as D
from dge_tpu_torch.parallel import dryrun
from dge_tpu_torch.parallel.mesh import stack_cameras as t_stack
from dge_tpu_torch.systems import fit as TF
from dge_tpu_torch.systems import optim as TO
from tests import torch_parallel_ranks as ranks
from tests.conftest import make_random_scene
from tests.decomposition_reading import compare, jax_step_result
from tests.test_parallel import ring_cameras
from tests.test_torch_edit import port_cam
from tests.test_torch_fit import port_scene

KW = ranks.KW
KW_SAT = ranks.KW_SAT
RENDER_TOL = 1e-5
# depth is in scene units (~4 here): test_torch_tiles.py holds the list
# compositor's depth against JAX's at 1e-4 too
DEPTH_TOL = 1e-4
PARAM_TOL = 1e-4
LOSS_TOL = 1e-5
PARAMS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")


def saturated_scene():
    """300 Gaussians of 0.1–0.2 scale packed around the origin: seen from
    the ring cameras at 64^2 the early stop refuses pairs in many pixels,
    and on the pair-stream backends where a tile's range is cut into
    blocks decides which (tests/test_parallel.py's scenes barely reach
    it)."""
    return make_random_scene(np.random.default_rng(0), n=300, capacity=512,
                             spread=0.5, scale_rng=(-2.3, -1.7))


def _scene_leaves(prefix, js):
    out = {prefix + k: np.asarray(getattr(js, k)) for k in ranks.SCENE_KEYS}
    out[prefix + "active"] = np.int32(js.active_sh_degree)
    out[prefix + "max"] = np.int32(js.max_sh_degree)
    return out


def _cam_leaves(prefix, jc):
    out = {prefix + k: np.asarray(getattr(jc, k)) for k in ranks.CAM_KEYS}
    out[prefix + "h"], out[prefix + "w"] = np.int32(jc.height), np.int32(
        jc.width)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs (JAX objects and the npz the ranks read)."""
    a = make_random_scene(np.random.default_rng(0), n=60, capacity=64)
    b = make_random_scene(np.random.default_rng(0), n=100, capacity=128)
    sat = saturated_scene()
    c4 = ring_cameras(4, height=64, width=64)
    c2 = ring_cameras(2, height=64, width=64)

    def uni(seed, *shape):
        return np.random.default_rng(seed).uniform(size=shape).astype(
            np.float32)

    r = np.random.default_rng(11)
    z = dict(**_scene_leaves("a_", a), **_scene_leaves("b_", b),
             **_scene_leaves("s_", sat),
             **_cam_leaves("c4_", JM.stack_cameras(c4)),
             **_cam_leaves("c2_", JM.stack_cameras(c2)),
             t4=uni(1, 4, 64, 64, 3), t2=uni(2, 2, 64, 64, 3),
             t1=uni(3, 64, 64, 3),
             bg_slab=np.array([0.2, 0.1, 0.3], np.float32),
             img=uni(4, 64, 64, 3), tgt=uni(5, 64, 64, 3),
             gx=r.normal(size=(4, 2, 3)).astype(np.float32),
             gw=r.normal(size=(4, 8, 3)).astype(np.float32))
    path = str(tmp_path_factory.mktemp("par") / "inputs.npz")
    np.savez(path, **z)
    return dict(path=path, z=z, a=a, b=b, sat=sat, c4=c4, c2=c2)


@pytest.fixture(scope="module")
def world4(setup):
    out = D.spawn_local(ranks.world4, 4, device="cpu", args=(setup["path"],))
    return out[0]


def _close(got, want, tol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    print(f"{what}: max |port - want| = {err:.3g}")
    assert err <= tol, (what, err, tol)


def _close_render(got, want, what):
    """(color, depth, alpha) within RENDER_TOL / DEPTH_TOL / RENDER_TOL."""
    for g, w, name, tol in zip(got[:3], want[:3], ("color", "depth", "alpha"),
                               (RENDER_TOL, DEPTH_TOL, RENDER_TOL)):
        _close(g, w, tol, f"{what} {name}")


def _jfresh(js):
    opt = JO.make_optimizer(JO.OptimConfig.scaled(100))
    return opt, opt.init(js.params()), JFit.create(js.capacity)


def _port_fresh(ts):
    opt = TO.make_optimizer(TO.OptimConfig.scaled(100))
    return opt, opt.init(ts.params()), TF.FitState.create(ts.capacity, "cpu")


def _assert_step(got, scene, loss, tol_loss=LOSS_TOL, what=""):
    for k in PARAMS:
        _close(got["scene"][k], np.asarray(getattr(scene, k)), PARAM_TOL,
               f"{what} {k}")
    assert abs(got["loss"] - float(loss)) <= tol_loss, (got["loss"], loss)


# ---- renders --------------------------------------------------------------

def test_tile_sharded_render_matches_jax(setup, world4):
    cam = setup["c4"][0]
    fn = JTS.make_tile_sharded_render(JTS.make_tile_mesh(4), 64, 64, **KW)
    want = fn(setup["a"], cam, jnp.zeros(3))
    got = world4["tile_render_torch_tiles"]
    _close_render(got, want, "tile bands")
    assert int(got[3]) == int(want[3]) == 0


def test_tile_sharded_render_default_matches_unsharded(setup, world4):
    """The CPU default backend against the port's own whole render."""
    single = TR.render(port_scene(setup["a"]), port_cam(setup["c4"][0]),
                       torch.zeros(3), backend="torch_tiles", **KW)
    color, depth, alpha, spill = world4["tile_render_None"]
    _close(color, single.color.numpy(), 5e-3, "bands vs whole color")
    _close(alpha, single.alpha.numpy(), 5e-3, "bands vs whole alpha")
    _close(depth, single.depth.numpy(), 5e-2, "bands vs whole depth")
    assert int(spill) == int(single.spill) == 0


def test_gauss_tile_render_matches_jax(setup, world4):
    fn = JTS.make_gauss_tile_render(JTS.make_gauss_tile_mesh(2, 2), 64, 64,
                                    **KW)
    want = fn(setup["a"], setup["c4"][0], jnp.zeros(3))
    got = world4["gauss_tile_render"]
    _close_render(got, want, "gauss x tile")
    assert int(got[3]) == int(want[3]) == 0


def test_depth_slab_render_matches_jax(setup, world4):
    bg = jnp.asarray(setup["z"]["bg_slab"])
    fn = JGS.make_depth_slab_render(JGS.make_gauss_mesh(4), 64, 64, **KW)
    want = fn(setup["b"], setup["c4"][0], bg)
    got = world4["slab_render"]
    _close_render(got, want, "depth slabs")
    assert int(got[3]) == int(want[3]) == 0
    # and the port's own whole render (tests/test_parallel.py's tolerances)
    single = TR.render(port_scene(setup["b"]), port_cam(setup["c4"][0]),
                       torch.from_numpy(setup["z"]["bg_slab"]),
                       backend="torch_tiles", **KW)
    _close(got[0], single.color.numpy(), 5e-3, "slabs vs whole color")
    _close(got[1], single.depth.numpy(), 5e-2, "slabs vs whole depth")


def test_sharded_preprocess_matches_jax(setup, world4):
    """Against JAX's preprocess of the whole scene, which its sharded
    preprocess equals (tests/test_parallel.py, a slow test there)."""
    b = setup["b"]
    want = JPR.preprocess(b.xyz, b.get_scaling, b.get_rotation,
                          b.get_opacity, b.get_features, b.alive,
                          setup["c4"][0], b.active_sh_degree,
                          b.max_sh_degree)
    for name, g in zip(JPR.Preprocessed._fields, world4["preprocess"]):
        w = np.asarray(getattr(want, name))
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=RENDER_TOL, rtol=0,
                                       equal_nan=True, err_msg=name)


def test_sharded_render_matches_jax_and_keeps_the_spill(setup, world4):
    """The JAX function returns (colors, depths) and drops the spill
    (shard.py:133-138); the port's returns the spill summed too."""
    want = JS.make_sharded_render(JM.make_view_mesh(4), **KW)(
        setup["a"], JM.stack_cameras(setup["c4"]), jnp.zeros(3))
    colors, depths, spill = world4["sharded_render"]
    assert len(want) == 2 and colors.shape == (4, 64, 64, 3)
    _close(colors, want[0], RENDER_TOL, "view-sharded colors")
    _close(depths, want[1], DEPTH_TOL, "view-sharded depths")
    assert int(spill) == 0


# ---- train steps -----------------------------------------------------------

def test_view_step_matches_jax(setup, world4):
    opt, st, fs = _jfresh(setup["a"])
    step = JS.make_sharded_train_step(opt, JM.make_view_mesh(4), **KW)
    s, _, f, aux = step(setup["a"], st, fs, JM.stack_cameras(setup["c4"]),
                        jnp.asarray(setup["z"]["t4"]), jnp.zeros(3))
    got = world4["view_step_torch_tiles"]
    _assert_step(got, s, aux["loss"], what="view step")
    for k in ("grad_accum", "max_radii2d"):
        _close(got["fit"][k], np.asarray(getattr(f, k)), PARAM_TOL, k)
    np.testing.assert_array_equal(got["fit"]["denom"], np.asarray(f.denom))


def _one_rank(setup, scene_key, cams_key, targets, lambda_dssim=0.2):
    ts = port_scene(setup[scene_key])
    opt, st, fs = _port_fresh(ts)
    cams = t_stack([port_cam(c) for c in setup[cams_key]])
    return dryrun.reference_step(opt, ts, st, fs, cams,
                                 torch.from_numpy(targets), torch.zeros(3),
                                 lambda_dssim=lambda_dssim, backend="torch",
                                 **KW)


def test_view_step_default_matches_one_rank(setup, world4):
    s, _, f, loss = _one_rank(setup, "a", "c4", setup["z"]["t4"])
    got = world4["view_step_None"]
    _assert_step(got, s, loss, what="view step vs one rank")
    np.testing.assert_array_equal(got["fit"]["denom"], f.denom.numpy())


def test_view_tile_step_matches_jax(setup, world4):
    """(2 views x 2 bands) with SSIM over halo rows; ``denom`` is the one
    departure (test_view_tile_denom_departure)."""
    opt, st, fs = _jfresh(setup["a"])
    step = JTS.make_view_tile_train_step(
        opt, JTS.make_view_tile_mesh(2, 2), 64, 64, **KW)
    s, _, f, aux = step(setup["a"], st, fs, JM.stack_cameras(setup["c2"]),
                        jnp.asarray(setup["z"]["t2"]), jnp.zeros(3))
    got = world4["view_tile_step_torch_tiles"]
    _assert_step(got, s, aux["loss"], what="view x tile step")
    _close(got["fit"]["grad_accum"], np.asarray(f.grad_accum), PARAM_TOL,
           "grad_accum")
    _close(got["fit"]["max_radii2d"], np.asarray(f.max_radii2d), 1e-3,
           "max_radii2d")


def test_view_tile_step_default_matches_one_rank(setup, world4):
    s, _, f, loss = _one_rank(setup, "a", "c2", setup["z"]["t2"])
    got = world4["view_tile_step_None"]
    _assert_step(got, s, loss, what="view x tile vs one rank")
    np.testing.assert_array_equal(got["fit"]["denom"], f.denom.numpy())


def test_view_tile_denom_departure(setup, world4):
    """JAX's view x tile step takes the MAX of visibility over views and
    bands, its view-sharded step the SUM over views: on two views that
    share Gaussians they disagree. The port takes the MAX over bands and
    the SUM over views, so its two steps agree (with each other and with
    the JAX view-sharded step)."""
    cams = JM.stack_cameras(setup["c2"])
    t2 = jnp.asarray(setup["z"]["t2"])
    opt, st, fs = _jfresh(setup["a"])
    _, _, f_tile, _ = JTS.make_view_tile_train_step(
        opt, JTS.make_view_tile_mesh(2, 2), 64, 64, **KW)(
        setup["a"], st, fs, cams, t2, jnp.zeros(3))
    opt, st, fs = _jfresh(setup["a"])
    _, _, f_view, _ = JS.make_sharded_train_step(
        opt, JM.make_view_mesh(2), **KW)(setup["a"], st, fs, cams, t2,
                                          jnp.zeros(3))
    j_tile, j_view = np.asarray(f_tile.denom), np.asarray(f_view.denom)
    assert (j_view == 2).any() and not np.array_equal(j_tile, j_view)
    assert j_tile.max() == 1.0
    got = world4["view_tile_step_torch_tiles"]["fit"]["denom"]
    np.testing.assert_array_equal(got, j_view)


def test_depth_slab_step_matches_jax(setup, world4):
    opt, st, fs = _jfresh(setup["b"])
    step = JGS.make_depth_slab_train_step(opt, JGS.make_gauss_mesh(4), 64,
                                          64, **KW)
    s, _, f, aux = step(setup["b"], st, fs, setup["c4"][0],
                        jnp.asarray(setup["z"]["t1"]), jnp.zeros(3))
    got = world4["slab_step_torch_tiles"]
    _assert_step(got, s, aux["loss"], what="depth-slab step")
    assert got["spill"] == int(aux["spill"]) == 0
    _close(got["fit"]["grad_accum"], np.asarray(f.grad_accum), PARAM_TOL,
           "grad_accum")
    _close(got["fit"]["max_radii2d"], np.asarray(f.max_radii2d), 1e-3,
           "max_radii2d")
    np.testing.assert_array_equal(got["fit"]["denom"], np.asarray(f.denom))


def test_depth_slab_step_default_matches_unsharded(setup, world4):
    ts = port_scene(setup["b"])
    opt, st, fs = _port_fresh(ts)
    s, _, _, aux = TF.make_train_step(opt, lambda_dssim=0.0, backend="torch",
                                      **KW)(
        ts, st, fs, port_cam(setup["c4"][0]),
        torch.from_numpy(setup["z"]["t1"]), torch.zeros(3))
    _assert_step(world4["slab_step_None"], s, aux["loss"],
                 what="depth-slab step vs unsharded")


def test_depth_slab_step_matches_one_rank_slabs(setup, world4):
    """Against the same four slabs composited and merged in one process:
    what the gathers and the sharded parameters and Adam state add."""
    ts = port_scene(setup["b"])
    opt, st, fs = _port_fresh(ts)
    s, _, _, loss = slab_step_one_rank(
        opt, ts, st, fs, port_cam(setup["c4"][0]),
        torch.from_numpy(setup["z"]["t1"]), torch.zeros(3), 4,
        backend="torch", **KW)
    _assert_step(world4["slab_step_None"], s, loss,
                 what="depth-slab step vs one-rank slabs")


def test_view_tile_step_matches_view_step_where_pixels_saturate(world4):
    """On the saturated scene, through the CPU's pair-stream backend, the
    view x tile step (2 x 2) against the view-sharded step on the same
    mesh: each band's stream sits at the whole image's block offsets and
    its depth keys are the whole image's, so each pixel refuses the pairs
    the whole image refuses. No gradient changes sign, and the parameters
    agree within 1e-4 (misplaced blocks part them by up to 2·lr)."""
    got, want = world4["sat_view_tile_step"], world4["sat_view_step"]
    e = compare(got, want)
    print(f"saturated view x tile vs view step: {e}")
    assert e["sign_flips_total"] == 0 and e["grad_rel_max"] <= 1e-5
    assert e["params_max"] <= PARAM_TOL and e["loss"] <= LOSS_TOL
    assert got["spill"] == want["spill"] == 0
    np.testing.assert_array_equal(got["fit"]["denom"], want["fit"]["denom"])


def test_stream_bands_match_whole_render_where_pixels_saturate(setup,
                                                               world4):
    """The 4 tile bands of the saturated scene on the pair-stream backend
    (``"torch"``) against the whole image on it, far inside the 5e-3 of
    tests/test_parallel.py: the bands composite as the whole does."""
    single = TR.render(port_scene(setup["sat"]), port_cam(setup["c4"][0]),
                       torch.zeros(3), backend="torch", **KW_SAT)
    color, depth, alpha, spill = world4["sat_tile_render_torch"]
    assert float((1.0 - single.alpha < 1e-2).float().mean()) > 0.05
    _close(color, single.color.numpy(), RENDER_TOL, "stream bands color")
    _close(alpha, single.alpha.numpy(), RENDER_TOL, "stream bands alpha")
    _close(depth, single.depth.numpy(), DEPTH_TOL, "stream bands depth")
    assert int(spill) == int(single.spill) == 0


def test_reference_band_step_is_exact_where_pixels_saturate(setup):
    """The JAX view x tile step against its view-sharded step on the
    saturated scene: its bands bin per-tile lists, which the list
    compositor cuts from each tile's first entry, so the bands refuse what
    the whole image refuses; the port's step keeps that (above)."""
    cams, t2 = JM.stack_cameras(setup["c2"]), jnp.asarray(setup["z"]["t2"])
    opt, st, fs = _jfresh(setup["sat"])
    views = jax_step_result(JS.make_sharded_train_step(
        opt, JM.make_view_mesh(2), **KW_SAT)(
        setup["sat"], st, fs, cams, t2, jnp.zeros(3)))
    opt, st, fs = _jfresh(setup["sat"])
    bands = jax_step_result(JTS.make_view_tile_train_step(
        opt, JTS.make_view_tile_mesh(2, 2), 64, 64, **KW_SAT)(
        setup["sat"], st, fs, cams, t2, jnp.zeros(3)))
    e = compare(bands, views)
    print(f"JAX view x tile vs view-sharded: {e}")
    assert e["sign_flips_total"] == 0 and e["params_max"] <= PARAM_TOL


def test_reference_slab_step_parts_where_pixels_saturate(setup, world4):
    """The reference fault the port keeps (ROADMAP.md §3): each depth slab
    starts at T = 1, so a slab behind saturated pixels composites pairs
    that the whole image refuses. JAX's 4-slab step gives them gradients
    that its unsharded step does not; so does the port's, against the
    port's unsharded step."""
    cam, t1 = setup["c4"][0], jnp.asarray(setup["z"]["t1"])
    opt, st, fs = _jfresh(setup["sat"])
    whole = jax_step_result(JF.make_train_step(
        opt, lambda_dssim=0.0, backend="jnp", **KW_SAT)(
        setup["sat"], st, fs, cam, t1, jnp.zeros(3)))
    opt, st, fs = _jfresh(setup["sat"])
    slabs = jax_step_result(JGS.make_depth_slab_train_step(
        opt, JGS.make_gauss_mesh(4), 64, 64, **KW_SAT)(
        setup["sat"], st, fs, cam, t1, jnp.zeros(3)))
    e = compare(slabs, whole)
    port = compare(world4["sat_slab_step"], world4["sat_unsharded_step"])
    print(f"JAX slabs vs unsharded: {e}; the port's: {port}")
    assert e["loss"] <= LOSS_TOL and e["sign_flips_total"] > 0
    assert port["loss"] <= LOSS_TOL and port["sign_flips_total"] > 0


# ---- collectives -----------------------------------------------------------

def test_halo_ssim_matches_whole_image(setup, world4):
    """4 bands of 16 rows, each extended by 5 halo rows: the loss and the
    gradient of ``1 - SSIM`` equal the whole image's."""
    img = torch.from_numpy(setup["z"]["img"]).requires_grad_(True)
    loss = 1.0 - TL.ssim(img, torch.from_numpy(setup["z"]["tgt"]))
    loss.backward()
    got_loss, got_grad = world4["ssim_halo"]
    assert abs(got_loss - float(loss)) <= 1e-6
    _close(got_grad, img.grad.numpy(), 1e-8, "band SSIM gradient")


def test_all_gather_backward_matches_jax_transpose(setup, world4):
    """The gradient of every rank's weighted sum of a tiled all-gather,
    against ``jax.grad`` through ``shard_map``'s ``all_gather``."""
    z = setup["z"]
    mesh = Mesh(np.array(jax.devices()[:4]), ("i",))

    def local(x, w):
        y = jax.lax.all_gather(x, "i", tiled=True)
        return jnp.sum(w[0] * y)[None]

    f = jax.shard_map(local, mesh=mesh, in_specs=(P("i"), P("i")),
                      out_specs=P("i"), check_vma=False)
    want = jax.grad(lambda x: f(x, jnp.asarray(z["gw"])).sum())(
        jnp.asarray(z["gx"].reshape(8, 3)))
    _close(world4["gather_grad"], want, 1e-6, "all_gather_cat backward")


def test_all_reduce_max(setup, world4):
    """``pmax`` over 4 ranks, each holding its row of ``gx[:, 0]``."""
    x = setup["z"]["gx"][:, 0]  # [ranks, 3]
    np.testing.assert_array_equal(world4["max"], x.max(0))


def test_dryrun_world4(capsys):
    assert dryrun.main(["--world", "4", "--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and all(x.endswith("ok") for x in lines), lines


def test_mesh_must_fit_the_group():
    """Without a process group there is one rank: a 2-rank mesh is
    refused, a 1-rank mesh has no peer to wait for."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        D.Mesh((2,), ("view",))
    m = D.Mesh((1, 1), ("view", "tile"))
    assert m.index("tile") == 0 and m.size(("view", "tile")) == 1
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(D.all_gather_cat(x), x)
    assert torch.equal(D.halo_rows(x, None, 1)[1:-1], x)


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        D.spawn_local(ranks.fails_on_rank_1, 2, device="cpu")


def test_rank_module_imports_no_jax():
    """The ranks import tests/torch_parallel_ranks.py by name: it must not
    pull JAX into them."""
    with open(ranks.__file__) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|dge_tpu)\b(?!_torch)",
                         src, re.M)


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="cuda"):
        D.init_from_env()
    with pytest.raises(RuntimeError, match="cuda"):
        D.spawn_local(ranks.fails_on_rank_1, 1)
    assert D.default_backend("cuda:0") == "nccl"
    assert D.default_backend("cpu") == "gloo"
