"""The port's local-editing utilities (``dge_tpu_torch/scene/editing.py``,
the mask helpers of ``utils/misc.py``) and its spill-free mask lift
(``DGESystem.update_mask``) against the JAX package, on the CPU.

- ``grow_mask_to_neighbors``, ``localized`` and ``concat_scenes`` equal to
  JAX exactly; ``anchor_loss`` within 1e-6 relative.
- ``dilate_mask`` / ``erode_mask`` / ``fill_closed_areas`` on the cases of
  ``tests/test_utils.py`` and equal to JAX on random masks.
- The lift: at a ``max_per_tile`` the scene overflows, the JAX system drops
  the deepest entries of each full tile and installs another mask; the
  port grows its caps until nothing is dropped (``lift_spill`` 0), and its
  mask equals the one JAX's ``render_weights`` gives at the grown caps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.ops import render as JR
from dge_tpu.scene import editing as JED
from dge_tpu.systems import edit as JE
from dge_tpu.utils import misc as JM
from dge_tpu_torch.ops import render as TR
from dge_tpu_torch.scene import editing as TED
from dge_tpu_torch.scene import gaussians as TGS
from dge_tpu_torch.systems import edit as TE
from dge_tpu_torch.utils import misc as TM
from tests.conftest import make_random_scene
from tests.test_parallel import ring_cameras
from tests.test_torch_edit import port_cam
from tests.test_torch_fit import assert_scene_close, port_scene


def _scene(seed, n=64, capacity=128):
    js = make_random_scene(np.random.default_rng(seed), n=n,
                           capacity=capacity)
    return js, port_scene(js)


@pytest.mark.parametrize("dist", [0.05, 0.3, 2.0])
def test_grow_mask_to_neighbors_matches_jax(dist):
    js, ts = _scene(0, n=200, capacity=256)
    r = np.random.default_rng(1)
    mask = np.zeros(256, bool)
    mask[r.choice(200, 30, replace=False)] = True
    mask[220] = True  # a dead row: never in the result
    want = np.asarray(JED.grow_mask_to_neighbors(js, jnp.asarray(mask),
                                                 dist))
    got = TED.grow_mask_to_neighbors(ts, torch.from_numpy(mask), dist)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() >= 30 and not got[220]
    empty = TED.grow_mask_to_neighbors(ts, torch.zeros(256, dtype=bool))
    assert not empty.any()


def test_localized_and_concat_match_jax():
    js, ts = _scene(2)
    jb, tb = _scene(3, n=40, capacity=64)
    np.testing.assert_array_equal(TED.localized(ts).alive.numpy(),
                                  np.asarray(JED.localized(js).alive))
    mask = np.random.default_rng(4).uniform(size=128) > 0.5
    np.testing.assert_array_equal(
        TED.localized(ts, torch.from_numpy(mask)).alive.numpy(),
        np.asarray(JED.localized(js, jnp.asarray(mask)).alive))
    got, want = TED.concat_scenes(ts, tb), JED.concat_scenes(js, jb)
    assert got.capacity == want.capacity and got.n_alive == 104
    assert got.active_sh_degree == int(want.active_sh_degree)
    for k in TGS.PARAM_NAMES + ("alive",):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)


@pytest.mark.parametrize("weights", [None, (1.0, 0.5, 0.25)])
def test_anchor_loss_matches_jax(weights):
    js, ts = _scene(5)
    anchor_j, anchor_t = JED.anchor_snapshot(js), TED.anchor_snapshot(ts)
    r = np.random.default_rng(6)
    gen = r.integers(0, 5, size=128).astype(np.int32)
    moved = {k: (np.asarray(getattr(js, k))
                 + 0.05 * r.normal(size=np.shape(getattr(js, k)))
                 ).astype(np.float32)
             for k in ("xyz", "features_dc", "opacity", "scaling")}
    js2 = js.replace(generation=jnp.asarray(gen),
                     **{k: jnp.asarray(v) for k, v in moved.items()})
    ts2 = ts.replace(generation=torch.from_numpy(gen),
                     **{k: torch.from_numpy(v) for k, v in moved.items()})
    gw = None if weights is None else np.asarray(weights, np.float32)
    want = float(JED.anchor_loss(js2, anchor_j,
                                 None if gw is None else jnp.asarray(gw)))
    got = float(TED.anchor_loss(ts2, anchor_t,
                                None if gw is None else torch.from_numpy(gw)))
    assert want > 0 and abs(got - want) <= 1e-6 * want, (got, want)
    assert float(TED.anchor_loss(ts, anchor_t)) == 0.0


def test_mask_helpers():
    """tests/test_utils.py's cases, then random masks against JAX."""
    m = np.zeros((9, 9), np.float32)
    m[4, 4] = 1
    d = TM.dilate_mask(m, 1)
    assert d.sum() == 9 and d.dtype == np.float32
    assert TM.erode_mask(d, 1).sum() == 1
    ring = np.zeros((9, 9), np.float32)
    ring[2:7, 2:7] = 1
    ring[3:6, 3:6] = 0
    assert TM.fill_closed_areas(ring).sum() == 25
    r = np.random.default_rng(7)
    for it in (1, 2):
        x = (r.uniform(size=(24, 31)) > 0.7).astype(np.float32)
        for name in ("dilate_mask", "erode_mask"):
            np.testing.assert_array_equal(getattr(TM, name)(x, it),
                                          getattr(JM, name)(x, it))
        np.testing.assert_array_equal(TM.fill_closed_areas(x),
                                      JM.fill_closed_areas(x))


def _centre_mask(img, prompt):
    """A segmentor: the central quarter of the image."""
    h, w = img.shape[:2]
    m = np.zeros((h, w), np.float32)
    m[h // 4:3 * h // 4, w // 4:3 * w // 4] = 1.0
    return m


def _jax_mask(js, jcams, caps, cfg):
    """The JAX package's update_mask arithmetic over the views, with its
    ``render_weights`` at the given caps."""
    w = h = 0.0
    for c in jcams:
        wi, hi = JR.render_weights(js, c, jnp.asarray(_centre_mask(
            np.zeros((c.height, c.width, 3)), "")), tile_px=cfg["tile_px"],
            chunk=cfg["chunk"], **caps)
        w, h = w + np.asarray(wi), h + np.asarray(hi)
    frac = np.where(h > 0, w / np.maximum(h, 1.0), 0.0)
    return (frac > 0.8) & np.asarray(js.alive)


def _lift_spill(system, vid, max_per_tile, max_tiles_per_gaussian=32):
    """The list entries the port's lift of view ``vid`` drops at these
    caps."""
    return int(TR.render_weights(
        system.scene, system.cameras[vid], torch.ones(32, 32), tile_px=16,
        max_per_tile=max_per_tile,
        max_tiles_per_gaussian=max_tiles_per_gaussian, chunk=16).spill)


def test_spill_free_lift_against_jax():
    """At max_per_tile 8 the lift of a centred mask overflows (the JAX system drops entries
    without a word); the port's update_mask grows its caps to spill 0 and
    its mask equals JAX's render_weights at the grown caps, and differs
    from the JAX system's own mask at the default cap."""
    js = make_random_scene(np.random.default_rng(8), n=160, capacity=256,
                           scale_rng=(-2.6, -1.8))
    jcams = ring_cameras(4, height=32, width=32)
    cfg = dict(max_per_tile=8, tile_px=16, chunk=16, seg_prompt="object")
    jsys = JE.DGESystem(JE.EditConfig(**cfg), js, jcams,
                        segmentor=_centre_mask)
    jsys.update_mask()
    tsys = TE.DGESystem(TE.EditConfig(**cfg), port_scene(js),
                        [port_cam(c) for c in jcams], segmentor=_centre_mask)
    before = [_lift_spill(tsys, v, 8) for v in range(4)]
    assert sum(before) > 0, before  # the old rule drops entries
    tsys.update_mask()
    assert tsys.lift_spill == 0
    caps = tsys.lift_caps
    assert caps["max_per_tile"] > 8
    assert all(_lift_spill(tsys, v, caps["max_per_tile"],
                        caps["max_tiles_per_gaussian"]) == 0
               for v in range(4))
    got = tsys.scene.grad_mask.numpy() > 0
    np.testing.assert_array_equal(got, _jax_mask(js, jcams, caps, cfg))
    assert 0 < got.sum() < tsys.scene.n_alive
    assert (got != (np.asarray(jsys.scene.grad_mask) > 0)).any()
