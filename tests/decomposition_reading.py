"""The band and depth-slab train steps against their whole-image steps on
the quality-gate scene, in the JAX package and in the port, on the CPU::

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python -m tests.decomposition_reading [--package dge_tpu]

Both decompositions claim to be exact. On a trained scene many pixels
saturate, and the early stop (a pair is refused once T would fall below
1e-4) then decides which Gaussians get a gradient. The reading shows where
each decomposition keeps that decision and where it does not:

- JAX: ``make_view_tile_train_step`` (2 views x 2 bands, SSIM on) against
  ``make_sharded_train_step`` (2 views); ``make_depth_slab_train_step``
  (4 slabs, L1) against ``fit.make_train_step`` (``"jnp"``, the list
  compositor the slabs run);
- the port, on its plain CPU backends (``"torch"`` for steps), through the
  same functions on gloo ranks (``tests/torch_parallel_ranks.py``).

Each line is a JSON object: the loss difference; per field, the gradient
difference over the field's max |g| (gradients read from Adam's first
moment, (1 - b1)·g after one step from a fresh state); the entries whose
two gradients differ in sign (zero against non-zero counts); and the
largest parameter difference after the step.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from dge_tpu.parallel import gauss_shard as JGS
from dge_tpu.parallel import mesh as JM
from dge_tpu.parallel import shard as JS
from dge_tpu.parallel import tile_shard as JTS
from dge_tpu.scene import dataset as JDS
from dge_tpu.scene.camera_arrays import CameraArrays
from dge_tpu.scene import gaussians as JG
from dge_tpu.systems import fit as JF
from dge_tpu.systems import optim as JO
from dge_tpu.utils import saving as JSAV
from dge_tpu_torch.parallel import dist as D
from tests import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY_PLY = os.path.join(
    ROOT, "outputs", "quality_gate", "20260821-064841", "fitdemo",
    "tpu@20260821-064841", "point_cloud.ply")
CAPTURE = os.path.join(ROOT, "outputs", "fit_capture")
VIEWS = (0, 8)
SIZE = 256  # the capture's own size
# JAX's sharded steps keep the default cap of 32 tiles a Gaussian: at 256^2
# only 64 px tiles keep the whole image from dropping the largest
# Gaussians' tiles, which its bands keep
JAX_TILE_PX = 64
# the port's caps grow until nothing spills; its plain CPU backend holds a
# tile's pixels for every pair, so 64 px tiles would take four times the
# memory
PORT_TILE_PX = 32
B1 = 0.9
FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")


def _adam_mu(opt_state, field):
    """The first moment of ``field`` in a ``multi_transform`` of Adams."""
    inner = opt_state.inner_states[field]
    for leaf in jax.tree_util.tree_leaves(
            inner, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return np.asarray(leaf.mu[field])
    raise KeyError(field)


def jax_step_result(res):
    """(scene, opt_state, fit_state, aux) of one JAX step from a fresh
    state → parameters, gradients, loss, spill."""
    scene, opt_state, fit_state, aux = res
    return dict(params={k: np.asarray(getattr(scene, k)) for k in FIELDS},
                grads={k: _adam_mu(opt_state, k) / (1.0 - B1)
                       for k in FIELDS},
                loss=float(aux["loss"]), spill=int(aux.get("spill", 0)))


def compare(got: dict, want: dict) -> dict:
    """One step's result against another's (``params``, ``grads``,
    ``loss``)."""
    out = dict(loss=abs(got["loss"] - want["loss"]), grad_rel={},
               sign_flips={}, params_max=0.0)
    for k in FIELDS:
        g, w = got["grads"][k], want["grads"][k]
        out["grad_rel"][k] = float(np.abs(g - w).max()
                                   / max(float(np.abs(w).max()), 1e-30))
        out["sign_flips"][k] = int((np.sign(g) != np.sign(w)).sum())
        out["params_max"] = max(out["params_max"], float(np.abs(
            got["params"][k] - want["params"][k]).max()))
    out["grad_rel_max"] = max(out["grad_rel"].values())
    out["sign_flips_total"] = sum(out["sign_flips"].values())
    return out


def inputs():
    scene = JG.load_ply(QUALITY_PLY)
    cs = JDS.ColmapScene(CAPTURE, height=SIZE, width=SIZE)
    cams = [cs.cameras[v] for v in VIEWS]
    targets = np.stack([JSAV.load_image(os.path.join(
        CAPTURE, "images", c.image_name + ".png")) for c in cams])
    return (scene, [CameraArrays.from_camera(c) for c in cams],
            targets.astype(np.float32))


def list_cap(scene, cams, tile_px: int, chunk: int) -> int:
    """The largest per-tile list over the views, rounded up to the chunk
    (the list compositor's cost grows with the cap)."""
    from dge_tpu.ops import binning, projection

    most = 0
    for cam in cams:
        prep = projection.preprocess(
            scene.xyz, scene.get_scaling, scene.get_rotation,
            scene.get_opacity, scene.get_features, scene.alive, cam,
            scene.active_sh_degree, scene.max_sh_degree)
        bins = binning.bin_gaussians(
            prep.mean2d, prep.depth, prep.radius, prep.visible,
            height=cam.height, width=cam.width, tile_px=tile_px,
            max_per_tile=1 << 14)
        most = max(most, int(np.asarray(bins.counts).max()))
    return -(-most // chunk) * chunk


def jax_readings(scene, cams, targets, kw) -> dict:
    def fresh():
        opt = JO.make_optimizer(JO.OptimConfig.scaled(100))
        return opt, opt.init(scene.params()), JF.FitState.create(
            scene.capacity)

    batch = JM.stack_cameras(cams)
    tg = jnp.asarray(targets)
    bg = jnp.zeros(3)
    size = cams[0].height
    opt, st, fs = fresh()
    views = jax_step_result(JS.make_sharded_train_step(
        opt, JM.make_view_mesh(2), lambda_dssim=0.2, **kw)(
        scene, st, fs, batch, tg, bg))
    opt, st, fs = fresh()
    bands = jax_step_result(JTS.make_view_tile_train_step(
        opt, JTS.make_view_tile_mesh(2, 2), size, size, lambda_dssim=0.2,
        **kw)(scene, st, fs, batch, tg, bg))
    opt, st, fs = fresh()
    whole = jax_step_result(JF.make_train_step(
        opt, lambda_dssim=0.0, backend="jnp", **kw)(
        scene, st, fs, cams[0], tg[0], bg))
    opt, st, fs = fresh()
    slabs = jax_step_result(JGS.make_depth_slab_train_step(
        opt, JGS.make_gauss_mesh(4), size, size, **kw)(
        scene, st, fs, cams[0], tg[0], bg))
    return dict(view_tile_vs_view_sharded=compare(bands, views),
                depth_slab_vs_unsharded=compare(slabs, whole),
                spill=dict(views=views["spill"], bands=bands["spill"],
                           whole=whole["spill"], slabs=slabs["spill"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("dge_tpu", "dge_tpu_torch"),
                    action="append", help="one package only (default both)")
    args = ap.parse_args(argv)
    t0 = time.time()
    scene, cams, targets = inputs()
    print(json.dumps(dict(scene=os.path.relpath(QUALITY_PLY, ROOT),
                          views=VIEWS, size=SIZE,
                          alive=int(np.asarray(scene.alive).sum()))))
    packages = args.package or ("dge_tpu", "dge_tpu_torch")
    if "dge_tpu" in packages:
        kw = dict(tile_px=JAX_TILE_PX, chunk=64)
        kw["max_per_tile"] = list_cap(scene, cams, kw["tile_px"], 64)
        print(json.dumps(dict(package="dge_tpu", **kw, **jax_readings(
            scene, cams, targets, kw))), flush=True)
    if "dge_tpu_torch" not in packages:
        return 0
    got = D.spawn_local(ranks.decomposition, 4, device="cpu",
                        args=(QUALITY_PLY, CAPTURE, VIEWS, SIZE,
                              PORT_TILE_PX),
                        timeout=datetime.timedelta(hours=1))[0]
    print(json.dumps(dict(
        package="dge_tpu_torch", tile_px=PORT_TILE_PX,
        view_tile_vs_view_sharded=compare(got["view_tile"], got["views"]),
        depth_slab_vs_unsharded=compare(got["slabs"], got["whole"]),
        spill={k: v["spill"] for k, v in got.items()})))
    print(json.dumps(dict(seconds=time.time() - t0)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
