"""The render slice of the PyTorch port as a whole against the JAX package:
``render`` against JAX ``render(backend="pallas_stream")`` (the Pallas
kernel in interpret mode, as tests/test_pallas.py runs it), the spill-free
cap ladder, carrying a JAX scene across, and the CLI on a tiny synthetic
capture. The port runs on the CPU (backend "torch", the kernel's plain
version). Tolerances: colour 1e-4, depth 1e-3, alpha 2e-4."""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.ops import render as JR
from dge_tpu_torch.ops import render as TR
from dge_tpu_torch.scene import cameras as TC
from dge_tpu_torch.scene import colmap as TCOL
from dge_tpu_torch.scene import gaussians as TG
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.utils import saving as TS
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_scene import ROOT, to_port


def j_render(js, jcam, bg, **kw):
    """JAX pair-stream render (Pallas kernel in interpret mode), jitted:
    one compile is cheaper than the eager op-by-op warm-up."""
    return jax.jit(lambda s, c: JR.render(s, c, bg, backend="pallas_stream",
                                          **kw))(js, jcam)


def assert_close_render(out, ref):
    np.testing.assert_allclose(out.color.numpy(), np.asarray(ref.color),
                               atol=1e-4)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth),
                               atol=1e-3)
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(ref.alpha),
                               atol=2e-4)
    assert int(out.spill) == int(ref.spill)
    np.testing.assert_array_equal(out.spill_parts.numpy(),
                                  np.asarray(ref.spill_parts))


@pytest.mark.parametrize("angle,cull", [(0.0, False), (1.3, False),
                                        (2.0, True)])
def test_render_matches_pallas_stream(rng, angle, cull):
    js = make_random_scene(rng, n=96)
    cam, jcam = make_test_camera(height=32, width=32, angle=angle)
    bg = np.array([0.3, 0.0, 0.2], np.float32)
    ref = j_render(js, jcam, jnp.asarray(bg), tile_px=16, max_per_tile=128,
                   tight_cull=cull)
    out = TR.render(to_port(js), CameraArrays.from_camera(cam, "cpu"),
                    torch.from_numpy(bg), tile_px=16, max_per_tile=128,
                    tight_cull=cull)
    assert_close_render(out, ref)
    assert float(out.alpha.max()) > 0.5  # the scene is really in view


def test_carry_over_from_numpy_params(rng):
    """A padded JAX scene (dead slots, SH degree 2 at active degree 1)
    carried across with from_numpy_params renders as the JAX one does."""
    from dge_tpu.scene import gaussians as JG

    js = make_random_scene(rng, n=120, capacity=160, max_sh_degree=2)
    js = js.replace(active_sh_degree=jnp.asarray(1, jnp.int32))
    ts = to_port(js)
    assert ts.capacity == 160 and ts.n_alive == 120
    assert ts.active_sh_degree == 1 and ts.max_sh_degree == 2
    assert float(ts.opacity[~ts.alive].max()) == -10.0
    assert float(ts.scaling[~ts.alive].max()) == -20.0
    cam, jcam = make_test_camera(height=48, width=64, angle=0.4)
    ref = j_render(js, jcam, None, tile_px=16, max_per_tile=256)
    out = TR.render(ts, CameraArrays.from_camera(cam, "cpu"), None,
                    tile_px=16, max_per_tile=256)
    assert_close_render(out, ref)
    assert isinstance(js, JG.GaussianScene)


def test_spill_free_ladder_matches_reference(rng):
    """From deliberately tiny caps, the port's ladder climbs the same rungs
    as the JAX one (pallas_stream) to spill 0, and the final render matches
    a direct render at generous caps (tests/test_render.py:621-660). The
    direct render culls too: the pair-stream image depends on where the
    stream's chunk blocks fall (see test_torch_ops.py), so it is compared on
    the same stream, which spill 0 makes independent of the caps."""
    js = make_random_scene(rng, n=256)
    cam, jcam = make_test_camera(height=64, width=64)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    caps = dict(max_per_tile=4, max_tiles_per_gaussian=4, max_pairs=256,
                big_capacity=64)
    jlog, tlog = [], []
    jr = JR.SpillFreeRenderer(js, jnp.asarray(bg), tile_px=16,
                              backend="pallas_stream", log=jlog.append,
                              **caps)
    tr = TR.SpillFreeRenderer(to_port(js), torch.from_numpy(bg), tile_px=16,
                              log=tlog.append, **caps)
    tcam = CameraArrays.from_camera(cam, "cpu")
    assert tr.caps == jr.caps
    assert tr.probe(tcam) == 0
    assert jr.probe(jcam) == 0
    assert tlog == jlog and len(tlog) > 1  # cull rung, then growth rungs
    assert tr.caps == jr.caps
    assert tr.caps["max_per_tile"] > caps["max_per_tile"]
    color, sp = tr(tcam)
    assert sp == 0
    # the ladder ends with a short stream whose last chunk block holds the
    # last tiles' pairs, which the JAX kernel re-runs (ROADMAP.md §3); a 4x
    # longer stream cap keeps the same pairs and leaves that fault out
    final = dict(tr.caps, max_pairs=4 * tr.caps["max_pairs"])
    ref = j_render(js, jcam, jnp.asarray(bg), tile_px=16, tight_cull=True,
                   **final)
    np.testing.assert_allclose(color.numpy(), np.asarray(ref.color), atol=1e-4)
    direct = TR.render(to_port(js), tcam, torch.from_numpy(bg), tile_px=16,
                       max_per_tile=2048, tight_cull=True)
    assert int(direct.spill) == 0
    np.testing.assert_allclose(color.numpy(), direct.color.numpy(), atol=1e-5)


def test_spill_free_no_growth_when_caps_suffice(rng):
    js = make_random_scene(rng, n=64)
    cam, _ = make_test_camera(height=32, width=32)
    grew = []
    r = TR.SpillFreeRenderer(to_port(js), None, tile_px=16, log=grew.append)
    assert r.probe(CameraArrays.from_camera(cam, "cpu")) == 0
    assert grew == [] and not r.tight_cull


def test_backend_device_pairing(rng):
    ts = to_port(make_random_scene(rng, n=16))
    cam, _ = make_test_camera(height=32, width=32)
    tcam = CameraArrays.from_camera(cam, "cpu")
    with pytest.raises(ValueError, match="does not run"):
        TR.SpillFreeRenderer(ts, backend="cuda_stream")
    with pytest.raises(ValueError, match="unknown render backend"):
        TR.render(ts, tcam, backend="pallas_stream", tile_px=16)
    assert TR.default_backend("cpu") == "torch"
    assert TR.default_backend("cuda") == "cuda_stream"


def write_synthetic_capture(root, n_views=2, size=32):
    """A tiny COLMAP capture (binary) whose images are the port's own
    renders of a random scene, plus that scene as a PLY."""
    rng = np.random.default_rng(3)
    n = 60
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    scene = TG.from_arrays(
        rng.normal(size=(n, 3)).astype(np.float32) * 0.6,
        rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.5,
        np.zeros((n, 0, 3), np.float32),
        rng.uniform(0.0, 3.0, size=(n, 1)).astype(np.float32),
        rng.uniform(-3.0, -2.0, size=(n, 3)).astype(np.float32),
        rot / np.linalg.norm(rot, axis=1, keepdims=True),
        max_sh_degree=0, device="cpu")
    ply = os.path.join(root, "scene.ply")
    TG.save_ply(scene, ply)
    sparse = os.path.join(root, "capture", "sparse", "0")
    os.makedirs(sparse)
    fovx = math.radians(60)
    focal = TC.fov2focal(fovx, size)
    cams = {1: TCOL.ColmapCamera(1, "PINHOLE", size, size,
                                 np.array([focal, focal, size / 2, size / 2]))}
    images = {}
    for i in range(n_views):
        a = 0.5 * i
        cam = TC.look_at_camera(
            np.array([4 * math.sin(a), 0.3, -4 * math.cos(a)]), np.zeros(3),
            fovx=fovx, height=size, width=size)
        images[i + 1] = TCOL.ColmapImage(
            i + 1, TC.rotmat2qvec(cam.R.T), cam.T, 1, f"view_{i:02d}.png")
        color = TR.render(scene, CameraArrays.from_camera(cam, "cpu"),
                          max_per_tile=4096).color
        TS.save_image(os.path.join(root, "capture", "images",
                                   f"view_{i:02d}.png"), color.numpy())
    TCOL.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    TCOL.write_images_binary(images, os.path.join(sparse, "images.bin"))
    return ply, os.path.join(root, "capture")


def test_cli_render_on_cpu(tmp_path):
    ply, capture = write_synthetic_capture(str(tmp_path))
    out = str(tmp_path / "out")
    res = subprocess.run(
        [sys.executable, "-m", "dge_tpu_torch.launch", "--render", "--cpu",
         "--gs_source", ply, "--source", capture, "--out", out,
         "data.height=32", "data.width=32"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    (trial,) = [os.path.join(dp) for dp, dn, _ in os.walk(out)
                if "renders" in dn]
    with open(os.path.join(trial, "cmd.txt")) as f:
        assert "--render" in f.read()
    import json

    with open(os.path.join(trial, "parsed.yaml")) as f:
        assert json.load(f) == {"data": {"height": 32, "width": 32}}
    for i in range(2):
        got = TS.load_image(os.path.join(trial, "renders", f"{i:04d}.png"))
        want = TS.load_image(os.path.join(capture, "images",
                                          f"view_{i:02d}.png"))
        assert got.shape == (32, 32, 3)
        assert got.std() > 0.01  # not a blank frame
        np.testing.assert_array_equal(got, want)


def test_cli_cuda_without_card_fails(tmp_path, monkeypatch):
    """Without --cpu the CLI runs on the card, and without one it raises
    rather than moving to the CPU."""
    from dge_tpu_torch import launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available\\(\\) is False"):
        launch.main(["--render", "--gs_source", "x.ply", "--source", "x",
                     "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)  # failed before writing anything
