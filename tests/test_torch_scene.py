"""Scene layer of the PyTorch port against the JAX package: PLY, COLMAP
capture, cameras, PNG codec, config, device rule and import hygiene.

The port runs on the CPU here; the same numpy inputs go through both
packages."""

import math
import os
import re

import numpy as np
import pytest
import torch

from dge_tpu.scene import dataset as JDS
from dge_tpu.scene import gaussians as JG
from dge_tpu.scene import look_at_camera as j_look_at
from dge_tpu.scene.camera_arrays import CameraArrays as JCameraArrays
from dge_tpu_torch import resolve_device
from dge_tpu_torch.scene import cameras as TC
from dge_tpu_torch.scene import colmap as TCOL
from dge_tpu_torch.scene import dataset as TDS
from dge_tpu_torch.scene import gaussians as TG
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.utils import config as TCFG
from dge_tpu_torch.utils import saving as TS
from tests.conftest import make_random_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PLY = os.path.join(ROOT, "outputs", "bench_scene", "point_cloud.ply")
CAPTURE = os.path.join(ROOT, "outputs", "fit_capture")
LEAVES = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation", "alive")


def to_port(jscene, device="cpu"):
    """A dge_tpu GaussianScene's buffers carried across as numpy arrays."""
    return TG.from_numpy_params(
        *(np.asarray(getattr(jscene, k)) for k in LEAVES),
        active_sh_degree=int(jscene.active_sh_degree),
        max_sh_degree=jscene.max_sh_degree,
        device=device,
    )


def test_ply_round_trip(rng, tmp_path):
    js = make_random_scene(rng, n=50, max_sh_degree=2)
    ts = to_port(js)
    path = str(tmp_path / "a.ply")
    TG.save_ply(ts, path)
    back = TG.load_ply(path, capacity=ts.capacity, device="cpu")
    for k in LEAVES:
        assert torch.equal(getattr(back, k), getattr(ts, k)), k
    assert back.max_sh_degree == 2 and back.active_sh_degree == 2
    rgb = rng.uniform(size=(7, 3))
    np.testing.assert_array_equal(TG.rgb_to_sh(rgb), JG.rgb_to_sh(rgb))
    for n in (1, 4096, 4097, 115308):
        assert TG.round_capacity(n) == JG.round_capacity(n)


@pytest.mark.parametrize("degree", [0, 3])
def test_ply_byte_identical_with_reference(rng, tmp_path, degree):
    js = make_random_scene(rng, n=40, max_sh_degree=degree)
    JG.save_ply(js, str(tmp_path / "ref.ply"))
    TG.save_ply(to_port(js), str(tmp_path / "port.ply"))
    assert (tmp_path / "ref.ply").read_bytes() == \
        (tmp_path / "port.ply").read_bytes()


def test_load_bench_ply_matches_reference():
    js = JG.load_ply(BENCH_PLY)
    ts = TG.load_ply(BENCH_PLY, device="cpu")
    assert ts.n_alive == int(js.n_alive) == 115308
    assert ts.capacity == js.capacity
    assert ts.max_sh_degree == js.max_sh_degree == 0
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    # activations agree to f32 rounding
    np.testing.assert_allclose(ts.get_opacity.numpy(),
                               np.asarray(js.get_opacity), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.get_rotation.numpy(),
                               np.asarray(js.get_rotation), rtol=1e-6, atol=1e-7)


def test_colmap_scene_matches_reference():
    jcs = JDS.ColmapScene(CAPTURE, height=256, width=256)
    tcs = TDS.ColmapScene(CAPTURE, height=256, width=256)
    assert len(tcs.cameras) == len(jcs.cameras) == 16
    assert tcs.cameras_extent == pytest.approx(jcs.cameras_extent, abs=1e-9)
    for jc, tc in zip(jcs.cameras, tcs.cameras):
        assert tc.image_name == jc.image_name
        assert tc.fovx == pytest.approx(jc.fovx, abs=1e-12)
        assert tc.fovy == pytest.approx(jc.fovy, abs=1e-12)
        for attr in ("w2c", "full_proj", "proj", "camera_center"):
            np.testing.assert_allclose(getattr(tc, attr), getattr(jc, attr),
                                       atol=1e-6, err_msg=attr)
        ja = JCameraArrays.from_camera(jc)
        ta = CameraArrays.from_camera(tc, device="cpu")
        for attr in ("w2c", "full_proj", "campos", "tan_half_fovx",
                     "tan_half_fovy", "focal_x", "focal_y"):
            np.testing.assert_allclose(getattr(ta, attr).numpy(),
                                       np.asarray(getattr(ja, attr)),
                                       atol=1e-6, err_msg=attr)


def test_look_at_camera_matches_reference():
    eye, target = np.array([2.3, 0.9, -2.3]), np.array([0.0, -0.45, 0.0])
    jc = j_look_at(eye, target, fovx=math.radians(60), height=1080, width=1920)
    tc = TC.look_at_camera(eye, target, fovx=math.radians(60), height=1080,
                           width=1920)
    np.testing.assert_array_equal(tc.w2c, jc.w2c)
    np.testing.assert_array_equal(tc.full_proj, jc.full_proj)
    assert tc.focal_x == jc.focal_x and tc.fovy == jc.fovy


def test_colmap_binary_text_round_trip(tmp_path):
    cams = {1: TCOL.ColmapCamera(1, "PINHOLE", 64, 48,
                                 np.array([50.0, 51.0, 32.0, 24.0]))}
    q = np.array([0.9, 0.1, -0.3, 0.2])
    images = {3: TCOL.ColmapImage(3, q / np.linalg.norm(q),
                                  np.array([0.1, 0.2, 3.0]), 1, "v.png")}
    TCOL.write_cameras_binary(cams, str(tmp_path / "cameras.bin"))
    TCOL.write_images_binary(images, str(tmp_path / "images.bin"))
    xyz = np.arange(12, dtype=np.float64).reshape(4, 3)
    rgb = np.array([[0, 128, 255]] * 4, np.uint8)
    TCOL.write_points3d_binary(xyz, rgb, str(tmp_path / "points3D.bin"))
    rc, ri = TCOL.load_sparse(str(tmp_path))
    assert rc[1].model == "PINHOLE" and rc[1].width == 64
    np.testing.assert_array_equal(rc[1].params, cams[1].params)
    np.testing.assert_array_equal(ri[3].qvec, images[3].qvec)
    assert ri[3].name == "v.png"
    pxyz, prgb = TCOL.read_points3d_binary(str(tmp_path / "points3D.bin"))
    np.testing.assert_array_equal(pxyz, xyz)
    np.testing.assert_allclose(prgb, rgb / 255.0, atol=1e-7)


def test_png_codec_round_trips_capture_images(tmp_path):
    """The stdlib PNG reader decodes the committed capture PNGs bit for bit
    (held against imageio), and the writer's file decodes back to the same
    bytes."""
    import imageio.v2 as imageio

    for name in ("view_00.png", "view_09.png"):
        path = os.path.join(CAPTURE, "images", name)
        with open(path, "rb") as f:
            img = TS.decode_png(f.read())
        np.testing.assert_array_equal(img, np.asarray(imageio.imread(path)))
        out = str(tmp_path / name)
        TS.save_image(out, img)
        with open(out, "rb") as f:
            np.testing.assert_array_equal(TS.decode_png(f.read()), img)
        np.testing.assert_array_equal(np.asarray(imageio.imread(out)), img)
        np.testing.assert_allclose(TS.load_image(out), img / 255.0, atol=1e-7)


def test_dotted_overrides_without_config_file():
    cfg = TCFG.load_config(None, ["data.height=256", "data.width=128",
                                  "name=x", "system.flag=true", "a.b=0.5"])
    assert cfg == {"data": {"height": 256, "width": 128}, "name": "x",
                   "system": {"flag": True}, "a": {"b": 0.5}}
    with pytest.raises(ValueError, match="not key=value"):
        TCFG.apply_dotlist({}, ["oops"])


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        TG.from_arrays(np.zeros((2, 3)), np.zeros((2, 1, 3)),
                       np.zeros((2, 0, 3)), np.zeros((2, 1)), np.zeros((2, 3)),
                       np.tile([1.0, 0, 0, 0], (2, 1)), max_sh_degree=0)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of dge_tpu_torch (nor chip_smoke.py) imports jax or
    dge_tpu: a scan of the sources."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|dge_tpu)\b"
                     r"(?!_torch)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "dge_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    offenders = []
    for path in files:
        with open(path) as f:
            src = f.read()
        offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                      for m in bad.finditer(src)]
    assert offenders == []
