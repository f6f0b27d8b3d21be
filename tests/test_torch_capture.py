"""The port's capture paths against the JAX package, on the CPU:
``scene/dataset.py`` (``BlenderScene``, ``load_scene``,
``sort_cameras_ring``), the camera helpers of ``scene/cameras.py``, the
native ``points3D.bin`` parser, ``tools/make_bench_capture.py``,
``tools/quality_gate.py`` and ``launch --render`` of a Blender capture.

Tolerances: Blender cameras (R, T, fovx, fovy) within 1e-12 of JAX's
(the same float64 arithmetic); camera helpers and the ring order equal;
the points parsers equal; the capture tool's ground truth, COLMAP files
and PLY byte for byte, its images within 1/255 (one 8-bit level: the two
renderers round differently); a Blender render within 1e-6 of the same
capture's COLMAP render (the cameras agree within 1e-15)."""

import json
import math
import os

import numpy as np
import pytest
import torch

from dge_tpu.scene import cameras as JC
from dge_tpu.scene import dataset as JDS
from dge_tpu_torch import launch
from dge_tpu_torch.scene import cameras as TC
from dge_tpu_torch.scene import colmap as TCOL
from dge_tpu_torch.scene import dataset as TDS
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.tools import make_bench_capture as TMB
from dge_tpu_torch.tools import quality_gate as TQG
from dge_tpu_torch.utils import saving
from tests.test_torch_render import write_synthetic_capture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTURE = os.path.join(ROOT, "outputs", "fit_capture")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module: the suite runs in parallel
    workers, and there the plain compositor's many small parallel regions
    at the default count wait on the other workers' threads (a renderer
    call takes seconds instead of milliseconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def blender_twin(colmap_source, out, height=256, width=256):
    """``out`` as a Blender capture of the COLMAP capture's cameras."""
    cs = TDS.ColmapScene(colmap_source, height=height, width=width)
    TDS.write_transforms(cs.cameras, out,
                         [f"images/{c.image_name}" for c in cs.cameras])
    return cs


def test_blender_cameras_match_jax(tmp_path):
    cs = blender_twin(CAPTURE, str(tmp_path))
    for h, w in ((256, 256), (200, 320)):
        ts = TDS.BlenderScene(str(tmp_path), height=h, width=w)
        js = JDS.BlenderScene(str(tmp_path), height=h, width=w)
        assert len(ts.cameras) == len(js.cameras) == 16
        assert ts.image_paths == js.image_paths
        assert ts.image_paths[3] == os.path.join(
            str(tmp_path), "images", cs.cameras[3].image_name)
        assert abs(ts.cameras_extent - js.cameras_extent) < 1e-12
        for t, j in zip(ts.cameras, js.cameras):
            np.testing.assert_allclose(t.R, j.R, atol=1e-12, rtol=0)
            np.testing.assert_allclose(t.T, j.T, atol=1e-12, rtol=0)
            assert abs(t.fovx - j.fovx) < 1e-12
            assert abs(t.fovy - j.fovy) < 1e-12
            assert (t.image_name, t.uid, t.height) == (j.image_name, j.uid, h)
    # the round trip through OpenGL axes gives back the COLMAP cameras
    ts = TDS.BlenderScene(str(tmp_path), height=256, width=256)
    for t, c in zip(ts.cameras, cs.cameras):
        np.testing.assert_allclose(t.R, c.R, atol=1e-12, rtol=0)
        np.testing.assert_allclose(t.T, c.T, atol=1e-12, rtol=0)
        assert abs(t.fovy - c.fovy) < 1e-12


def test_load_scene_dispatch(tmp_path):
    assert isinstance(TDS.load_scene(CAPTURE, 64, 64), TDS.ColmapScene)
    blender = tmp_path / "blender"
    blender_twin(CAPTURE, str(blender))
    got = TDS.load_scene(str(blender), 64, 64)
    assert isinstance(got, TDS.BlenderScene) and len(got.cameras) == 16
    assert isinstance(JDS.load_scene(str(blender), 64, 64),
                      JDS.BlenderScene)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="unrecognized scene type"):
        TDS.load_scene(str(empty))
    with pytest.raises(FileNotFoundError, match="unrecognized scene type"):
        JDS.load_scene(str(empty))


def test_sort_cameras_ring_matches_jax():
    t_cams = TDS.ColmapScene(CAPTURE, 64, 64).cameras
    j_cams = JDS.ColmapScene(CAPTURE, 64, 64).cameras
    got = TDS.sort_cameras_ring(t_cams)
    assert got == JDS.sort_cameras_ring(j_cams)
    assert sorted(got) == list(range(16))
    # a random ring, tilted, in shuffled order
    rng = np.random.default_rng(4)
    angles = rng.uniform(0, 2 * math.pi, 11)
    eyes = [np.array([3 * math.cos(a), 0.4 + 0.3 * math.cos(a),
                      3 * math.sin(a)]) for a in angles]
    got = TDS.sort_cameras_ring([TC.look_at_camera(e, np.zeros(3))
                                 for e in eyes])
    assert got == JDS.sort_cameras_ring([JC.look_at_camera(e, np.zeros(3))
                                         for e in eyes])
    assert sorted(got) == list(range(11))
    # consecutive cameras of the order are neighbours on the ring
    step = np.diff(np.unwrap(angles[got]))
    assert np.all(np.sign(step) == np.sign(step[0]))


def test_camera_helpers_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(3):
        q = rng.normal(size=4)
        c2w = np.eye(4)
        c2w[:3, :3] = TC.qvec2rotmat(q / np.linalg.norm(q))
        c2w[:3, 3] = rng.normal(size=3) * 3
        fovy = rng.uniform(0.4, 1.2)
        t = TC.Camera.from_c2w(c2w, fovy, 48, 80, uid=7, image_name="x")
        j = JC.Camera.from_c2w(c2w, fovy, 48, 80, uid=7, image_name="x")
        np.testing.assert_array_equal(t.R, j.R)
        np.testing.assert_array_equal(t.T, j.T)
        assert (t.fovx, t.fovy, t.uid, t.image_name) == \
            (j.fovx, j.fovy, j.uid, j.image_name)
        for name in ("world_view_transform_t", "full_proj_transform_t",
                     "w2c", "full_proj"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        np.testing.assert_array_equal(t.world_view_transform_t, t.w2c.T)
        tr, jr = t.resized(24, 40), j.resized(24, 40)
        assert (tr.height, tr.width, tr.fovx, tr.fovy) == \
            (jr.height, jr.width, jr.fovx, jr.fovy) == (24, 40, t.fovx, fovy)
        np.testing.assert_array_equal(tr.full_proj, jr.full_proj)
        ca = TC.camera_arrays(t, device="cpu")
        assert isinstance(ca, CameraArrays) and (ca.height, ca.width) == (48,
                                                                          80)
        np.testing.assert_array_equal(ca.full_proj.numpy(), t.full_proj)


def test_colmap_points3d_native_matches_jax_and_python():
    from dge_tpu import native as JN
    from dge_tpu_torch import native as TN

    path = os.path.join(CAPTURE, "sparse", "0", "points3D.bin")
    got = TN.colmap_points3d(path)
    if got is None:
        pytest.skip("no C++ compiler: the native parser cannot build here")
    before = dict(TCOL.points_parser_counts)
    via = TCOL.read_points3d_binary(path)
    assert TCOL.points_parser_counts["native"] == before["native"] + 1
    assert TCOL.points_parser_counts["python"] == before["python"]
    loop = TCOL.read_points3d_binary_python(path)
    jax_native = JN.colmap_points3d(path)
    assert got[0].shape == (8000, 3) and got[0].dtype == np.float64
    assert got[1].dtype == np.float32
    for other in (via, loop, jax_native):
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_array_equal(got[1], other[1])
    assert TN.colmap_points3d(os.path.join(CAPTURE, "missing.bin")) is None


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """Both tools at 2 views of 64²: the port's on the CPU; the JAX tool
    with its starting max_per_tile raised to 2^17, since at 64² its view 1
    spills at the caps it probed on view 0 and it stops (the port grows
    the caps per view instead)."""
    from dge_tpu.ops import render as JR
    from tools import make_bench_capture as JMB

    root = tmp_path_factory.mktemp("captures")
    argv = ["--views", "2", "--size", "64"]
    port = TMB.main(argv + ["--out", str(root / "port"), "--cpu"])
    real = JR.render

    def raised(scene, cam, bg, **kw):
        kw["max_per_tile"] = max(kw["max_per_tile"], 1 << 17)
        return real(scene, cam, bg, **kw)

    JR.render = raised
    try:
        JMB.main(argv + ["--out", str(root / "jax")])
    finally:
        JR.render = real
    return port, str(root / "port"), str(root / "jax")


def test_bench_capture_ground_truth_matches_jax():
    from tools import make_bench_capture as JMB

    for port_fn, jax_fn in ((TMB.build_gt_scene, JMB.build_gt_scene),
                            (TMB.build_gt_scene_hi_aniso,
                             JMB.build_gt_scene_hi_aniso)):
        gt = port_fn(0)
        js, jxyz, jcol = jax_fn(0)
        n = len(gt["xyz"])
        assert n == int(js.n_alive) and n > 100_000
        np.testing.assert_array_equal(gt["xyz"], jxyz)
        np.testing.assert_array_equal(gt["col"], jcol)
        for name, field in (("scaling", "scaling"), ("quat", "rotation"),
                            ("opac", "opacity")):
            np.testing.assert_array_equal(
                gt[name].astype(np.float32),
                np.asarray(getattr(js, field))[:n], err_msg=name)
        np.testing.assert_array_equal(
            gt["fdc"].astype(np.float32), np.asarray(js.features_dc)[:n])


def test_bench_capture_files_match_jax(captures):
    run, port, jax_dir = captures
    assert run.spills == [0, 0] and run.n_gaussians > 100_000
    assert run.launches["pairs_composite"] == 0  # the CPU: no kernel
    for f in ("sparse/0/cameras.bin", "sparse/0/images.bin",
              "sparse/0/points3D.bin", "gt_scene.ply"):
        with open(os.path.join(port, f), "rb") as a, \
                open(os.path.join(jax_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(port, "cfg.yaml")) as a, \
            open(os.path.join(jax_dir, "cfg.yaml")) as b:
        assert a.read().replace("tag: gpu", "tag: tpu") == b.read()
    for i in range(2):
        name = f"images/view_{i:02d}.png"
        a = saving.load_image(os.path.join(port, name))
        b = saving.load_image(os.path.join(jax_dir, name))
        assert a.shape == (64, 64, 3) and float(a.mean()) > 0.1
        assert float(np.abs(a - b).max()) <= 1.0 / 255.0 + 1e-6, name
    # the capture loads and points the fit at SH degree 0
    cs = TDS.load_scene(port, 64, 64)
    assert isinstance(cs, TDS.ColmapScene) and len(cs.cameras) == 2
    assert cs.point_cloud()[0].shape == (60_000, 3)


def test_quality_gate_on_cpu(tmp_path, capsys):
    argv = ["--steps", "3", "--cpu", "--out", str(tmp_path),
            "data.height=16", "data.width=16"]
    assert TQG.main(argv + ["--min-psnr", "0"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["pass"] and summary["steps"] == 3
    assert summary["spill"] == 0 and math.isfinite(summary["psnr"])
    assert summary["n_alive"] == summary["n_gaussians"] == 8000
    assert summary["fit_steps_per_s"] > 0 and summary["peak_mem_gib"] is None
    assert os.path.exists(summary["results_json"])
    assert TQG.main(argv + ["--min-psnr", "1000"]) == 1
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not summary["pass"] and summary["min_psnr"] == 1000


def test_render_blender_capture(tmp_path):
    """``--render`` of a Blender capture renders what the same cameras'
    COLMAP capture renders; the COLMAP-only modes refuse it."""
    ply, capture = write_synthetic_capture(str(tmp_path))
    blender = str(tmp_path / "blender")
    blender_twin(capture, blender, 32, 32)
    runs = [launch.main(["--render", "--cpu", "--gs_source", ply, "--source",
                         src, "--out", str(tmp_path / "out"),
                         "data.height=32", "data.width=32"])
            for src in (capture, blender)]
    assert [len(r.frames) for r in runs] == [2, 2]
    assert runs[1].image_names == ["view_00", "view_01"]
    assert runs[0].spill == runs[1].spill == 0
    for a, b in zip(*(r.frames for r in runs)):
        assert float(a.max()) > 0.05
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert os.path.exists(os.path.join(runs[1].trial_dir, "renders",
                                       "0001.png"))
    for mode in ("--fit", "--validate"):
        with pytest.raises(ValueError, match="Blender capture"):
            launch.main([mode, "--cpu", "--gs_source", ply, "--source",
                         blender, "--out", str(tmp_path / "out")])
