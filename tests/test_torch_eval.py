"""The evaluation path of the PyTorch port against the JAX package: image
loading (extension search, JPEG, area resize against the JAX ``load_image``),
``evaluate_pair_dirs``, the ``full_eval`` tool against the JAX tool on a tiny
synthetic capture, the CLI modes ``--validate`` / ``--test`` / ``--export``,
and the checkpoint round trip. The port runs on the CPU. Each test states
its tolerance."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from dge_tpu.ops import metrics as JM
from dge_tpu.utils import saving as JS
from dge_tpu_torch import launch
from dge_tpu_torch.ops import metrics as TM
from dge_tpu_torch.scene import colmap as TCOL
from dge_tpu_torch.scene import gaussians as TG
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.systems import fit as TF
from dge_tpu_torch.systems import optim as TO
from dge_tpu_torch.tools import full_eval as TFE
from dge_tpu_torch.utils import checkpoint as TCK
from dge_tpu_torch.utils import saving as TS
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_fit import port_scene
from tests.test_torch_render import write_synthetic_capture
from tests.test_torch_scene import ROOT


# ---- image loading --------------------------------------------------------

@pytest.mark.parametrize("size,atol", [((32, 48), 1e-6), ((16, 16), 1e-6),
                                        ((40, 50), 1e-6), ((64, 96), 0.0)])
def test_load_image_resizes_as_reference(rng, tmp_path, size, atol):
    """``load_image(size=)`` against the JAX one (``cv2.INTER_AREA``): box
    means for integer factors (2x, 4x6) and overlap weights otherwise agree
    to float32 rounding, far inside 1/255; the image's own size is a
    no-op."""
    img = rng.integers(0, 256, size=(64, 96, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    TS.save_image(path, img)
    got = TS.load_image(path, size=size)
    want = JS.load_image(path, size=size)
    assert got.shape == size + (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_array_equal(TS.load_image(path), JS.load_image(path))


def test_find_image_and_jpeg(rng, tmp_path):
    """A capture's image is found under .png/.jpg/.JPG/.jpeg in that order,
    and a JPEG decodes as the JAX loader decodes it."""
    import imageio.v2 as imageio

    img = rng.integers(0, 256, size=(24, 24, 3)).astype(np.uint8)
    d = str(tmp_path)
    assert TS.find_image(d, "v") == os.path.join(d, "v.png")  # none exists
    for ext in (".jpeg", ".JPG", ".jpg"):
        imageio.imwrite(os.path.join(d, "v" + ext), img)
        assert TS.find_image(d, "v") == os.path.join(d, "v" + ext)
    got = TS.load_image(os.path.join(d, "v.jpg"))
    np.testing.assert_array_equal(got, JS.load_image(os.path.join(d, "v.jpg")))
    assert got.shape == (24, 24, 3)
    TS.save_image(os.path.join(d, "v.png"), img)
    assert TS.find_image(d, "v").endswith("v.png")
    imageio.imwrite(os.path.join(d, "g.jpg"), img[..., 0])  # greyscale
    assert TS.load_image(os.path.join(d, "g.jpg")).shape == (24, 24, 3)


# ---- metrics --------------------------------------------------------------

def test_evaluate_pair_dirs_matches_reference(rng, tmp_path):
    """PSNR within 1e-4 dB and SSIM within 1e-6 of the JAX function, per view
    and in the mean; an optional perceptual function is averaged too."""
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    for i in range(3):
        a = rng.uniform(size=(24, 32, 3)).astype(np.float32)
        b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1)
        TS.save_image(os.path.join(a_dir, f"{i}.png"), a)
        TS.save_image(os.path.join(b_dir, f"{i}.png"), b)
    want = JM.evaluate_pair_dirs(a_dir, b_dir)
    got = TM.evaluate_pair_dirs(a_dir, b_dir, device="cpu")
    assert sorted(got) == ["per_view", "psnr", "ssim"] == sorted(want)
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-4)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-6)
    assert list(got["per_view"]) == ["0.png", "1.png", "2.png"]
    for name, entry in got["per_view"].items():
        assert entry["psnr"] == pytest.approx(
            want["per_view"][name]["psnr"], abs=1e-4)
    l1 = TM.evaluate_pair_dirs(a_dir, b_dir, device="cpu",
                               perceptual_fn=lambda x, y: (x - y).abs().mean())
    assert 0.0 < l1["lpips"] < 0.2 and "lpips" in l1["per_view"]["0.png"]
    assert TM.evaluate_pair_dirs(str(tmp_path), b_dir, device="cpu") == {
        "psnr": None, "ssim": None, "per_view": {}}


def test_clip_similarities_match_reference(rng):
    f = [rng.normal(size=(4, 16)).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(TM.clip_similarity(f[0], f[1]),
                               JM.clip_similarity(f[0], f[1]), atol=1e-7)
    np.testing.assert_allclose(TM.clip_directional_similarity(*f),
                               JM.clip_directional_similarity(*f), atol=1e-7)


# ---- full_eval and the CLI ------------------------------------------------

def jax_full_eval():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_full_eval", os.path.join(ROOT, "tools", "full_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_eval_matches_reference_tool(tmp_path):
    """The port's tool on the CPU against the JAX tool, both with
    ``--no_lpips``, over a tiny synthetic capture: the same ``results.json``
    keys, PSNR within 0.01 dB and SSIM within 1e-4 on both render backends,
    lpips null."""
    ply, capture = write_synthetic_capture(str(tmp_path), n_views=3)
    common = ["--pairs", f"{ply}:{capture}", "--height", "32", "--width", "32"]
    jout = str(tmp_path / "jax")
    jax_full_eval().main(common + ["--out", jout, "--no_lpips"])
    with open(os.path.join(jout, "results.json")) as f:
        want = json.load(f)["capture"]
    for backend in (None, "torch_tiles"):
        out = str(tmp_path / f"port_{backend}")
        extra = ["--backend", backend] if backend else []
        res = TFE.main(common + ["--out", out, "--cpu", "--no_lpips"]
                       + extra)
        with open(os.path.join(out, "results.json")) as f:
            assert json.load(f) == res
        got = res["capture"]
        assert sorted(got) == sorted(want)
        assert got["psnr"] == pytest.approx(want["psnr"], abs=0.01)
        assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-4)
        assert got["psnr"] > 45.0  # the capture is this scene, quantised
        assert got["lpips"] is None and want["lpips"] is None
        for k in ("n_views", "n_gaussians", "spill"):
            assert got[k] == want[k], k
        assert got["n_views"] == 3 and got["spill"] == 0
        assert sorted(os.listdir(os.path.join(out, "capture", "renders"))) == \
            sorted(os.listdir(os.path.join(jout, "capture", "renders")))
    with pytest.raises(SystemExit):
        TFE.main(["--out", str(tmp_path / "none"), "--cpu"])


def test_cli_validate_test_export_on_cpu(tmp_path):
    """``--validate``, ``--test`` and ``--export`` write what the JAX CLI
    writes: ``eval/results.json`` with the renders, ``renders/NNNN.png``,
    orbit frames and ``scene.ply``; each returns its run."""
    ply, capture = write_synthetic_capture(str(tmp_path))
    size = ["data.height=32", "data.width=32"]
    base = ["--cpu", "--gs_source", ply, "--out", str(tmp_path / "out")]

    v = launch.main(["--validate", "--source", capture] + base + size)
    assert v.eval_dir == os.path.join(v.trial_dir, "eval")
    with open(os.path.join(v.eval_dir, "results.json")) as f:
        assert json.load(f) == v.results
    assert v.results["capture"]["psnr"] > 45.0
    assert v.results["capture"]["spill"] == 0
    assert sorted(os.listdir(os.path.join(v.eval_dir, "capture", "renders"))) \
        == ["view_00.png", "view_01.png"]
    with open(os.path.join(v.trial_dir, "cmd.txt")) as f:
        assert "--validate" in f.read()

    t = launch.main(["--test", "--source", capture, "--backend",
                     "torch_tiles"] + base + size)
    assert isinstance(t, launch.RenderRun) and t.spill == 0
    assert sorted(os.listdir(os.path.join(t.trial_dir, "renders"))) == \
        ["0000.png", "0001.png"]
    want = TS.load_image(os.path.join(capture, "images", "view_00.png"))
    np.testing.assert_array_equal(
        TS.load_image(os.path.join(t.trial_dir, "renders", "0000.png")), want)

    e = launch.main(["--export"] + base + size + ["export.frames=3"])
    assert len(e.frames) == 3 and e.frames[0].shape == (32, 32, 3)
    assert all(np.isfinite(f).all() and f.max() > 0.05 for f in e.frames)
    assert sorted(os.listdir(os.path.join(e.trial_dir, "orbit_frames"))) == \
        ["0000.png", "0001.png", "0002.png"]
    with open(ply, "rb") as a, open(e.scene_ply, "rb") as b:
        assert a.read() == b.read()
    assert e.scene_ply == os.path.join(e.trial_dir, "scene.ply")


def test_cli_takes_jpeg_capture_at_another_size(tmp_path):
    """A capture whose images are JPEGs at twice the run's size is found and
    area-resized by ``--validate`` and ``--fit`` (the JAX CLI's
    ``_find_ext`` and ``load_image(size=)``), not refused."""
    import imageio.v2 as imageio

    ply, capture = write_synthetic_capture(str(tmp_path), n_views=2)
    images = os.path.join(capture, "images")
    for name in sorted(os.listdir(images)):
        img = TS.load_image(os.path.join(images, name))
        big = np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)
        imageio.imwrite(os.path.join(images, name[:-4] + ".jpg"),
                        (big * 255 + 0.5).astype(np.uint8), quality=95)
        os.remove(os.path.join(images, name))
    base = ["--cpu", "--source", capture, "--out", str(tmp_path / "out"),
            "data.height=32", "data.width=32"]
    v = launch.main(["--validate", "--gs_source", ply] + base)
    assert v.results["capture"]["psnr"] > 30.0  # JPEG loss only
    src = TG.load_ply(ply, device="cpu")
    TCOL.write_points3d_binary(
        src.xyz[src.alive].numpy(),
        np.clip(TG.sh_to_rgb(src.features_dc[src.alive, 0].numpy()), 0, 1),
        os.path.join(capture, "sparse", "0", "points3D.bin"))
    f = launch.main(["--fit", "system.sh_degree=0", "trainer.max_steps=2"]
                    + base)
    assert f.losses_finite and f.steps == 2 and os.path.exists(f.ply_path)


def test_cli_names_its_modes(tmp_path, caplog):
    with pytest.raises(SystemExit):
        launch.main(["--out", str(tmp_path)])
    assert "--validate" in caplog.text and "--export" in caplog.text
    assert "--train" in caplog.text


# ---- checkpoint -----------------------------------------------------------

def test_checkpoint_round_trip_and_resume(rng, tmp_path):
    """Scene (SH degree 0: a zero-size ``features_rest``), Adam state, fit
    state, a generator's state and the meta file survive a round trip
    exactly, and a step taken from the restored state gives the same loss
    and parameters as the uninterrupted one."""
    ts = port_scene(make_random_scene(rng, n=40, capacity=64, max_sh_degree=0))
    assert ts.features_rest.shape == (64, 0, 3)
    cam, _ = make_test_camera(height=32, width=32)
    tcam = CameraArrays.from_camera(cam, "cpu")
    target = torch.from_numpy(rng.uniform(size=(32, 32, 3)).astype(np.float32))
    bg = torch.zeros(3)
    loop = TF.FitLoop(TO.OptimConfig.scaled(10), tile_px=16, max_per_tile=128)
    opt, fit = loop.init(ts)
    for _ in range(2):
        ts, opt, fit, _ = loop.train_step(ts, opt, fit, tcam, target, bg)
    gen = torch.Generator().manual_seed(7)
    torch.rand(3, generator=gen)
    path = TCK.save_checkpoint(str(tmp_path / "ckpts" / "step2"), ts, opt, fit,
                               extra={"step": 2, "note": "x"}, generator=gen)
    expect_noise = torch.rand(5, generator=gen)

    gen2 = torch.Generator()
    s2, o2, f2, meta = TCK.restore_checkpoint(path, device="cpu",
                                              generator=gen2)
    assert meta == {"max_sh_degree": 0, "step": 2, "note": "x"}
    assert torch.equal(torch.rand(5, generator=gen2), expect_noise)
    for k in ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation", "alive", "grad_mask", "generation"):
        a, b = getattr(s2, k), getattr(ts, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert (s2.active_sh_degree, s2.max_sh_degree) == (0, 0)
    assert s2.features_rest.shape == (64, 0, 3)
    for k, st in opt.items():
        assert o2[k]["count"] == st["count"] == 2
        assert torch.equal(o2[k]["mu"], st["mu"])
        assert torch.equal(o2[k]["nu"], st["nu"])
    assert f2.step == fit.step == 2
    for k in ("grad_accum", "denom", "max_radii2d"):
        assert torch.equal(getattr(f2, k), getattr(fit, k)), k

    a_scene, _, _, a_aux = loop.train_step(ts, opt, fit, tcam, target, bg)
    b_scene, _, _, b_aux = loop.train_step(s2, o2, f2, tcam, target, bg)
    assert float(a_aux["loss"]) == float(b_aux["loss"])
    assert torch.equal(a_scene.xyz, b_scene.xyz)
    with pytest.raises(RuntimeError, match="is_available\\(\\) is False"):
        TCK.restore_checkpoint(path)  # the device defaults to the card
