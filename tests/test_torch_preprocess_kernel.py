"""The preprocess kernel (``dge_tpu_torch/csrc/preprocess.cu``) against the
torch path (``projection._preprocess_torch``) run on the same card:
``mean2d``, ``depth``, ``conic``, ``radius`` and ``visible`` bit for bit,
``rgb`` within 1e-6, and the binning and the frame downstream of each
(marked ``gpu``; skips without a card). On the CPU: the dispatch (CPU
tensors and autograd take the torch path), the
``launch_counts["preprocess"]`` counter, and the wrapper's argument checks,
which raise before any launch. This file imports neither JAX nor the JAX
package, so the card's machine runs it without them:

    python -m pytest --noconftest -m gpu tests/test_torch_preprocess_kernel.py
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from dge_tpu_torch.ops import binning as TB
from dge_tpu_torch.ops import cuda_build as CB
from dge_tpu_torch.ops import projection as TP
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.scene.cameras import look_at_camera

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PLY = os.path.join(ROOT, "outputs", "bench_scene", "point_cloud.ply")
EXACT = ("mean2d", "depth", "conic", "radius", "visible")
RGB_TOL = 1e-6
BIN_FIELDS = ("pair_ids", "starts", "counts", "spill", "spill_parts",
              "length", "perm", "tier2_ids")
# where the pair-stream ladder starts on the bench scene at 1920x1080
START_1080P = dict(max_per_tile=2048, max_tiles_per_gaussian=64,
                   small_slots=16, max_pairs=3 << 18, big_capacity=16384)


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the preprocess kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def camera(height, width, device, eye=(2.3, 0.9, -2.3)):
    return CameraArrays.from_camera(look_at_camera(
        np.array(eye), np.array([0.0, -0.45, 0.0]), fovx=math.radians(60),
        height=height, width=width), device=device)


def random_inputs(seed, n, device, *, max_deg=3, active=None):
    """``preprocess``' positional inputs for ``n`` random Gaussians, as the
    scene's activation getters give them, with every case of the cull in
    it: a share of dead slots (``alive`` false, log-scale -20), of points
    behind the near plane and off screen, and of needles (one axis 1e4
    times the others) whose EWA determinant rounds to <= 0."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * 1.2
    log_scale = rng.uniform(-4.5, -2.0, size=(n, 3))
    kind = rng.choice(5, size=n, p=[0.6, 0.1, 0.1, 0.1, 0.1])
    eye = np.array([2.3, 0.9, -2.3])
    fwd = -eye / np.linalg.norm(eye)
    # behind the camera, or within 0.2 of it along its axis
    xyz[kind == 1] = eye + fwd * rng.uniform(-2.0, 0.15, size=(
        int((kind == 1).sum()), 1)) + rng.normal(size=(
            int((kind == 1).sum()), 3)) * 0.3
    xyz[kind == 2] *= 12.0  # far off screen
    log_scale[kind == 3] = -20.0
    needles = kind == 4
    log_scale[needles, 0] = rng.uniform(4.0, 6.0, size=int(needles.sum()))
    log_scale[needles, 1:] = -6.0
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    k = (max_deg + 1) ** 2
    sh = rng.normal(size=(n, k, 3)) * 0.3
    sh[:, 0] = rng.normal(size=(n, 3))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    alive = torch.as_tensor(kind != 3, device=device)
    return (f32(xyz), torch.exp(f32(log_scale)), f32(quat),
            torch.sigmoid(f32(rng.normal(size=(n, 1)))), f32(sh), alive,
            camera(96, 128, device),
            max_deg if active is None else active, max_deg)


# ---- on the CPU --------------------------------------------------------


def test_cpu_tensors_take_the_torch_path():
    """On CPU tensors preprocess is the torch path: no kernel launch
    counted, the torch path's result."""
    args = random_inputs(0, 200, "cpu")
    before = CB.launch_counts["preprocess"]
    got = TP.preprocess(*args)
    assert CB.launch_counts["preprocess"] == before
    want = TP._preprocess_torch(*args)
    for f in TP.Preprocessed._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("grad_mode", [True, False])
@pytest.mark.parametrize("which", ["none", "xyz", "sh", "opacity",
                                   "override_color", "cam.w2c"])
def test_needs_graph(grad_mode, which):
    """Autograd needs a graph only in grad mode and only where some input
    requires a gradient; a non-tensor input (a Python number) needs none."""
    args = {k: torch.zeros(3) for k in ("xyz", "sh", "opacity",
                                        "override_color", "cam.w2c")}
    if which != "none":
        args[which].requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        got = TP.needs_graph(*args.values(), 1.0, None)
    assert got == (grad_mode and which != "none")


def test_autograd_takes_the_torch_path_and_gradients_reach_every_input():
    """Inputs that require a gradient, in grad mode: the torch path, and
    every input gets a gradient; with an override colour, that colour
    does."""
    args = list(random_inputs(1, 120, "cpu"))
    leaves = [a.clone().requires_grad_(True) for a in args[:5]]
    before = CB.launch_counts["preprocess"]
    out = TP.preprocess(*leaves, *args[5:])
    assert CB.launch_counts["preprocess"] == before
    vis = out.visible.float()[:, None]
    loss = ((out.mean2d * vis).sum() + (out.depth * out.visible).sum()
            + (out.conic * vis).sum() + out.rgb.sum() + out.opacity.sum())
    loss.backward()
    for name, leaf in zip(("xyz", "scale", "quat", "opacity", "sh"), leaves):
        assert leaf.grad is not None and float(leaf.grad.abs().sum()) > 0, \
            name
    colour = torch.rand(120, 3, requires_grad=True)
    TP.preprocess(*args[:7], 3, 3, override_color=colour).rgb.sum().backward()
    assert torch.equal(colour.grad, torch.ones(120, 3))


BAD_ARGS = {
    "xyz f64": (lambda a: a.update(xyz=a["xyz"].double()),
                "xyz must be a contiguous torch.float32"),
    "quat shape": (lambda a: a.update(quat=a["quat"][:, :3]),
                   r"quat must be a contiguous .* shape \(50, 4\)"),
    "scale strided": (lambda a: a.update(
        scale=a["scale"].t().contiguous().t()), "scale must be a contiguous"),
    "alive uint8": (lambda a: a.update(alive=a["alive"].to(torch.uint8)),
                    "alive must be a contiguous torch.bool"),
    "sh degree 4": (lambda a: a.update(max_deg=4), "SH degree 4"),
    "sh too short": (lambda a: a.update(sh=a["sh"][:, :9].contiguous()),
                     r"sh must be \[50, >= 16, 3\]"),
    "tan a float": (lambda a: a.update(cam=dataclasses.replace(
        a["cam"], tan_half_fovx=0.5)), r"cam.tan_half_fovx must be a "
        r"contiguous torch.float32 tensor of shape \(\) on cpu, got float"),
    "on the CPU": (lambda a: None, "the kernel runs on a CUDA device"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_kernel_wrapper_checks_before_any_launch(case, monkeypatch):
    """``_preprocess_kernel`` raises on what the kernel does not take
    before it loads the library (so before any launch); on CPU tensors
    that are otherwise right, for the device."""
    xyz, scale, quat, opacity, sh, alive, cam, active, max_deg = \
        random_inputs(2, 50, "cpu")
    a = dict(xyz=xyz, scale=scale, quat=quat, sh=sh, alive=alive, cam=cam,
             max_deg=max_deg)
    edit, match = BAD_ARGS[case]
    edit(a)

    def no_launch():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(CB, "load", no_launch)
    before = CB.launch_counts["preprocess"]
    with pytest.raises(ValueError, match=match):
        TP._preprocess_kernel(a["xyz"], a["scale"], a["quat"], opacity,
                              a["sh"], a["alive"], a["cam"], active,
                              a["max_deg"])
    assert CB.launch_counts["preprocess"] == before


# ---- on the card -------------------------------------------------------


def both_paths(args, **kw):
    """The kernel path through ``preprocess`` (one call, one launch), then
    the torch path on the same inputs."""
    before = CB.launch_counts["preprocess"]
    with torch.no_grad():
        got = TP.preprocess(*args, **kw)
    assert CB.launch_counts["preprocess"] == before + 1
    want = TP._preprocess_torch(*args, **kw)
    torch.cuda.synchronize()
    return got, want


def assert_same_prep(got, want):
    for f in EXACT:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.is_floating_point():
            assert bool(torch.isfinite(b).all()), f
        assert torch.equal(a, b), f
    assert got.rgb.shape == want.rgb.shape
    assert float((got.rgb - want.rgb).abs().max()) <= RGB_TOL
    assert torch.equal(got.opacity, want.opacity)


# SH degree and active degree; colour override; scale modifier
CARD_CASES = {
    "deg3": dict(max_deg=3),
    "deg3_active1": dict(max_deg=3, active=1),
    "deg2": dict(max_deg=2),
    "deg2_active0": dict(max_deg=2, active=0),
    "deg1": dict(max_deg=1),
    "deg0": dict(max_deg=0),
    "override": dict(max_deg=3, override=True),
    "scale_modifier": dict(max_deg=3, scale_modifier=0.7),
}


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["512", "1080p"])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_random_inputs_kernel_equals_torch_path(card, case, size):
    spec = dict(CARD_CASES[case])
    args = list(random_inputs(3, 4000, card, max_deg=spec["max_deg"],
                              active=spec.get("active")))
    args[6] = camera(512, 512, card) if size == "512" else camera(
        1080, 1920, card)
    kw = {}
    if spec.get("override"):
        kw["override_color"] = torch.rand(4000, 3, device=card)
    if "scale_modifier" in spec:
        kw["scale_modifier"] = spec["scale_modifier"]
    got, want = both_paths(args, **kw)
    assert_same_prep(got, want)
    if kw.get("override_color") is not None:
        assert torch.equal(got.rgb, kw["override_color"])
    # the cull's cases all occur: dead, behind the near plane, off screen,
    # determinant <= 0 (conic 0) among the live points in front
    alive, in_front = args[5], want.depth > TP.NEAR_Z
    in_x = (want.mean2d[:, 0] >= 0) & (want.mean2d[:, 0] < args[6].width)
    degenerate = (want.conic == 0).all(dim=1) & alive & in_front
    assert int((~alive).sum()) > 0 and int((~in_front).sum()) > 0
    assert int((alive & in_front & ~in_x).sum()) > 0
    assert int(degenerate.sum()) > 0
    assert 0 < int(want.visible.sum()) < 4000


def bench_scene(dev):
    from dge_tpu_torch.scene import gaussians as TG

    return TG.load_ply(BENCH_PLY, device=dev)


def scene_args(scene, cam):
    return (scene.xyz, scene.get_scaling, scene.get_rotation,
            scene.get_opacity, scene.get_features, scene.alive, cam,
            scene.active_sh_degree, scene.max_sh_degree)


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["512", "1080p"])
def test_bench_scene_orbit_kernel_equals_torch_path(card, size):
    """The bench scene from eight poses of an orbit around it."""
    scene = bench_scene(card)
    h, w = (512, 512) if size == "512" else (1080, 1920)
    for i in range(8):
        ang = 2 * math.pi * i / 8
        eye = (3.3 * math.sin(ang), 0.35 + 0.55 * (0.5 + 0.5 * math.sin(
            3 * ang)), -3.3 * math.cos(ang))
        got, want = both_paths(scene_args(scene, camera(h, w, card, eye)))
        assert_same_prep(got, want)
        assert int(want.visible.sum()) > 100_000


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["512", "1080p"])
def test_binning_and_frame_downstream_are_identical(card, size):
    """The pair binning of each path's output at the caps a spill-free
    renderer probes: every ``PairBins`` field equal; the cuda_stream frames
    within 1e-6, the bound rgb sets."""
    from dge_tpu_torch.ops import render as TR

    h, w, start = (512, 512, {}) if size == "512" else (1080, 1920,
                                                         START_1080P)
    scene, bg = bench_scene(card), torch.zeros(3, device=card)
    cam = camera(h, w, card)
    ladder = TR.SpillFreeRenderer(scene, bg, tile_px=32, **start)
    assert ladder.probe(cam) == 0
    caps, cull = ladder.caps, ladder.tight_cull
    got, want = both_paths(scene_args(scene, cam))
    bins = []
    for prep in (got, want):
        bins.append(TB.bin_gaussians_pairs(
            prep.mean2d, prep.depth, prep.radius, prep.visible, height=h,
            width=w, tile_px=32, conic=prep.conic if cull else None,
            opacity=prep.opacity if cull else None, **caps))
    for f in BIN_FIELDS:
        assert torch.equal(getattr(bins[0], f), getattr(bins[1], f)), f
    assert int(bins[0].spill) == 0
    frames = [TR.rasterize(prep, prep.mean2d, h, w, bg, backend="cuda_stream",
                           tile_px=32, tight_cull=cull, **caps)
              for prep in (got, want)]
    for a, b in zip(frames[0][:3], frames[1][:3]):
        assert float((a - b).abs().max()) <= RGB_TOL


@pytest.mark.gpu
def test_autograd_on_the_card_takes_the_torch_path(card):
    """Card inputs that require a gradient, in grad mode: the torch path,
    no launch; the same inputs under no_grad: the kernel."""
    args = list(random_inputs(4, 500, card))
    args[0] = args[0].clone().requires_grad_(True)
    before = CB.launch_counts["preprocess"]
    out = TP.preprocess(*args)
    assert out.mean2d.requires_grad
    assert CB.launch_counts["preprocess"] == before
    with torch.no_grad():
        TP.preprocess(*args)
    assert CB.launch_counts["preprocess"] == before + 1
    with pytest.raises(ValueError, match="scale must be a contiguous"):
        with torch.no_grad():
            TP.preprocess(args[0], args[1].double(), *args[2:])
    assert CB.launch_counts["preprocess"] == before + 1
