"""``SpillFreeRenderer.__call__`` as a CUDA graph replay
(``ops/render._FrameGraph``): on the card (marked ``gpu``; skips without
one) the replayed frames against the eager path's under ``torch.equal``,
through a ladder rung, an update in place, a reallocated scene tensor and
``launch_counts``; on the CPU, that a CPU scene never captures, the graph
key as a function of its inputs, and ``tracing.is_recording``. This file
imports neither JAX nor the JAX package, so the card's machine runs it
without them:

    python -m pytest --noconftest -m gpu tests/test_torch_render_graph.py
"""

import math
import os

import numpy as np
import pytest
import torch

from dge_tpu_torch.ops import cuda_build as CB
from dge_tpu_torch.ops import render as R
from dge_tpu_torch.scene import gaussians as G
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.scene.cameras import look_at_camera
from dge_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PLY = os.path.join(ROOT, "outputs", "bench_scene", "point_cloud.ply")
# where the pair-stream ladder starts on the bench scene at 1920x1080
START_1080P = dict(max_per_tile=2048, max_tiles_per_gaussian=64,
                   small_slots=16, max_pairs=3 << 18, big_capacity=16384)
SIZES = {"512": (512, 512, {}), "1080p": (1080, 1920, START_1080P)}


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def orbit_camera(i, frames, height, width, device):
    """Pose ``i`` of ``frames`` on an orbit around the bench scene."""
    ang = 2 * math.pi * i / frames
    eye = (3.3 * math.sin(ang), 0.35 + 0.55 * (0.5 + 0.5 * math.sin(
        3 * ang)), -3.3 * math.cos(ang))
    return CameraArrays.from_camera(look_at_camera(
        np.array(eye), np.array([0.0, -0.45, 0.0]), fovx=math.radians(60),
        height=height, width=width), device=device)


def small_scene(seed=0, n=300, device="cpu"):
    rng = np.random.default_rng(seed)
    return G.from_arrays(
        (rng.normal(size=(n, 3)) * 0.4).astype(np.float32),
        rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.5,
        rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.05,
        rng.uniform(-1, 2, size=(n, 1)).astype(np.float32),
        rng.uniform(-3.5, -2.5, size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32), max_sh_degree=1,
        capacity=512, device=device)


def deltas(before: dict, group: str) -> dict:
    now = tracing.counters()[group]
    return {k: v - before.get(k, 0) for k, v in now.items()}


# ---- CPU --------------------------------------------------------------

def test_cpu_scene_never_captures():
    """A CPU scene renders eagerly on every ``__call__``: no capture, no
    replay, each frame counted ``eager``."""
    scene = small_scene()
    r = R.SpillFreeRenderer(scene, torch.ones(3), tile_px=16)
    before = tracing.counters()["render_graph"]
    for i in range(2):
        cam = orbit_camera(i, 8, 32, 32, "cpu")
        color, sp = r(cam)
        assert sp == 0
        assert torch.equal(color, r.render(cam).color)
    d = deltas(before, "render_graph")
    assert d["captures"] == 0 and d["replays"] == 0
    assert d["eager"] == 2
    assert r._graph is None


def key_inputs():
    scene = small_scene(1)
    caps = R.SpillFreeRenderer(scene).caps
    kw = dict(backend="cuda_stream", tile_px=32)
    return scene, torch.zeros(3), 1080, 1920, caps, kw


def reallocated(scene, name):
    """``scene`` with tensor ``name`` moved to new storage (the old one kept
    alive, so its address cannot come back)."""
    old = getattr(scene, name)
    new = scene.replace(**{name: old.clone()})
    return new, old


@pytest.mark.parametrize("change", [
    "caps", "tight_cull", "height", "width", "tile_px", "chunk",
    "scale_modifier", "active_sh_degree", "bg", "xyz", "opacity",
    "features_rest", "alive"])
def test_frame_key_changes_with_what_the_frame_depends_on(change):
    scene, bg, h, w, caps, kw = key_inputs()
    base = R.frame_key(scene, bg, h, w, caps, kw)
    keep = []
    if change == "caps":
        caps = R.grow_caps(caps, [0, 0, 1, 0])
    elif change in ("tight_cull", "chunk", "scale_modifier"):
        kw = dict(kw, **{change: {"tight_cull": True, "chunk": 128,
                                  "scale_modifier": 0.5}[change]})
    elif change == "tile_px":
        kw = dict(kw, tile_px=16)
    elif change == "height":
        h = 512
    elif change == "width":
        w = 512
    elif change == "active_sh_degree":
        scene = scene.replace(active_sh_degree=0)
    elif change == "bg":
        keep.append(bg)
        bg = bg.clone()
    else:
        scene, old = reallocated(scene, change)
        keep.append(old)
    assert R.frame_key(scene, bg, h, w, caps, kw) != base


def test_frame_key_keeps_in_place_updates():
    """Adam's in-place steps and a value written into ``bg`` keep the key:
    the replay reads the same storage and sees them."""
    scene, bg, h, w, caps, kw = key_inputs()
    base = R.frame_key(scene, bg, h, w, caps, kw)
    with torch.no_grad():
        for name in R.SCENE_READS[:-1]:
            getattr(scene, name).add_(0.25)
        scene.alive[:7] = False
        bg.fill_(1.0)
    assert R.frame_key(scene, bg, h, w, caps, dict(kw)) == base
    assert R.frame_key(scene, bg, h, w, dict(caps), kw) == base


def test_is_recording_follows_recording():
    assert not tracing.is_recording()
    with tracing.recording():
        assert tracing.is_recording()
        with tracing.recording():
            assert tracing.is_recording()
        assert tracing.is_recording()
    assert not tracing.is_recording()
    tracing.take()


# ---- the card ---------------------------------------------------------

def bench_renderer(dev, size, **caps):
    h, w, start = SIZES[size]
    scene = G.load_ply(BENCH_PLY, device=dev)
    r = R.SpillFreeRenderer(scene, torch.ones(3, device=dev), tile_px=32,
                            **dict(start, **caps))
    return r, h, w


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["512", "1080p"])
def test_replayed_frames_equal_eager_frames(card, size):
    """16 orbit poses, their caps probed first: each replayed frame
    ``torch.equal`` to the eager render at the same caps; one capture, then
    a replay a frame."""
    r, h, w = bench_renderer(card, size)
    cams = [orbit_camera(i, 16, h, w, card) for i in range(16)]
    assert all(r.probe(cam) == 0 for cam in cams)
    before = tracing.counters()["render_graph"]
    for cam in cams:
        color, sp = r(cam)
        assert sp == 0
        assert torch.equal(color, r.render(cam).color)
    d = deltas(before, "render_graph")
    assert d["replays"] == 16 and d["eager"] == 0
    assert d["captures"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["512", "1080p"])
def test_ladder_rung_recaptures(card, size):
    """A cap small enough to spill: ``__call__`` climbs the ladder,
    capturing again at each new key, and the frame it returns equals the
    eager render at the final caps."""
    r, h, w = bench_renderer(card, size, max_per_tile=128)
    cam = orbit_camera(3, 16, h, w, card)
    before = tracing.counters()["render_graph"]
    ladder = dict(tracing.counters()["render_ladder"])
    color, sp = r(cam, regrow=12)
    assert sp == 0
    rungs = sum(deltas(ladder, "render_ladder").values())
    d = deltas(before, "render_graph")
    assert rungs >= 2 and d["captures"] == rungs + 1
    assert torch.equal(color, r.render(cam).color)
    again, _ = r(cam)
    assert torch.equal(again, color)
    assert deltas(before, "render_graph")["captures"] == rungs + 1


@pytest.mark.gpu
def test_in_place_update_shows_in_the_next_replay(card):
    r, h, w = bench_renderer(card, "512")
    cam = orbit_camera(5, 16, h, w, card)
    assert r.probe(cam) == 0
    first, _ = r(cam)
    before = tracing.counters()["render_graph"]
    with torch.no_grad():
        r._scene.opacity.add_(-1.5)
    dimmer, sp = r(cam)
    assert sp == 0
    assert deltas(before, "render_graph")["captures"] == 0
    assert not torch.equal(dimmer, first)
    assert torch.equal(dimmer, r.render(cam).color)


@pytest.mark.gpu
def test_reallocated_scene_tensor_recaptures(card):
    r, h, w = bench_renderer(card, "512")
    cam = orbit_camera(7, 16, h, w, card)
    assert r.probe(cam) == 0
    r(cam)
    before = tracing.counters()["render_graph"]
    old = r._scene.opacity  # kept alive: the new storage lies elsewhere
    r._scene.opacity = old.clone() - 0.5
    color, _ = r(cam)
    assert deltas(before, "render_graph")["captures"] == 1
    assert torch.equal(color, r.render(cam).color)
    del old


@pytest.mark.gpu
def test_returned_colours_do_not_alias(card):
    r, h, w = bench_renderer(card, "512")
    cams = [orbit_camera(i, 16, h, w, card) for i in (0, 8)]
    assert r.probe(cams[0]) == 0
    a, _ = r(cams[0])
    kept = a.clone()
    b, _ = r(cams[1])
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept) and not torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["512", "1080p"])
def test_launch_counts_under_replay(card, size):
    """N replays count N times an eager frame's launches, kernel by
    kernel; the capture itself counts none."""
    r, h, w = bench_renderer(card, size)
    cam = orbit_camera(2, 16, h, w, card)
    assert r.probe(cam) == 0
    before = dict(CB.launch_counts)
    r.render(cam)
    one = {k: CB.launch_counts[k] - before[k] for k in before}
    assert one["preprocess"] == 1 and one["pairs_composite"] == 1
    r(cam)  # the capture: its eager warm-up frame and one replay
    before = dict(CB.launch_counts)
    for _ in range(5):
        r(cam)
    assert {k: CB.launch_counts[k] - before[k] for k in before} == {
        k: 5 * n for k, n in one.items()}


@pytest.mark.gpu
def test_recording_and_autograd_run_eagerly(card):
    """Under ``recording()`` (spans are Python) and with a scene tensor
    requiring a gradient in grad mode, ``__call__`` runs eagerly."""
    r, h, w = bench_renderer(card, "512")
    cam = orbit_camera(1, 16, h, w, card)
    assert r.probe(cam) == 0
    before = tracing.counters()["render_graph"]
    with tracing.recording():
        color, _ = r(cam)
    spans = tracing.take()["spans"]
    assert any(s["name"] == "render.binning" for s in spans)
    r._scene.xyz.requires_grad_(True)
    try:
        r(cam)
    finally:
        r._scene.xyz.requires_grad_(False)
    d = deltas(before, "render_graph")
    assert d["eager"] == 2 and d["replays"] == 0
    assert torch.equal(color, r(cam)[0])
