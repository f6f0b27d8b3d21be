"""The pair binning's CUDA kernels (``dge_tpu_torch/csrc/binning.cu``)
against the plain PyTorch binning ``_pair_sort`` run on the same card, bit
for bit in every ``PairBins`` field (marked ``gpu``; skips without a card);
on the CPU, the dispatch to ``_pair_sort`` and the sizes both paths take
(``pair_sizes``) against the tensors ``_pair_sort`` makes. This file
imports neither JAX nor the JAX package, so the card's machine runs it
without them:

    python -m pytest --noconftest -m gpu tests/test_torch_binning_kernel.py
"""

import math
import os

import numpy as np
import pytest
import torch

from dge_tpu_torch.ops import binning as TB
from dge_tpu_torch.ops import cuda_build as CB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PLY = os.path.join(ROOT, "outputs", "bench_scene", "point_cloud.ply")
FIELDS = ("pair_ids", "starts", "counts", "spill", "spill_parts", "length",
          "perm", "tier2_ids")
COUNTERS = ("binning_rects", "binning_emit", "binning_ranges")
# bin_gaussians_pairs' defaults, spelt out for _pair_sort
DEFAULTS = dict(tile_px=32, max_per_tile=2048, max_tiles_per_gaussian=32,
                small_slots=4)
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
        pytest.skip("needs a CUDA card: the binning kernels have no CPU mode")
    return torch.device("cuda")


def random_prep(seed, n, height, width, device="cpu", *, wide=1 / 6,
                visible=0.95):
    """Binning inputs of ``n`` random Gaussians over a ``height`` x
    ``width`` image (a ``wide`` share of them 20-45 px in radius), as
    (args, cull) tensors: args = (mean2d, depth, radius, visible), cull =
    dict(conic, opacity)."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform(-16, 1, size=(n, 2)) + rng.uniform(
        size=(n, 2)) * [width + 32, height + 32]
    radius = np.where(rng.uniform(size=n) < wide, rng.uniform(20, 45, n),
                      rng.uniform(1, 12, n))
    sigma2 = (radius / 3.0) ** 2
    a = rng.uniform(0.6, 1.0, n) / sigma2
    c = rng.uniform(0.6, 1.0, n) / sigma2
    b = rng.uniform(-0.3, 0.3, n) * np.sqrt(a * c)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    args = (t(mean2d), t(rng.uniform(1, 10, n)), t(radius),
            t(rng.uniform(size=n) < visible, torch.bool))
    return args, dict(conic=t(np.stack([a, b, c], 1)),
                      opacity=t(rng.uniform(0.02, 1.0, n)))


def torch_path(args, **kw):
    """``_pair_sort`` with ``bin_gaussians_pairs``' defaults resolved."""
    kw = dict(DEFAULTS, **kw)
    kw["max_pairs"] = kw.get("max_pairs") or TB.default_max_pairs(
        args[0].shape[0])
    kw["big_capacity"] = kw.get("big_capacity") or None
    return TB._pair_sort(*args, **kw)


def assert_same_bins(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    assert (got.tiles_x, got.tiles_y, got.emission) == (
        want.tiles_x, want.tiles_y, want.emission)


# ---- on the CPU --------------------------------------------------------


@pytest.mark.parametrize("cull", [False, True])
def test_cpu_tensors_take_the_torch_path(cull):
    """On CPU tensors bin_gaussians_pairs is _pair_sort, and no binning
    kernel is counted."""
    args, cull_kw = random_prep(3, 400, 96, 128)
    kw = dict(height=96, width=128, tile_px=16, max_per_tile=48,
              max_tiles_per_gaussian=8, max_pairs=900, big_capacity=16,
              small_slots=2, **(cull_kw if cull else {}))
    before = {k: CB.launch_counts[k] for k in COUNTERS}
    got = TB.bin_gaussians_pairs(*args, **kw)
    assert {k: CB.launch_counts[k] for k in COUNTERS} == before
    assert_same_bins(got, torch_path(args, **kw))
    assert int(got.spill) > 0


def needle_scene(seed, n, height, width):
    """``random_prep`` at radius 1-10 px (every rect within 2x2 tiles of
    32 px) with Gaussian 0 replaced by a needle: a rect over the whole
    image (radius 5000) and a footprint of a few pixels in its second tile
    (conic 1, opacity 0.5), so that under the cull it keeps that tile and
    spills its rect tiles past r, and no other Gaussian joins tier 2."""
    args, cull = random_prep(seed, n, height, width, wide=0.0)
    mean2d, depth, radius, visible = args
    mean2d[0] = torch.tensor([40.5, 20.5])
    radius.clamp_(max=10.0)[0] = 5000.0
    visible[0] = True
    cull["conic"][0] = torch.tensor([1.0, 0.0, 1.0])
    cull["opacity"][0] = 0.5
    return (mean2d, depth, radius, visible), cull


# the SpillFreeRenderer's start caps and later rungs of its ladder
# (render.grow_caps), small caps, and another image's depth keys
LADDER = {
    "start": dict(small_slots=4, max_tiles_per_gaussian=32),
    "rung1": dict(small_slots=8, max_tiles_per_gaussian=64,
                  big_capacity=8192, max_per_tile=8192),
    "rung2": dict(small_slots=16, max_tiles_per_gaussian=128,
                  big_capacity=16384, max_pairs=1 << 20),
    "ceiling": dict(small_slots=32, max_tiles_per_gaussian=256,
                    big_capacity=16),
    "depth_keys": dict(small_slots=4, max_tiles_per_gaussian=32,
                       depth_tiles=4096),
}


@pytest.mark.parametrize("case", sorted(LADDER))
def test_launch_scalars_match_pair_sort(case):
    """pair_sizes against what _pair_sort gives on the CPU: its emission,
    its tier-2 rows, the keys it sorts, the stream it keeps, and r: the
    needle's slot spill is its rect tiles past r; the keys' depth field is
    the widest that the tile ids, the sentinel included, leave in an
    int32."""
    kw = dict(LADDER[case])
    depth_tiles = kw.pop("depth_tiles", 0)
    h, w, n = 1080, 1920, 301
    args, cull = needle_scene(11, n, h, w)
    depth_keys = None
    if depth_tiles:
        seen = TB.tile_rects(args[0], args[2], args[3], 32, 60, 34)[4]
        depth_keys = (depth_tiles, seen)
    sc = TB.pair_sizes(
        n, height=h, width=w, tile_px=32,
        max_tiles_per_gaussian=kw["max_tiles_per_gaussian"],
        small_slots=kw["small_slots"],
        big_capacity=kw.get("big_capacity", 0),
        max_pairs=kw.get("max_pairs", 0), depth_keys=depth_keys)
    pb = torch_path(args, height=h, width=w, depth_keys=depth_keys, **cull,
                    **kw)
    assert sc.emission == pb.emission
    assert sc.rows == pb.tier2_ids.shape[0]
    assert sc.slots == pb.perm.shape[0]
    assert pb.pair_ids.shape[0] == min(sc.max_pairs, sc.slots)
    assert (sc.tiles_x, sc.tiles_y) == (pb.tiles_x, pb.tiles_y) == (60, 34)
    key_tiles = max(sc.num_tiles, depth_tiles)
    assert (key_tiles + 1) << sc.depth_bits <= 2 ** 31
    assert (key_tiles + 1) << (sc.depth_bits + 1) >= 2 ** 31
    assert int(pb.tier2_ids[0]) == 0  # the needle, tier 2's only member
    assert int((pb.tier2_ids < n).sum()) == 1
    assert sc.r == sc.num_tiles - int(pb.spill_parts[0])
    assert int(pb.spill_parts[0]) > 0


# ---- on the card -------------------------------------------------------


def bench_prep(dev, height, width):
    """The port's preprocess of the trained bench scene at one view."""
    from dge_tpu_torch.ops import projection as TP
    from dge_tpu_torch.scene import gaussians as TG
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.scene.cameras import look_at_camera

    scene = TG.load_ply(BENCH_PLY, device=dev)
    cam = CameraArrays.from_camera(look_at_camera(
        np.array([2.3, 0.9, -2.3]), np.array([0.0, -0.45, 0.0]),
        fovx=math.radians(60), height=height, width=width), device=dev)
    with torch.no_grad():
        prep = TP.preprocess(scene.xyz, scene.get_scaling, scene.get_rotation,
                             scene.get_opacity, scene.get_features,
                             scene.alive, cam, scene.active_sh_degree,
                             scene.max_sh_degree)
    return scene, cam, prep


def kernels_vs_torch(args, cull_kw, **kw):
    """Both paths on the card; each binning kernel counted once."""
    before = {k: CB.launch_counts[k] for k in COUNTERS}
    got = TB.bin_gaussians_pairs(*args, **cull_kw, **kw)
    assert {k: CB.launch_counts[k] - before[k] for k in COUNTERS} == \
        dict.fromkeys(COUNTERS, 1)
    want = torch_path(args, **cull_kw, **kw)
    torch.cuda.synchronize()
    assert_same_bins(got, want)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("size", ["512", "1080p"])
def test_bench_scene_kernels_equal_torch_path(card, size, cull):
    """The bench scene at 512^2 (bin_gaussians_pairs' defaults, which spill
    there) and at 1920x1080 (the ladder's start caps)."""
    h, w, caps = (512, 512, {}) if size == "512" else (1080, 1920,
                                                       START_1080P)
    _, _, prep = bench_prep(card, h, w)
    args = (prep.mean2d, prep.depth, prep.radius, prep.visible)
    cull_kw = dict(conic=prep.conic, opacity=prep.opacity) if cull else {}
    got = kernels_vs_torch(args, cull_kw, height=h, width=w, **caps)
    assert int(got.counts.sum()) > 100_000


# small caps where every spill class fires; tier 2 overflowing its
# capacity; the stream cut by max_pairs; another image's depth keys over a
# band; no Gaussian visible; fewer than 32 Gaussians
RANDOM_CASES = {
    "every_spill": dict(n=400, caps=dict(
        tile_px=16, max_per_tile=16, max_tiles_per_gaussian=8,
        max_pairs=300, big_capacity=16, small_slots=2)),
    "tier2_overflow": dict(n=400, caps=dict(tile_px=16, big_capacity=16)),
    "max_pairs": dict(n=400, caps=dict(tile_px=16, max_pairs=700)),
    "band": dict(n=400, band=(32, 48), caps=dict(tile_px=16)),
    "none_visible": dict(n=400, visible=0.0, caps=dict(tile_px=16)),
    "few": dict(n=20, caps=dict(tile_px=16, small_slots=2,
                                max_tiles_per_gaussian=4)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("case", sorted(RANDOM_CASES))
def test_random_scene_kernels_equal_torch_path(card, case, cull):
    spec = RANDOM_CASES[case]
    h, w = 96, 128
    args, cull_kw = random_prep(7, spec["n"], h, w, card,
                                visible=spec.get("visible", 0.95))
    caps = dict(spec["caps"])
    if "band" in spec:  # tile_shard.band_rasterize's depth keys
        y_off, band_px = spec["band"]
        tx, ty = -(-w // caps["tile_px"]), -(-h // caps["tile_px"])
        seen = TB.tile_rects(args[0], args[2], args[3], caps["tile_px"], tx,
                             ty)[4]
        shift = torch.tensor([0.0, float(y_off)], device=card)
        args = (args[0] - shift,) + args[1:]
        caps.update(depth_keys=(tx * ty, seen))
        h = band_px
    if not cull:
        cull_kw = {}
    got = kernels_vs_torch(args, cull_kw, height=h, width=w, **caps)
    if case == "every_spill":
        assert (got.spill_parts > 0).all()
    if case == "tier2_overflow":
        assert int(got.spill_parts[1]) > 0
    if case == "max_pairs":
        assert int(got.spill_parts[3]) > 0
    if case == "none_visible":
        assert int(got.counts.sum()) == 0
    if case == "few":
        assert int(got.counts.sum()) > 0


@pytest.mark.gpu
def test_kernel_args_are_checked(card):
    args, cull_kw = random_prep(1, 50, 64, 64, card)
    kw = dict(height=64, width=64, tile_px=16)
    with pytest.raises(ValueError, match="radius must be a contiguous"):
        TB.bin_gaussians_pairs(*args[:2], args[2].double(), args[3], **kw)
    with pytest.raises(ValueError, match="needs both conic and opacity"):
        TB.bin_gaussians_pairs(*args, conic=cull_kw["conic"], **kw)


@pytest.mark.gpu
def test_cuda_stream_frame_identical(card, monkeypatch):
    """One cuda_stream frame of the bench scene at 512^2 with the kernels'
    binning and with the torch path's: the same image."""
    from dge_tpu_torch.ops import render as TR

    scene, cam, _ = bench_prep(card, 512, 512)
    bg = torch.zeros(3, device=card)
    kw = dict(tile_px=32, max_per_tile=4096, tight_cull=True,
              backend="cuda_stream")
    with torch.no_grad():
        got = TR.render(scene, cam, bg, **kw)
        monkeypatch.setattr(TB, "bin_gaussians_pairs",
                            lambda *a, **k: torch_path(a, **k))
        want = TR.render(scene, cam, bg, **kw)
    for f in ("color", "depth", "spill"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
