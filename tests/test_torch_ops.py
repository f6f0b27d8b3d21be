"""Ops of the PyTorch port against the JAX package: SH + preprocess, pair
binning, stream assembly, the pair-stream compositor (plain version against
the Pallas kernel in interpret mode, the block-boundary fixture), the cap
ladder and PSNR. The kernel's own tests are in test_torch_kernel.py.

Tolerances: colour 1e-4, depth 1e-3, alpha 2e-4, as the JAX package holds
its own kernels (tests/test_pallas.py); the differences are f32 rounding of
the same arithmetic in another order (XLA's fusion, the Hillis-Steele
cumprod against torch.cumprod)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.ops import binning as JB
from dge_tpu.ops import losses as JL
from dge_tpu.ops import pallas_composite as JPC
from dge_tpu.ops import projection as JP
from dge_tpu.ops import render as JR
from dge_tpu.scene import gaussians as JG
from dge_tpu.scene import look_at_camera as j_look_at
from dge_tpu.scene.camera_arrays import CameraArrays as JCameraArrays
from dge_tpu_torch.ops import binning as TB
from dge_tpu_torch.ops import losses as TL
from dge_tpu_torch.ops import naive as TN
from dge_tpu_torch.ops import pairs_composite as TPC
from dge_tpu_torch.ops import projection as TP
from dge_tpu_torch.ops import render as TR
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_kernel import random_stream
from tests.test_torch_scene import BENCH_PLY, to_port

PREP_FIELDS = ("mean2d", "depth", "conic", "radius", "rgb", "opacity")


def j_preprocess(js, jcam):
    return JP.preprocess(js.xyz, js.get_scaling, js.get_rotation,
                         js.get_opacity, js.get_features, js.alive, jcam,
                         js.active_sh_degree, js.max_sh_degree)


def t_preprocess(ts, tcam):
    return TP.preprocess(ts.xyz, ts.get_scaling, ts.get_rotation,
                         ts.get_opacity, ts.get_features, ts.alive, tcam,
                         ts.active_sh_degree, ts.max_sh_degree)


def shared_prep(js, jcam):
    """JAX preprocess outputs as numpy, the inputs both binnings share."""
    prep = jax.jit(j_preprocess)(js, jcam)
    return {k: np.asarray(getattr(prep, k)) for k in prep._fields}


def bin_both(prep, cull, **kw):
    names = ("mean2d", "depth", "radius", "visible")
    cull_names = ("conic", "opacity")
    jkw = {k: jnp.asarray(prep[k]) for k in cull_names} if cull else {}
    tkw = {k: torch.from_numpy(prep[k].copy()) for k in cull_names} if cull \
        else {}
    jb = jax.jit(lambda *a, **c: JB.bin_gaussians_pairs(*a, **c, **kw))(
        *(jnp.asarray(prep[k]) for k in names), **jkw)
    tb = TB.bin_gaussians_pairs(*(torch.from_numpy(prep[k].copy())
                                  for k in names), **tkw, **kw)
    return jb, tb


def assert_bins_identical(jb, tb):
    for k in ("pair_ids", "starts", "counts", "spill", "spill_parts"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)


@pytest.mark.parametrize("degree,angle", [(0, 0.0), (3, 1.3)])
def test_preprocess_matches_reference(rng, degree, angle):
    js = make_random_scene(rng, n=300, max_sh_degree=degree)
    cam, jcam = make_test_camera(height=96, width=128, angle=angle)
    prep = j_preprocess(js, jcam)
    out = t_preprocess(to_port(js), CameraArrays.from_camera(cam, "cpu"))
    vis = np.asarray(prep.visible)
    np.testing.assert_array_equal(out.visible.numpy(), vis)
    assert vis.sum() > 100
    for k in PREP_FIELDS:
        ref = np.asarray(getattr(prep, k))[vis]
        # 1e-5 relative to the quantity's own scale (conic b and mean2d can
        # sit near 0, where a pointwise relative error means nothing)
        np.testing.assert_allclose(getattr(out, k).numpy()[vis], ref,
                                   rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=k)


@pytest.mark.parametrize("cull", [False, True])
def test_bin_gaussians_pairs_identical_random_scene(rng, cull):
    js = make_random_scene(rng, n=400, scale_rng=(-3.5, -1.0))
    _, jcam = make_test_camera(height=96, width=96, angle=0.7)
    prep = shared_prep(js, jcam)
    # small caps so every spill class is exercised and attributed
    jb, tb = bin_both(prep, cull, height=96, width=96, tile_px=16,
                      max_per_tile=48, max_tiles_per_gaussian=8,
                      max_pairs=900, big_capacity=16, small_slots=2)
    assert_bins_identical(jb, tb)
    assert int(tb.spill) > 0


@pytest.fixture(scope="module", params=["bench_scene", "bench_scene_hi"])
def bench_prep(request):
    js = JG.load_ply(BENCH_PLY.replace("bench_scene", request.param))
    cam = j_look_at(np.array([2.3, 0.9, -2.3]), np.array([0.0, -0.45, 0.0]),
                    fovx=math.radians(60), height=512, width=512)
    return shared_prep(js, JCameraArrays.from_camera(cam))


@pytest.mark.parametrize("cull", [False, True])
def test_bin_gaussians_pairs_identical_bench_scene(bench_prep, cull):
    """The trained bench scene and the hi-aniso (needle) scene at 512^2 and
    tile 32, at the SpillFreeRenderer's start caps (which spill on the bench
    scene). Culling's keep test uses log and divisions; on these scenes no
    pair flips between XLA and torch, so the streams are identical."""
    jb, tb = bin_both(bench_prep, cull, height=512, width=512, tile_px=32,
                      max_per_tile=4096)
    assert_bins_identical(jb, tb)
    assert int(tb.counts.sum()) > 200_000


def test_assemble_stream_data_matches_reference(rng):
    n, pc = 50, 300
    m, c, r = (rng.normal(size=(n, k)).astype(np.float32) for k in (2, 3, 3))
    d, o = (rng.uniform(size=n).astype(np.float32) for _ in range(2))
    ids = rng.integers(0, n, size=pc).astype(np.int32)
    ref = JPC.assemble_stream_data(*(jnp.asarray(x) for x in (ids, m, c, r, d, o)))
    out = TPC.assemble_stream_data(*(torch.from_numpy(x) for x in (ids, m, c, r, d, o)))
    assert out.shape == (TPC.FEAT, pc)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref)[:TPC.FEAT])
    assert not np.asarray(ref)[TPC.FEAT:].any()  # JAX's pad rows are zeros


@pytest.mark.parametrize("chunk", [128, 256])
def test_composite_reference_matches_pallas(rng, chunk):
    tile_px, num_tiles = 16, 6
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(
        rng, num_tiles, tile_px, tail=chunk + 5)
    tiles_y = num_tiles // tiles_x
    h, w = tiles_y * tile_px, tiles_x * tile_px
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    ref = JPC.composite_pairs_pallas(
        *(jnp.asarray(x) for x in (ids, starts, counts, m, c, r, d, o)),
        height=h, width=w, tiles_x=tiles_x, tiles_y=tiles_y, tile_px=tile_px,
        bg=jnp.asarray(bg), max_per_tile=512, chunk=chunk)
    out = TPC.composite_pairs(
        *(torch.from_numpy(x) for x in (ids, starts, counts, m, c, r, d, o)),
        height=h, width=w, tiles_x=tiles_x, tiles_y=tiles_y, tile_px=tile_px,
        bg=torch.from_numpy(bg), chunk=chunk, use_kernel=False)
    for got, want, tol in zip(out, ref, (1e-4, 1e-3, 2e-4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    final_t = out[2].numpy()
    assert final_t.min() < 0.01 and final_t.max() == 1.0  # opaque + empty


def boundary_stream(total):
    """The block-boundary fixture: one 16x16 tile, constant alpha per pair
    (conic 0), alpha 0.99, 0.5, 0.99 in slots 0-2, transparent slots 3-127,
    alpha 0.5 in slot 128; red 1 everywhere; the stream holds ``total``
    pairs (the tile's range is the first 129)."""
    op = np.zeros(total, np.float32)
    op[[0, 1, 2, 128]] = [0.99, 0.5, 0.99, 0.5]
    rgb = np.zeros((total, 3), np.float32)
    rgb[:, 0] = 1.0
    return dict(
        ids=np.arange(total, dtype=np.int32), starts=np.array([0], np.int32),
        counts=np.array([129], np.int32),
        mean2d=np.full((total, 2), 8.0, np.float32),
        conic=np.zeros((total, 3), np.float32), rgb=rgb,
        depth=np.ones(total, np.float32), opac=op)


def run_boundary(f, port, chunk=128, max_per_tile=2048):
    args = (f["ids"], f["starts"], f["counts"], f["mean2d"], f["conic"],
            f["rgb"], f["depth"], f["opac"])
    kw = dict(height=16, width=16, tiles_x=1, tiles_y=1, tile_px=16,
              chunk=chunk)
    if port:
        out = TPC.composite_pairs(*(torch.from_numpy(x) for x in args),
                                  bg=torch.zeros(3), use_kernel=False, **kw)
        return out[0].numpy()[..., 0], out[2].numpy()
    out = JPC.composite_pairs_pallas(*(jnp.asarray(x) for x in args),
                                     bg=jnp.zeros(3),
                                     max_per_tile=max_per_tile, **kw)
    return np.asarray(out[0])[..., 0], np.asarray(out[2])


def test_block_boundary_semantics():
    """A refused pair blocks its pixel only until the next multiple of
    ``chunk`` in the global stream: slot 2 (0.99) is refused at T=0.005,
    slot 128 (0.5) in the next block is applied again. Port and JAX agree
    (colour 0.9975, T 0.0025); the hard-break walk of render_naive stops at
    slot 2 (colour 0.995, T 0.005)."""
    f = boundary_stream(total=384)
    port_c, port_t = run_boundary(f, port=True)
    jax_c, jax_t = run_boundary(f, port=False)
    np.testing.assert_allclose(port_c, 0.9975, atol=1e-6)
    np.testing.assert_allclose(port_t, 0.0025, atol=1e-7)
    np.testing.assert_allclose(port_c, jax_c, atol=1e-6)
    np.testing.assert_allclose(port_t, jax_t, atol=1e-7)
    seq = slice(0, 129)
    c, _, t = TN.walk_pixel(f["mean2d"][seq], f["conic"][seq], f["opac"][seq],
                            f["rgb"][seq], f["depth"][seq], 3, 5)
    assert c[0] == pytest.approx(0.995, abs=1e-6)
    assert t == pytest.approx(0.005, abs=1e-7)
    assert abs(port_c.max() - c[0]) > 2e-3


def test_render_naive_matches_reference(rng):
    """The per-pixel oracle agrees with the JAX one, and on a scene too thin
    to saturate any pixel the pair-stream render agrees with both."""
    from dge_tpu.ops import naive as JN

    js = make_random_scene(rng, n=24, spread=0.7)
    cam, jcam = make_test_camera(height=16, width=16)
    ts, tcam = to_port(js), CameraArrays.from_camera(cam, "cpu")
    bg = np.array([0.2, 0.3, 0.1], np.float32)
    ref = JN.render_naive(js, jcam, bg, tile_px=16)
    out = TN.render_naive(ts, tcam, bg, tile_px=16)
    for k in ("color", "depth", "final_T"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-5, err_msg=k)
    assert out["final_T"].min() > 1e-3  # no pixel reaches the stop
    r = TR.render(ts, tcam, torch.from_numpy(bg), tile_px=16)
    np.testing.assert_allclose(r.color.numpy(), out["color"], atol=1e-4)
    np.testing.assert_allclose(r.depth.numpy(), out["depth"], atol=1e-3)
    np.testing.assert_allclose(1 - r.alpha.numpy(), out["final_T"], atol=2e-4)


def test_reference_reruns_last_stream_block():
    """A reference fault the port does not copy: the TPU wrapper clamps its
    block index to the stream's last block, so a tile whose range reaches
    that block re-runs it (here slot 128 is applied 4 more times, until T
    would fall below 1e-4). The port visits each block once."""
    f = boundary_stream(total=256)  # slot 128 lies in the last block
    jax_c, jax_t = run_boundary(f, port=False)
    np.testing.assert_allclose(jax_t, 0.005 * 0.5 ** 5, rtol=1e-5)
    port_c, port_t = run_boundary(f, port=True)
    np.testing.assert_allclose(port_t, 0.0025, atol=1e-7)
    np.testing.assert_allclose(port_c, 0.9975, atol=1e-6)


@pytest.mark.parametrize("parts", [None, [0, 0, 0, 0], [3, 0, 0, 0],
                                   [0, 2, 0, 0], [0, 0, 5, 1], (1, 2, 3)])
def test_grow_caps_matches_reference(parts):
    caps = dict(max_per_tile=2048, max_tiles_per_gaussian=128, small_slots=16,
                max_pairs=1 << 18, big_capacity=0)
    for _ in range(3):
        want = JR.grow_caps(caps, parts)
        assert TR.grow_caps(caps, parts) == want
        caps = want


def test_psnr_matches_reference(rng):
    a, b = (rng.uniform(size=(8, 9, 3)).astype(np.float32) for _ in range(2))
    assert float(TL.psnr(torch.from_numpy(a), torch.from_numpy(b))) == \
        pytest.approx(float(JL.psnr(jnp.asarray(a), jnp.asarray(b))), abs=1e-5)
