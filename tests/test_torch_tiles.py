"""The per-tile-list path of the PyTorch port against the JAX package:
``bin_gaussians`` (element by element), ``composite`` and its gradients, the
list kernel's plain path against the Pallas list kernel in interpret mode (as
tests/test_pallas.py runs it), the tile-relative chunk rule, the mask lift,
the point-cloud render, the cap ladder without ``spill_parts``, and the
log-space arm's plain version against the Pallas pair-stream kernel. The
port runs on the CPU (plain versions); the same numpy inputs, made from a
seed, go through both packages. The kernels' own tests are in
test_torch_kernel.py.

Tolerances: same arithmetic in the same order (``composite`` against the
JAX ``composite``): colour 1e-5, depth 1e-4, final T 1e-5; against a Pallas
kernel (Hillis-Steele cumprod against torch.cumprod): colour 1e-4, depth
1e-3, alpha 2e-4, as the JAX package holds its own kernels; gradients
2e-3·max|g|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.ops import binning as JB
from dge_tpu.ops import composite as JC
from dge_tpu.ops import pallas_composite as JPC
from dge_tpu.ops import render as JR
from dge_tpu.scene import gaussians as JG
from dge_tpu_torch.ops import binning as TB
from dge_tpu_torch.ops import composite as TCMP
from dge_tpu_torch.ops import cuda_build as CB
from dge_tpu_torch.ops import pairs_composite as TPC
from dge_tpu_torch.ops import render as TR
from dge_tpu_torch.ops import tiles_composite as TTC
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.tools import proto_logdot as TLD
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_backward import assert_grads_close
from tests.test_torch_kernel import random_lists, random_stream
from tests.test_torch_ops import boundary_stream, shared_prep
from tests.test_torch_scene import to_port

BIN_NAMES = ("mean2d", "depth", "radius", "visible")
FEAT_NAMES = ("mean2d", "conic", "rgb", "depth", "opacity")


def t_(x):
    return torch.from_numpy(np.array(x))


def bin_lists_both(prep, cull, **kw):
    extra = ("conic", "opacity") if cull else ()
    jb = jax.jit(lambda *a, **c: JB.bin_gaussians(*a, **c, **kw))(
        *(jnp.asarray(prep[k]) for k in BIN_NAMES),
        **{k: jnp.asarray(prep[k]) for k in extra})
    tb = TB.bin_gaussians(*(t_(prep[k]) for k in BIN_NAMES),
                          **{k: t_(prep[k]) for k in extra}, **kw)
    return jb, tb


def assert_lists_equal(tb, jb):
    """counts and spill equal; every tile's valid entries equal (entries past
    counts[t] are unspecified in both packages)."""
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    assert int(tb.spill) == int(jb.spill)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    tl, jl = tb.lists.numpy(), np.asarray(jb.lists)
    assert tl.shape == jl.shape and tl.dtype == np.int32
    for t, c in enumerate(tb.counts.tolist()):
        np.testing.assert_array_equal(tl[t, :c], jl[t, :c], err_msg=str(t))


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("caps", ["generous", "both_spill"])
def test_bin_gaussians_identical(rng, cull, caps):
    js = make_random_scene(rng, n=256, scale_rng=(-3.5, -1.0))
    _, jcam = make_test_camera(height=64, width=64, angle=0.7)
    prep = shared_prep(js, jcam)
    kw = dict(height=64, width=64, tile_px=16)
    if caps == "generous":
        kw.update(max_per_tile=256, max_tiles_per_gaussian=16)
    else:  # a full tile and a wide Gaussian: both spill terms fire
        kw.update(max_per_tile=24, max_tiles_per_gaussian=3)
    jb, tb = bin_lists_both(prep, cull, **kw)
    assert tb.order is None and jb.order is None
    assert_lists_equal(tb, jb)
    assert int(tb.counts.sum()) > 200
    if caps == "both_spill":
        raw = TB.bin_gaussians(*(t_(prep[k]) for k in BIN_NAMES),
                               **dict(kw, max_per_tile=4096))
        assert int(raw.spill) > 0  # the per-Gaussian term alone
        assert int(tb.spill) > int(raw.spill)  # and the per-tile term
    else:
        assert int(tb.spill) == 0


def test_bin_gaussians_matches_scan(rng):
    """The duplicate-and-sort lists against the prefix-sum oracle inside the
    port, and the oracle against the JAX one
    (tests/test_render.py:174-201)."""
    js = make_random_scene(rng, n=256)
    _, jcam = make_test_camera(height=64, width=64)
    prep = shared_prep(js, jcam)
    kw = dict(height=64, width=64, tile_px=16, max_per_tile=64)
    args = [t_(prep[k]) for k in BIN_NAMES]
    a = TB.bin_gaussians(*args, **kw)
    b = TB.bin_gaussians_scan(*args, chunk=100, **kw)
    np.testing.assert_array_equal(a.counts.numpy(), b.counts.numpy())
    assert int(a.spill) == int(b.spill)
    order = b.order.numpy()
    for t, c in enumerate(a.counts.tolist()):
        np.testing.assert_array_equal(a.lists[t, :c].numpy(),
                                      order[b.lists[t, :c].numpy()])
    jb = JB.bin_gaussians_scan(*(jnp.asarray(prep[k]) for k in BIN_NAMES),
                               **kw)
    np.testing.assert_array_equal(order, np.asarray(jb.order))
    assert_lists_equal(b, jb)


def list_case(rng):
    """A random scene's preprocess outputs and JAX-made lists, as numpy."""
    js = make_random_scene(rng, n=160)
    _, jcam = make_test_camera(height=48, width=64, angle=1.3)
    prep = shared_prep(js, jcam)
    bins = JB.bin_gaussians(*(jnp.asarray(prep[k]) for k in BIN_NAMES),
                            height=48, width=64, tile_px=16, max_per_tile=200)
    geom = dict(height=48, width=64, tiles_x=bins.tiles_x,
                tiles_y=bins.tiles_y, tile_px=16)
    return prep, np.asarray(bins.lists), np.asarray(bins.counts), geom


@pytest.mark.parametrize("chunk", [32, 64])
def test_composite_matches_reference(rng, chunk):
    prep, lists, counts, geom = list_case(rng)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    ref = JC.composite(jnp.asarray(lists), jnp.asarray(counts),
                       *(jnp.asarray(prep[k]) for k in FEAT_NAMES),
                       bg=jnp.asarray(bg), chunk=chunk, **geom)
    out = TCMP.composite(t_(lists), t_(counts),
                         *(t_(prep[k]) for k in FEAT_NAMES), bg=t_(bg),
                         chunk=chunk, **geom)
    np.testing.assert_allclose(out.color.numpy(), np.asarray(ref.color),
                               atol=1e-5)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth),
                               atol=1e-4)
    np.testing.assert_allclose(out.final_T.numpy(), np.asarray(ref.final_T),
                               atol=1e-5)
    assert int(out.spill) == 0
    ft = out.final_T.numpy()
    assert ft.min() < 0.05 and ft.max() == 1.0  # opaque and empty pixels


def test_torch_tiles_gradients_match_jax_jnp(rng):
    """Plain autograd through ``render(backend="torch_tiles")`` against
    jax.grad of the JAX "jnp" render, all six parameter groups."""
    js = make_random_scene(rng, n=48, capacity=64)
    cam, jcam = make_test_camera(height=32, width=32)
    target = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    bg = np.array([0.3, 0.1, 0.0], np.float32)
    kw = dict(tile_px=16, max_per_tile=128, chunk=32)

    def jloss(params):
        out = JR.render(js.with_params(params), jcam, jnp.asarray(bg),
                        backend="jnp", **kw)
        return (jnp.mean((out.color - jnp.asarray(target)) ** 2)
                + 0.1 * jnp.mean(out.depth) + 0.05 * jnp.mean(out.alpha))

    want = jax.jit(jax.grad(jloss))(js.params())
    names = list(js.params())
    ts = to_port(js)
    params = {k: v.clone().requires_grad_(True)
              for k, v in ts.params().items()}
    out = TR.render(ts.with_params(params), CameraArrays.from_camera(cam, "cpu"),
                    t_(bg), backend="torch_tiles", **kw)
    loss = (torch.mean((out.color - t_(target)) ** 2)
            + 0.1 * torch.mean(out.depth) + 0.05 * torch.mean(out.alpha))
    got = torch.autograd.grad(loss, [params[k] for k in names])
    assert out.spill_parts is None
    assert_grads_close([g.numpy() for g in got], [want[k] for k in names],
                       names, "torch_tiles")
    assert float(got[0].abs().max()) > 1e-6


@pytest.mark.parametrize("angle", [0.0, 2.0])
def test_list_kernel_plain_path_matches_pallas(rng, angle):
    """``render(backend="torch_tiles", chunk=128)``, the list kernel's plain
    version at the kernel's chunk, against JAX ``render(backend="pallas")``
    in interpret mode; the kernel's wrapper on CPU tensors gives the same
    image as the plain path."""
    js = make_random_scene(rng, n=64)
    cam, jcam = make_test_camera(height=32, width=32, angle=angle)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    kw = dict(tile_px=16, max_per_tile=128)
    ref = jax.jit(lambda s, c: JR.render(s, c, jnp.asarray(bg),
                                         backend="pallas", **kw))(js, jcam)
    ts, tcam = to_port(js), CameraArrays.from_camera(cam, "cpu")
    out = TR.render(ts, tcam, t_(bg), backend="torch_tiles", chunk=128, **kw)
    np.testing.assert_allclose(out.color.numpy(), np.asarray(ref.color),
                               atol=1e-4)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth),
                               atol=1e-3)
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(ref.alpha),
                               atol=2e-4)
    assert int(out.spill) == int(ref.spill) == 0
    assert float(out.alpha.max()) > 0.5


def test_list_kernel_plain_path_empty_tiles(rng):
    """A scene confined to one corner: most tiles hold no Gaussian
    (tests/test_pallas.py:30-36)."""
    js = make_random_scene(rng, n=8, spread=0.05)
    cam, jcam = make_test_camera(height=32, width=32)
    kw = dict(tile_px=16, max_per_tile=128)
    ref = JR.render(js, jcam, backend="pallas", **kw)
    out = TR.render(to_port(js), CameraArrays.from_camera(cam, "cpu"),
                    backend="torch_tiles", chunk=128, **kw)
    np.testing.assert_allclose(out.color.numpy(), np.asarray(ref.color),
                               atol=3e-5)
    assert float(out.alpha.min()) == 0.0 and float(out.alpha.max()) > 0.1


def run_list_boundary(f, slots, chunk, package):
    """The block-boundary fixture as ONE tile's list of ``slots`` entries."""
    lists = np.arange(slots, dtype=np.int32)[None, :]
    counts = np.array([slots], np.int32)
    feats = (f["mean2d"], f["conic"], f["rgb"], f["depth"], f["opac"])
    geom = dict(height=16, width=16, tiles_x=1, tiles_y=1, tile_px=16)
    if package == "jax":
        c, _, t = JPC.composite_tiles_pallas(
            jnp.asarray(lists), jnp.asarray(counts),
            *(jnp.asarray(x) for x in feats), bg=jnp.zeros(3), chunk=chunk,
            **geom)
        return np.asarray(c)[..., 0], np.asarray(t)
    c, _, t = TTC.composite_tiles(t_(lists), t_(counts),
                                  *(t_(x) for x in feats), bg=torch.zeros(3),
                                  chunk=chunk, **geom)
    return c.numpy()[..., 0], t.numpy()


def test_block_boundary_semantics_tile_relative():
    """The list compositors cut chunks from the tile's OWN slot 0. Alphas
    0.99, 0.5, 0.99 in slots 0-2 refuse slot 2 at T=0.005; a 0.5 in slot 128
    lies in the tile's next chunk of 128 and is applied again (colour 0.9975),
    in the port as in the Pallas list kernel. The same 0.5 in slot 100 shares
    slot 2's chunk and stays refused (0.995), although in a pair stream that
    starts at offset 64 it would fall into the next ABSOLUTE block and be
    applied: the two families differ there. At chunk 64 the list form applies
    it too: a list render depends on its chunk."""
    f = boundary_stream(total=256)
    for package in ("port", "jax"):
        c, t = run_list_boundary(f, 129, 128, package)
        np.testing.assert_allclose(c, 0.9975, atol=1e-6, err_msg=package)
        np.testing.assert_allclose(t, 0.0025, atol=1e-7, err_msg=package)
    f["opac"][128] = 0.0
    f["opac"][100] = 0.5
    for package in ("port", "jax"):
        c, t = run_list_boundary(f, 129, 128, package)
        np.testing.assert_allclose(c, 0.995, atol=1e-6, err_msg=package)
        np.testing.assert_allclose(t, 0.005, atol=1e-7, err_msg=package)
    # the same list as a pair stream whose tile range starts at offset 64
    shift = 64
    ids = np.concatenate([np.zeros(shift, np.int32),
                          np.arange(129, dtype=np.int32),
                          np.zeros(256 - 129 - shift + 128, np.int32)])
    sc, _, st = TPC.composite_pairs(
        t_(ids), t_(np.array([shift], np.int32)),
        t_(np.array([129], np.int32)),
        *(t_(f[k]) for k in ("mean2d", "conic", "rgb", "depth", "opac")),
        height=16, width=16, tiles_x=1, tiles_y=1, tile_px=16,
        bg=torch.zeros(3), chunk=128, use_kernel=False)
    np.testing.assert_allclose(sc.numpy()[..., 0], 0.9975, atol=1e-6)
    np.testing.assert_allclose(st.numpy(), 0.0025, atol=1e-7)
    # and the list form at chunk 64: slot 100 is in the tile's second chunk
    lists = t_(np.arange(129, dtype=np.int32)[None, :])
    out = TCMP.composite_lists(
        lists, t_(np.array([129], np.int32)),
        *(t_(f[k]) for k in ("mean2d", "conic", "rgb", "depth", "opac")),
        tiles_x=1, tile_px=16, chunk=64)
    np.testing.assert_allclose(out[0, 0].numpy(), 0.9975, atol=1e-6)


def list_rows_plain(table, lists, counts, order=None, *, tiles_x, tile_px,
                    chunk):
    """K2's layout through the two kernels' plain versions, called
    directly: the aligned list stream, ``rows_forward_reference``,
    ``rows_combine_reference``."""
    starts, blk_off, cum, n_rows = TTC.list_rows(counts, chunk)
    data, row_tile = TTC.list_stream_reference(table, lists, counts, order,
                                               cum, n_rows, chunk)
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    scratch, mask = TPC.rows_forward_reference(data, starts, counts, blk_off,
                                               row_tile, **kw)
    return TPC.rows_combine_reference(scratch, mask, data, starts, counts,
                                      blk_off, **kw)


def assert_lists_close(got, want, what=""):
    """K2's layout against ``composite_lists``: colour and final T within
    1e-6, depth within 1e-6 of its largest value (a row whose every pair is
    applied adds ``T·L``, the row's sum taken from T = 1, where the plain
    version adds ``T·cp/(1-α)·α·c`` pair by pair: f32 rounding only)."""
    err = (got - want).abs()
    assert float(err[:, 0:3].max()) <= 1e-6, what
    assert float(err[:, 4].max()) <= 1e-6, what
    assert float(err[:, 3].max()) <= 1e-6 * max(
        1.0, float(want[:, 3].abs().max())), what


def test_list_wrapper_takes_plain_version_for_cpu_tensors(rng):
    """On CPU tensors the list kernel's wrapper runs the two kernels' plain
    versions over its aligned list stream, with and without ``order``,
    counts no launch, and checks what it is given; it agrees with the plain
    list compositor ``composite_lists``."""
    prep, lists, counts, geom = list_case(rng)
    feats = [t_(prep[k]) for k in FEAT_NAMES]
    table = TTC.feature_table(*feats)
    assert table.shape == (prep["depth"].shape[0], TPC.FEAT)
    kw = dict(tiles_x=geom["tiles_x"], tile_px=16, chunk=128)
    before = dict(CB.launch_counts)
    got = TTC.composite_tiles_kernel(table, t_(lists), t_(counts), **kw)
    assert torch.equal(got, list_rows_plain(table, t_(lists), t_(counts),
                                            **kw))
    want = TCMP.composite_lists(t_(lists), t_(counts), *feats, **kw)
    assert_lists_close(got, want)
    # a depth permutation: features permuted, lists index through `order`
    n = table.shape[0]
    perm = np.random.default_rng(5).permutation(n).astype(np.int32)
    inv = np.argsort(perm).astype(np.int32)
    via = TTC.composite_tiles_kernel(table, t_(inv[lists]), t_(counts),
                                     t_(perm), **kw)
    assert torch.equal(via, got)
    assert CB.launch_counts == before
    with pytest.raises(ValueError, match="must be a contiguous torch.int32"):
        TTC.composite_tiles_kernel(table, t_(lists).long(), t_(counts), **kw)
    with pytest.raises(ValueError, match=r"must be \[N, 10\]"):
        TTC.composite_tiles_kernel(table[:, :9].contiguous(), t_(lists),
                                   t_(counts), **kw)
    # a CPU scene with the kernel's backend named renders through the
    # wrapper's plain version, as "cuda_stream" does, and launches nothing
    ts = to_port(make_random_scene(rng, n=40))
    cam, _ = make_test_camera(height=32, width=32)
    tcam = CameraArrays.from_camera(cam, "cpu")
    named = TR.render(ts, tcam, tile_px=16, backend="cuda_tiles")
    plain = TR.render(ts, tcam, tile_px=16, backend="torch_tiles", chunk=128)
    assert float((named.color - plain.color).abs().max()) <= 1e-6
    assert float(named.alpha.max()) > 0.5
    assert CB.launch_counts == before


def test_list_rows_layout():
    """K2's aligned list stream on a hand case: chunk 4, counts 3, 0, 5 →
    tile starts 0, 4, 4 (multiples of the chunk), rows (tile 0), (tile 2,
    chunk 0), (tile 2, chunk 1); each slot at its tile's start plus the
    slot, through ``order`` when given, zeros past a tile's count; the
    layout wrapper takes its plain version on CPU tensors and counts no
    launch."""
    counts = torch.tensor([3, 0, 5], dtype=torch.int32)
    starts, blk_off, cum, n_rows = TTC.list_rows(counts, 4)
    assert n_rows == 3
    assert starts.tolist() == [0, 4, 4] and blk_off.tolist() == [0, 1, 1]
    assert cum.tolist() == [1, 1, 3]
    assert starts.dtype == blk_off.dtype == cum.dtype == torch.int32
    table = torch.arange(20 * TPC.FEAT, dtype=torch.float32).reshape(20, -1)
    lists = torch.tensor([[7, 3, 9, 1, 1, 1], [0] * 6, [2, 4, 6, 8, 5, 11]],
                         dtype=torch.int32)
    before = dict(CB.launch_counts)
    data, row_tile = TTC.list_stream(table, lists, counts, None, cum, n_rows,
                                     4)
    assert CB.launch_counts == before
    assert row_tile.tolist() == [0, 2, 2] and row_tile.dtype == torch.int32
    assert data.shape == (TPC.FEAT, 12) and data.is_contiguous()
    want = {0: 7, 1: 3, 2: 9, 4: 2, 5: 4, 6: 6, 7: 8, 8: 5}
    for pos in range(12):
        expect = table[want[pos]] if pos in want else torch.zeros(TPC.FEAT)
        assert torch.equal(data[:, pos], expect), pos
    order = torch.arange(19, -1, -1, dtype=torch.int32)
    via, _ = TTC.list_stream(table, lists, counts, order, cum, n_rows, 4)
    for pos, g in want.items():
        assert torch.equal(via[:, pos], table[19 - g]), pos
    empty = TTC.list_rows(torch.zeros(3, dtype=torch.int32), 4)
    assert empty[3] == 0
    data, row_tile = TTC.list_stream(table, lists, torch.zeros_like(counts),
                                     None, empty[2], 0, 4)
    assert data.shape == (TPC.FEAT, 0) and row_tile.numel() == 0


@pytest.mark.parametrize("tile_px,chunk", [(8, 16), (8, 32), (16, 16),
                                           (16, 32)])
@pytest.mark.parametrize("with_order", [False, True])
def test_list_rows_match_lists_and_pallas(tile_px, chunk, with_order):
    """K2's layout, the aligned list stream through the plain row + combine
    arithmetic (what the wrapper runs on CPU tensors, and its kernels on a
    card), against ``composite_lists`` (``assert_lists_close``) and against
    the Pallas list kernel ``composite_tiles_pallas`` in interpret mode
    (colour 1e-4, depth 1e-3, final T 2e-4), on lists of up to five chunks
    with two empty tiles and a full one, directly and through ``order``;
    every case of the combine fires."""
    rng = np.random.default_rng(tile_px * 100 + chunk + with_order)
    _, _, _, m, c, r, d, o, tiles_x = random_stream(rng, 8, tile_px, tail=0)
    # wider and more opaque than random_stream's: pixels saturate
    c = (c * 0.1).astype(np.float32)
    o = rng.uniform(0.2, 0.99, size=o.shape).astype(np.float32)
    lists, counts = random_lists(rng, 8, 5 * chunk - 3)
    counts[5] = 0
    order = None
    if with_order:
        perm = rng.permutation(80).astype(np.int32)
        order = perm
        lists = np.argsort(perm).astype(np.int32)[lists]
    feats = [t_(x) for x in (m, c, r, d, o)]
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    table = TTC.feature_table(*feats)
    ot = None if order is None else t_(order)
    got = list_rows_plain(table, t_(lists), t_(counts), ot, **kw)
    assert torch.equal(got, TTC.composite_tiles_kernel(
        table, t_(lists), t_(counts), ot, **kw))
    assert_lists_close(got, TCMP.composite_lists(t_(lists), t_(counts),
                                                 *feats, order=ot, **kw))
    assert float(got[1, 4].min()) == float(got[5, 4].min()) == 1.0
    tiles_y = 8 // tiles_x
    geom = dict(height=tiles_y * tile_px, width=tiles_x * tile_px,
                tiles_x=tiles_x, tiles_y=tiles_y, tile_px=tile_px)
    jc, jd, jt = JPC.composite_tiles_pallas(
        jnp.asarray(lists), jnp.asarray(counts),
        *(jnp.asarray(x) for x in (m, c, r, d, o)), bg=jnp.zeros(3),
        chunk=chunk, interpret=True,
        order=None if order is None else jnp.asarray(order), **geom)
    tc, td, tt = TCMP.tiles_to_image(got, torch.zeros(3), **geom)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-4)
    # the row + combine cases, from the plain versions' boundary T
    starts, blk_off, cum, n_rows = TTC.list_rows(t_(counts), chunk)
    data, row_tile = TTC.list_stream(table, t_(lists), t_(counts), ot, cum,
                                     n_rows, chunk)
    scratch, mask = TPC.rows_forward_reference(data, starts, t_(counts),
                                               blk_off, row_tile, **kw)
    _, bt = TPC.rows_combine_reference(scratch, mask, data, starts,
                                       t_(counts), blk_off, boundary=True,
                                       **kw)
    cases = TPC.combine_cases(scratch, bt, row_tile, 8)
    assert min(cases["all"], cases["none"], cases["walk"]) > 0, cases


def test_render_weights_matches_reference(rng):
    js = make_random_scene(rng, n=96)
    cam, jcam = make_test_camera(height=32, width=48, angle=0.4)
    mask = (rng.uniform(size=(32, 48)) > 0.5).astype(np.float32)
    kw = dict(tile_px=16, max_per_tile=128)
    jw, jh = JR.render_weights(js, jcam, jnp.asarray(mask), **kw)
    tw, th, spill, _ = TR.render_weights(to_port(js),
                                         CameraArrays.from_camera(cam, "cpu"),
                                         t_(mask), **kw)
    assert int(spill) == 0
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-4)
    assert float(th.sum()) > 1000 and 0 < float(tw.sum()) < float(th.sum())


def test_render_weights_behaviour(rng):
    """Full mask: weight == hits; half mask: the weights follow the mask's
    side (tests/test_render.py:135-170)."""
    cam, _ = make_test_camera(height=32, width=32)
    tcam = CameraArrays.from_camera(cam, "cpu")
    ts = to_port(make_random_scene(rng, n=32))
    w, c, _, _ = TR.render_weights(ts, tcam, torch.ones(32, 32),
                                   tile_px=16, max_per_tile=64)
    assert torch.equal(w, c) and float(w.sum()) > 0
    xs = np.linspace(-1.5, 1.5, 8).astype(np.float32)
    line = to_port(JG.from_arrays(
        np.stack([xs, np.zeros(8), np.zeros(8)], axis=1).astype(np.float32),
        np.zeros((8, 1, 3), np.float32), np.zeros((8, 0, 3), np.float32),
        np.full((8, 1), 2.0, np.float32),
        np.full((8, 3), np.log(0.08), np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (8, 1)),
        max_sh_degree=0))
    mask = torch.zeros(32, 32)
    mask[:, 16:] = 1.0
    w, c, _, _ = TR.render_weights(line, tcam, mask, tile_px=16,
                                   max_per_tile=64)
    frac = (w[:8] / torch.clamp(c[:8], min=1)).numpy()
    assert frac[0] > 0.9 and frac[-1] < 0.1


def test_render_point_cloud_matches_reference(rng):
    pts = rng.normal(size=(50, 3)).astype(np.float32) * 0.8
    cols = rng.uniform(size=(50, 3)).astype(np.float32)
    cam, jcam = make_test_camera(height=32, width=32)
    kw = dict(point_size=0.05, tile_px=16, max_per_tile=128)
    ref = JR.render_point_cloud(pts, cols, jcam, backend="pallas_stream", **kw)
    out = TR.render_point_cloud(pts, cols,
                                CameraArrays.from_camera(cam, "cpu"), **kw)
    np.testing.assert_allclose(out.color.numpy(), np.asarray(ref.color),
                               atol=1e-4)
    assert float(out.alpha.max()) > 0.5 and out.radii.shape == (4096,)


def test_spill_free_ladder_on_lists_matches_reference(rng):
    """From caps that overflow both ``max_per_tile`` and
    ``max_tiles_per_gaussian`` the list renderer climbs with ``parts=None``
    (every cap doubles) to spill 0, rung for rung as the JAX renderer does
    on its "jnp" backend, and the image matches."""
    js = make_random_scene(rng, n=256, scale_rng=(-3.5, -1.5))
    cam, jcam = make_test_camera(height=64, width=64)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    caps = dict(max_per_tile=4, max_tiles_per_gaussian=2)
    jlog, tlog = [], []
    jr = JR.SpillFreeRenderer(js, jnp.asarray(bg), tile_px=16, backend="jnp",
                              log=jlog.append, **caps)
    tr = TR.SpillFreeRenderer(to_port(js), t_(bg), tile_px=16,
                              backend="torch_tiles", log=tlog.append, **caps)
    tcam = CameraArrays.from_camera(cam, "cpu")
    assert tr.probe(tcam) == 0 and jr.probe(jcam) == 0
    assert tlog == jlog and len(tlog) > 2
    assert "parts None" in tlog[1]
    assert tr.caps == jr.caps
    assert tr.caps["max_per_tile"] > 4
    assert tr.caps["max_tiles_per_gaussian"] > 2
    assert tr.caps["small_slots"] > 4  # parts=None doubles every cap
    color, sp = tr(tcam)
    jcolor, jsp = jr(jcam)
    assert sp == 0 and jsp == 0
    np.testing.assert_allclose(color.numpy(), np.asarray(jcolor), atol=1e-5)


def test_list_backend_device_pairing(rng):
    ts = to_port(make_random_scene(rng, n=16))
    with pytest.raises(ValueError, match="does not run"):
        TR.SpillFreeRenderer(ts, backend="cuda_tiles")
    assert TR.SpillFreeRenderer(ts, backend="torch_tiles").caps[
        "max_per_tile"] == 4096


@pytest.mark.parametrize("chunk", [128, 256])
def test_logdot_reference_matches_pallas_pairs_kernel(rng, chunk):
    """The log-space arm's plain version against the JAX pair-stream kernel
    (interpret mode) and against the port's production plain version, on a
    stream that runs a block past the last tile. Through its wrapper, which
    takes the plain version on CPU tensors and counts no launch."""
    tile_px, num_tiles = 16, 6
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(
        rng, num_tiles, tile_px, tail=chunk + 5)
    tiles_y = num_tiles // tiles_x
    geom = dict(height=tiles_y * tile_px, width=tiles_x * tile_px,
                tiles_x=tiles_x, tiles_y=tiles_y, tile_px=tile_px)
    ref = JPC.composite_pairs_pallas(
        *(jnp.asarray(x) for x in (ids, starts, counts, m, c, r, d, o)),
        bg=jnp.zeros(3), max_per_tile=512, chunk=chunk, **geom)
    data = TPC.assemble_stream_data(*(t_(x) for x in (ids, m, c, r, d, o)))
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    before = dict(CB.launch_counts)
    out = TLD.composite_pairs_logdot(data, t_(starts), t_(counts), **kw)
    assert CB.launch_counts == before
    assert torch.equal(out, TLD.composite_pairs_logdot_reference(
        data, t_(starts), t_(counts), **kw))
    prod = TPC.composite_pairs_reference(data, t_(starts), t_(counts), **kw)
    for rows, tol in ((slice(0, 3), 1e-4), (slice(3, 4), 1e-3),
                      (slice(4, 5), 2e-4)):
        assert float((out[:, rows] - prod[:, rows]).abs().max()) <= tol
    assert not torch.equal(out, prod)  # another arithmetic, not a rename
    color, depth, trans = TCMP.tiles_to_image(out, torch.zeros(3), **geom)
    for got, want, tol in zip((color, depth, trans), ref, (1e-4, 1e-3, 2e-4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    with pytest.raises(ValueError, match=r"must be \[10, Pc\]"):
        TLD.composite_pairs_logdot(data[:9].contiguous(), t_(starts),
                                   t_(counts), **kw)
