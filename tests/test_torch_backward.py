"""The backward of the pair-stream compositing in the PyTorch port: the
analytic two-pass plain versions (``pass1_reference`` / ``pass2_reference`` +
fold, the CPU twins of the CUDA kernels) against the JAX package's Pallas
backward in interpret mode and against torch autograd through the plain
forward; ``render`` gradients against ``jax.grad`` of the JAX ``"jnp"``
backend; the ``boundary_T`` that the forward hands to the backward against
pass 1's own and the Pallas pass-1 kernel's. The port runs on the CPU; the
same numpy inputs go through both packages. Gradient tolerance:
2e-3·max|g| + 1e-7 per field (the pixel sums run in another order), the
tolerance the JAX package sets for its own backward
(tests/test_pallas.py:95-100); boundary T 2e-4, as final T."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dge_tpu.ops import pallas_backward as JPB
from dge_tpu.ops import pallas_composite as JPC
from dge_tpu.ops import render as JR
from dge_tpu_torch.ops import pairs_backward as TPB
from dge_tpu_torch.ops import pairs_composite as TPC
from dge_tpu_torch.ops import render as TR
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_kernel import FOLD_CASES, binned_fold_case, random_stream
from tests.test_torch_scene import to_port

@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


ROWS = ("mean x", "mean y", "conic a", "conic b", "conic c", "opacity",
        "r", "g", "b", "depth")


def assert_grads_close(got, want, names, what=""):
    for k, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max()
        assert np.isfinite(a).all(), (what, k)
        np.testing.assert_allclose(a, b, atol=2e-3 * scale + 1e-7, rtol=0,
                                   err_msg=f"{what} {k}")


def stream_case(rng, tail):
    """A 2x2-tile stream at tile 16, chunk 128, with a random cotangent."""
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(
        rng, 4, 16, tail)
    pc = len(ids)
    cot = rng.normal(size=(4, 5, 256)).astype(np.float32)
    return dict(ids=ids, starts=starts, counts=counts, feats=(m, c, r, d, o),
                tiles_x=tiles_x, pc=pc, cot=cot, n=len(m))


def port_backward(case, chunk=128):
    """Port: plain forward, then pass 1 + pass 2 + fold on CPU tensors."""
    t = {k: torch.from_numpy(case[k]) for k in ("ids", "starts", "counts",
                                                "cot")}
    feats = [torch.from_numpy(x) for x in case["feats"]]
    data = TPC.assemble_stream_data(t["ids"], *feats)
    kw = dict(tiles_x=case["tiles_x"], tile_px=16, chunk=chunk)
    out = TPC.composite_pairs_stream(data, t["starts"], t["counts"], **kw)
    g = TPB.stream_backward(data, t["ids"], t["starts"], t["counts"],
                            t["cot"], out, case["n"], **kw)
    return data, out, g


def jax_backward(case, chunk=128, max_per_tile=384):
    """JAX: Pallas forward for T_fin, then `_stream_backward` (both Pallas
    kernels in interpret mode) → [10, N]."""
    m, c, r, d, o = case["feats"]
    feat = np.zeros((JPC.FEAT, case["n"]), np.float32)
    feat[:10] = np.stack([m[:, 0], m[:, 1], c[:, 0], c[:, 1], c[:, 2], o,
                          r[:, 0], r[:, 1], r[:, 2], d])
    side = 16 * case["tiles_x"]
    _, _, tfin = JPC.composite_pairs_pallas(
        jnp.asarray(case["ids"]), jnp.asarray(case["starts"]),
        jnp.asarray(case["counts"]), *(jnp.asarray(x) for x in (m, c, r, d, o)),
        height=side, width=side, tiles_x=case["tiles_x"],
        tiles_y=4 // case["tiles_x"], tile_px=16, bg=jnp.zeros(3),
        max_per_tile=max_per_tile, chunk=chunk)
    tfin_tiles = JPB._image_to_tiles(tfin, case["tiles_x"],
                                     4 // case["tiles_x"], 16)
    g = JPB._stream_backward(
        jnp.asarray(case["ids"]), jnp.asarray(case["starts"]),
        jnp.asarray(case["counts"]), jnp.asarray(feat),
        jnp.asarray(case["cot"]), tfin_tiles, num_tiles=4,
        tiles_x=case["tiles_x"], tile_px=16, chunk=chunk,
        max_per_tile=max_per_tile)
    return np.asarray(g)[:10], np.asarray(tfin_tiles)


def pad_to_blocks(case, chunk, extra_blocks):
    """Lengthen the stream to a whole number of blocks plus ``extra_blocks``
    past the last tile's range (ids of the tail are never read in range)."""
    end = int(case["starts"][-1] + case["counts"][-1])
    want = -(-end // chunk) * chunk + extra_blocks * chunk
    ids = np.zeros(want, np.int32)
    keep = min(want, case["pc"])
    ids[:keep] = case["ids"][:keep]
    return dict(case, ids=ids, pc=want)


def test_two_pass_matches_pallas_backward():
    """pass1_reference + pass2_reference + fold against the JAX
    `_stream_backward` on a stream that runs a block past the last tile."""
    case = pad_to_blocks(stream_case(np.random.default_rng(5), 0), 128, 1)
    _, out, g = port_backward(case)
    g_ref, tfin = jax_backward(case)
    np.testing.assert_allclose(out[:, 4].numpy(), tfin, atol=2e-4)
    assert float(np.abs(g_ref).max()) > 1e-3  # a real gradient
    assert_grads_close(g.numpy(), g_ref, ROWS, "vs pallas backward")


@pytest.mark.parametrize("chunk", [128, 256])
def test_two_pass_matches_autograd_of_plain_forward(chunk):
    """The analytic backward against torch autograd through
    composite_pairs_reference, with a cotangent on all five outputs."""
    case = stream_case(np.random.default_rng(6), 3)
    data, out, g = port_backward(case, chunk)
    ids = torch.from_numpy(case["ids"]).long()
    starts, counts = (torch.from_numpy(case[k]) for k in ("starts", "counts"))
    feat = torch.stack([torch.from_numpy(x) for x in (
        case["feats"][0][:, 0], case["feats"][0][:, 1],
        case["feats"][1][:, 0], case["feats"][1][:, 1],
        case["feats"][1][:, 2], case["feats"][4], case["feats"][2][:, 0],
        case["feats"][2][:, 1], case["feats"][2][:, 2], case["feats"][3])])
    feat.requires_grad_(True)
    plain = TPC.composite_pairs_reference(
        feat[:, ids], starts, counts, tiles_x=case["tiles_x"], tile_px=16,
        chunk=chunk)
    assert torch.equal(plain.detach(), out)
    (plain * torch.from_numpy(case["cot"])).sum().backward()
    assert_grads_close(g.numpy(), feat.grad.numpy(), ROWS, "vs autograd")


def test_block_rows_layout():
    """Rows are compact, in tile order, and within the sync-free bound."""
    starts = torch.tensor([0, 100, 100, 260, 700], dtype=torch.int32)
    counts = torch.tensor([100, 0, 160, 440, 1], dtype=torch.int32)
    blk_off, row_tile, n_rows = TPB.block_rows(starts, counts, 128, 1024)
    # blocks: tile 0 -> {0}, tile 2 -> {0, 1, 2}, tile 3 -> {2..5}, tile 4 -> {5}
    assert blk_off.tolist() == [0, 1, 1, 4, 8]
    assert n_rows == 8 + 5
    assert row_tile.tolist() == [0, 2, 2, 2, 3, 3, 3, 3, 4, 5, 5, 5, 5]


def test_reference_backward_reruns_last_stream_block():
    """The JAX backward clamps its block index to the stream's last block,
    so a tile whose range reaches that block re-runs it and its gradients
    are added again (pallas_backward.py:128,167,334-336). The port visits
    each block once: it matches the JAX package on a stream that runs one
    block past the tile, and differs from it on the short stream."""
    total = 384
    m = np.full((total, 2), 8.0, np.float32)  # all at pixel (8, 8)
    c = np.zeros((total, 3), np.float32)  # conic 0: alpha = opacity
    o = np.zeros(total, np.float32)
    o[[0, 1, 2, 128]] = [0.5, 0.3, 0.4, 0.5]
    r = np.tile(np.array([[1.0, 0.5, 0.25]], np.float32), (total, 1))
    d = np.ones(total, np.float32)
    cot = np.ones((1, 5, 256), np.float32)
    base = dict(starts=np.zeros(1, np.int32), counts=np.full(1, 129, np.int32),
                feats=(m, c, r, d, o), tiles_x=1, cot=cot, n=total)

    def jax_one(pc):
        case = dict(base, ids=np.arange(pc, dtype=np.int32), pc=pc)
        feat = np.zeros((JPC.FEAT, total), np.float32)
        feat[:10] = np.stack([m[:, 0], m[:, 1], c[:, 0], c[:, 1], c[:, 2], o,
                              r[:, 0], r[:, 1], r[:, 2], d])
        # T_fin of the true image: (1-.5)(1-.3)(1-.4)(1-.5)
        tfin = jnp.full((1, 256), 0.105, jnp.float32)
        g = JPB._stream_backward(
            jnp.asarray(case["ids"]), jnp.asarray(base["starts"]),
            jnp.asarray(base["counts"]), jnp.asarray(feat), jnp.asarray(cot),
            tfin, num_tiles=1, tiles_x=1, tile_px=16, chunk=128,
            max_per_tile=256)
        return np.asarray(g)[:10]

    case = dict(base, ids=np.arange(384, dtype=np.int32), pc=384)
    _, out, g = port_backward(case)
    np.testing.assert_allclose(out[0, 4].numpy(), 0.105, atol=1e-6)
    long, short = jax_one(384), jax_one(256)
    assert_grads_close(g.numpy(), long, ROWS, "long stream")
    # d colour of slot 128 = sum over pixels of its weight: 256 * 0.21 * 0.5
    np.testing.assert_allclose(g[6, 128].item(), 256 * 0.105, rtol=1e-5)
    # block 1 ran twice, the second time from the T it had left behind:
    # slot 128's colour gradient is 256 * (0.105 + 0.0525)
    np.testing.assert_allclose(short[6, 128], 1.5 * long[6, 128], rtol=1e-5)
    _, _, g_short = port_backward(dict(case, ids=case["ids"][:256], pc=256))
    np.testing.assert_allclose(g_short.numpy(), g.numpy(), atol=1e-6)


def render_loss_torch(ts, cam, bg, target, offset, backend):
    out = TR.render(ts, cam, bg, tile_px=16, max_per_tile=128, chunk=32,
                    mean2d_offset=offset, backend=backend)
    return (torch.mean((out.color - target) ** 2) + 0.1 * torch.mean(out.depth)
            + 0.05 * torch.mean(out.alpha))


def test_render_gradients_match_jax_jnp(rng):
    """Gradients of all six parameter groups and of mean2d_offset through
    the port's render (backend "torch": plain autograd; backend "cuda_train"
    on CPU tensors: the analytic two-pass versions behind the Function)
    against jax.grad of the JAX "jnp" backend
    (sizes of tests/test_pallas.py:73-124)."""
    js = make_random_scene(rng, n=48, capacity=64)
    cam, jcam = make_test_camera(height=32, width=32)
    target = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    bg = np.array([0.3, 0.1, 0.0], np.float32)

    def jloss(params, offset):
        out = JR.render(js.with_params(params), jcam, jnp.asarray(bg),
                        tile_px=16, max_per_tile=128, chunk=32,
                        mean2d_offset=offset, backend="jnp")
        return (jnp.mean((out.color - jnp.asarray(target)) ** 2)
                + 0.1 * jnp.mean(out.depth) + 0.05 * jnp.mean(out.alpha))

    g_params, g_off = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        js.params(), jnp.zeros((64, 2)))
    names = list(js.params())
    want = [g_params[k] for k in names] + [g_off]
    assert float(np.abs(np.asarray(g_off)).max()) > 1e-6
    tcam = CameraArrays.from_camera(cam, "cpu")
    for backend in ("torch", "cuda_train"):
        ts = to_port(js)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in ts.params().items()}
        offset = torch.zeros(64, 2, requires_grad=True)
        loss = render_loss_torch(ts.with_params(params), tcam,
                                 torch.from_numpy(bg),
                                 torch.from_numpy(target), offset, backend)
        got = torch.autograd.grad(loss, [params[k] for k in names] + [offset])
        assert_grads_close([g.numpy() for g in got], want,
                           names + ["mean2d_offset"], backend)


def test_gradients_finite_with_dead_and_culled_rows(rng):
    """torch.where does not stop a NaN from the branch not taken: dead rows
    (scaling -20, opacity -10), Gaussians behind the camera and far off
    screen must leave every gradient finite, and the dead rows' exactly 0."""
    js = make_random_scene(rng, n=40, capacity=64, max_sh_degree=3)
    xyz = np.asarray(js.xyz).copy()
    xyz[0] = [0.0, 0.3, -4.0]  # at the camera centre
    xyz[1] = [0.0, 0.0, -9.0]  # behind the camera
    xyz[2] = [50.0, 0.0, 0.0]  # far off screen
    xyz[3] = [0.0, 0.3, -3.8 + 1e-4]  # just inside the near plane
    js = js.replace(xyz=jnp.asarray(xyz))
    cam, _ = make_test_camera(height=32, width=32)
    tcam = CameraArrays.from_camera(cam, "cpu")
    target = torch.from_numpy(rng.uniform(size=(32, 32, 3)).astype(np.float32))
    for backend in ("torch", "cuda_train"):
        ts = to_port(js)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in ts.params().items()}
        offset = torch.zeros(64, 2, requires_grad=True)
        loss = render_loss_torch(ts.with_params(params), tcam, None, target,
                                 offset, backend)
        grads = torch.autograd.grad(loss, list(params.values()) + [offset])
        for k, g in zip(list(params) + ["offset"], grads):
            assert bool(torch.isfinite(g).all()), (backend, k)
            assert float(g[~ts.alive].abs().max()) == 0.0, (backend, k)
        assert float(grads[0].abs().max()) > 0.0


def test_cuda_train_on_cpu_launches_nothing(rng):
    """On CPU tensors the Function's wrappers take the plain versions and
    count no launch; the wrappers still check what they are given."""
    ts = to_port(make_random_scene(rng, n=24))
    cam, _ = make_test_camera(height=32, width=32)
    before = dict(TPC.launch_counts)
    assert set(before) == {"pairs_composite", "pairs_composite_combine",
                           "pairs_pass1", "pairs_suffix", "pairs_pass2",
                           "pairs_fold", "list_stream", "tiles_composite",
                           "pairs_logdot",
                           "pairs_logdot_combine"}
    xyz = ts.xyz.clone().requires_grad_(True)
    out = TR.render(ts.replace(xyz=xyz), CameraArrays.from_camera(cam, "cpu"),
                    tile_px=16, backend="cuda_train")
    out.color.sum().backward()
    assert float(xyz.grad.abs().max()) > 0
    assert TPC.launch_counts == before
    assert TR.default_train_backend("cuda") == "cuda_train"
    assert TR.default_train_backend("cpu") == "torch"
    case = stream_case(np.random.default_rng(1), 0)
    t = {k: torch.from_numpy(case[k]) for k in ("starts", "counts", "cot")}
    data = TPC.assemble_stream_data(torch.from_numpy(case["ids"]),
                                    *(torch.from_numpy(x)
                                      for x in case["feats"]))
    blk_off, row_tile, n_rows = TPB.block_rows(t["starts"], t["counts"], 128,
                                               case["pc"])
    kw = dict(tiles_x=2, tile_px=16, chunk=128)
    with pytest.raises(ValueError, match="cot must be"):
        TPB.pairs_pass1(data, t["starts"], t["counts"], blk_off, n_rows,
                        t["cot"][:, :4].contiguous(), **kw)
    with pytest.raises(ValueError, match="must be a contiguous torch.int32"):
        TPB.pairs_pass1(data, t["starts"].long(), t["counts"], blk_off,
                        n_rows, t["cot"], **kw)


def port_stream(case, tile_px, chunk):
    """The port's stream tensors and row layout of a ``stream_case``."""
    t = {k: torch.from_numpy(case[k]) for k in ("ids", "starts", "counts",
                                                "cot")}
    feats = [torch.from_numpy(x) for x in case["feats"]]
    data = TPC.assemble_stream_data(t["ids"], *feats)
    blk_off, row_tile, n_rows = TPB.block_rows(t["starts"], t["counts"],
                                               chunk, data.shape[1])
    kw = dict(tiles_x=case["tiles_x"], tile_px=tile_px, chunk=chunk)
    return t, feats, data, blk_off, row_tile, n_rows, kw


def jax_pass1_boundary_t(case, chunk=128, max_per_tile=384):
    """`_pass1_kernel` in interpret mode, called as `_stream_backward` calls
    it (pallas_backward.py:246-281) → boundary T [T, bpt, P]."""
    m, c, r, d, o = case["feats"]
    feat = np.zeros((JPC.FEAT, case["n"]), np.float32)
    feat[:10] = np.stack([m[:, 0], m[:, 1], c[:, 0], c[:, 1], c[:, 2], o,
                          r[:, 0], r[:, 1], r[:, 2], d])
    p, num_tiles = 256, 4
    max_blk = case["pc"] // chunk - 1
    bpt = -(-max_per_tile // chunk) + 1
    bpt8 = -(-bpt // 8) * 8
    starts = jnp.asarray(case["starts"])
    data = jnp.asarray(feat)[:, jnp.asarray(case["ids"])]
    startblk = (starts // chunk).astype(jnp.int32)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3, grid=(num_tiles, bpt),
        in_specs=[
            pl.BlockSpec((JPC.FEAT, chunk),
                         lambda t, k, s, c, sb: (0, jnp.minimum(sb[t] + k,
                                                                max_blk))),
            pl.BlockSpec((1, 5, p), lambda t, k, *_: (t, 0, 0))],
        out_specs=(pl.BlockSpec((1, 8, p), lambda t, k, *_: (t, k // 8, 0)),
                   pl.BlockSpec((1, 8, p), lambda t, k, *_: (t, k // 8, 0))),
        scratch_shapes=[pltpu.VMEM((1, p), jnp.float32)])
    boundary_t, _ = pl.pallas_call(
        functools.partial(JPB._pass1_kernel, tile_px=16,
                          tiles_x=case["tiles_x"], chunk=chunk,
                          max_blk=max_blk),
        grid_spec=grid_spec,
        out_shape=(jax.ShapeDtypeStruct((num_tiles, bpt8, p), jnp.float32),
                   jax.ShapeDtypeStruct((num_tiles, bpt8, p), jnp.float32)),
        interpret=True,
    )(starts, jnp.asarray(case["counts"]), startblk, data,
      jnp.asarray(case["cot"]))
    return np.asarray(boundary_t)[:, :bpt]


def test_forward_boundary_t_matches_pass1_and_pallas():
    """The boundary T that the plain forward stores for the backward equals
    pass1_reference's and, within 2e-4, the JAX `_pass1_kernel`'s, on a
    stream that runs one block past the last tile (on a shorter one the JAX
    kernel re-runs the last block, ROADMAP.md §3)."""
    case = pad_to_blocks(stream_case(np.random.default_rng(5), 0), 128, 1)
    t, _, data, blk_off, row_tile, n_rows, kw = port_stream(case, 16, 128)
    out, bt = TPC.composite_pairs_stream(
        data, t["starts"], t["counts"], boundary_rows=(blk_off, n_rows), **kw)
    assert torch.equal(out, TPC.composite_pairs_stream(
        data, t["starts"], t["counts"], **kw))
    bt_p1, _ = TPB.pass1_reference(data, t["starts"], t["counts"], blk_off,
                                   n_rows, t["cot"], **kw)
    assert torch.equal(bt, bt_p1)
    assert float(bt[row_tile == 4].abs().max()) == 0.0  # rows not in use
    bt_jax = jax_pass1_boundary_t(case)
    nblk = np.bincount(row_tile.numpy(), minlength=5)[:4]
    assert nblk.max() >= 2 and float(bt.min()) < 0.5  # real boundaries
    for tile in range(4):
        for k in range(nblk[tile]):
            np.testing.assert_allclose(
                bt[int(blk_off[tile]) + k].numpy(), bt_jax[tile, k],
                atol=2e-4, rtol=0, err_msg=f"tile {tile} block {k}")


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("tile_px", [8, 16])
def test_pass1_routes_agree(tile_px, chunk):
    """pairs_pass1 with the forward's boundary T handed over (row totals
    from each row's boundary T, then the suffix over a tile's rows) against
    the route without (pass1_reference's serial walk)."""
    case = stream_case(np.random.default_rng(7), 3)
    t, _, data, blk_off, row_tile, n_rows, kw = port_stream(case, tile_px,
                                                            chunk)
    cot = t["cot"][:, :, :tile_px * tile_px].contiguous()
    base = (data, t["starts"], t["counts"], blk_off, n_rows, cot)
    bt_walk, suf_walk = TPB.pairs_pass1(*base, **kw)
    _, bt = TPC.composite_pairs_stream(
        data, t["starts"], t["counts"], boundary_rows=(blk_off, n_rows), **kw)
    before = dict(TPC.launch_counts)
    bt_rows, suf_rows = TPB.pairs_pass1(*base, boundary_t=bt,
                                        row_tile=row_tile, **kw)
    assert TPC.launch_counts == before
    assert bt_rows is bt and torch.equal(bt, bt_walk)
    scale = float(suf_walk.abs().max())
    assert scale > 1e-2
    np.testing.assert_allclose(suf_rows.numpy(), suf_walk.numpy(),
                               atol=2e-3 * scale + 1e-7, rtol=0)
    # the suffix of a tile's last row is that row's total
    totals = TPB.pairs_row_totals(data, t["starts"], t["counts"], blk_off,
                                  row_tile, cot, bt, **kw)
    last = int(blk_off[3]) + int((row_tile == 3).sum()) - 1
    assert torch.equal(suf_rows[last], totals[last])
    with pytest.raises(ValueError, match=r"boundary_t must be \[R, P\]"):
        TPB.pairs_row_totals(data, t["starts"], t["counts"], blk_off,
                             row_tile, cot, bt[:-1], **kw)


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("tile_px", [8, 16])
def test_stream_composite_matches_autograd_of_plain_forward(tile_px, chunk):
    """The Function (forward hands boundary T over, backward = row totals,
    suffix, pass 2, fold) against torch autograd through the plain forward,
    for every input field, with a cotangent on colour, depth and final T."""
    rng = np.random.default_rng(8)
    case = stream_case(rng, 3)
    t, feats, _, _, _, _, _ = port_stream(case, tile_px, chunk)
    side = 2 * tile_px
    geom = dict(height=side, width=side, tiles_x=2, tiles_y=2,
                tile_px=tile_px, chunk=chunk)
    # means drawn for a 32-pixel image: keep them on the smaller one too
    feats[0] = feats[0] * (side / 32.0)
    wt = torch.from_numpy(rng.normal(size=(side, side, 5)).astype(np.float32))
    res = []
    for through_function in (True, False):
        leaves = [x.clone().requires_grad_(True) for x in feats]
        if through_function:
            col, dep, tfin = TPB.stream_composite(
                *leaves, t["ids"], t["starts"], t["counts"], **geom)
        else:
            col, dep, tfin = TPC.composite_pairs(
                t["ids"], t["starts"], t["counts"], *leaves,
                bg=torch.zeros(3), use_kernel=False, **geom)
        loss = ((col * wt[..., :3]).sum() + (dep * wt[..., 3]).sum()
                + (tfin * wt[..., 4]).sum())
        res.append(torch.autograd.grad(loss, leaves))
    assert float(res[1][0].abs().max()) > 1e-3  # a real gradient
    assert_grads_close([g.numpy() for g in res[0]],
                       [g.numpy() for g in res[1]],
                       ("mean2d", "conic", "rgb", "depth", "opacity"),
                       f"tile {tile_px} chunk {chunk}")


def fold_case(seed):
    """Per-pair gradients over five decades on a stream of random ids that
    no binning made (a third of the 60 Gaussians get no pair), and a
    reordering of the stream that keeps each Gaussian's pairs in their
    order: a shuffle of the ids, each Gaussian's pairs placed in order at
    the places its id went to."""
    rng = np.random.default_rng(seed)
    n, pc = 60, 700
    ids = rng.integers(0, 40, size=pc).astype(np.int32)
    g = (rng.normal(size=(10, pc))
         * 10.0 ** rng.uniform(-2, 3, size=(1, pc))).astype(np.float32)
    shuffled = rng.permutation(ids)
    moved = np.empty_like(g)
    for gid in np.unique(ids):
        moved[:, shuffled == gid] = g[:, ids == gid]
    return n, torch.from_numpy(ids), torch.from_numpy(g), \
        torch.from_numpy(shuffled), torch.from_numpy(moved)


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_ordered_fold_matches_index_add(case):
    """The fold kernels' plain version (``fold_reference``: the binning's
    sort inverted, each Gaussian's emission slots added in order from 0)
    against ``index_add_`` over the stream's ids, which on the CPU adds
    serially in stream order: bit for bit, on streams of
    ``bin_gaussians_pairs`` with and without culling, with tier 2
    overflowing and its slots spilling, shifted to other block offsets, cut
    by max_pairs and by max_per_tile. The wrapper's CPU path is that
    ``index_add_``."""
    ids, starts, counts, g, layout, n, pb = binned_fold_case(
        3, **FOLD_CASES[case])
    parts = pb.spill_parts.tolist()  # slot, cap, tile, stream
    tier2 = int((pb.tier2_ids < n).sum())
    assert tier2 > 0 and layout.shift == FOLD_CASES[case].get("shift", 0)
    if case == "tier2_spill":
        assert parts[0] > 0 and parts[1] > 0
        assert tier2 == pb.tier2_ids.shape[0] == 16
    if case in ("max_pairs", "max_per_tile"):
        assert parts[3 if case == "max_pairs" else 2] > 0
    used = (starts + counts).max()
    want = torch.zeros(10, n).index_add_(1, ids.long(), g)
    got = TPB.fold_reference(g, layout, used)
    assert torch.equal(got, want)
    assert torch.equal(TPB.fold_to_gaussians(g, ids, n, used, layout=layout),
                       want)
    assert float(want.abs().max()) > 0
    # the order is the stream's: the same pairs added last to first part
    backwards = torch.zeros(10, n).index_add_(1, ids.flip(0).long(),
                                              g.flip(1))
    assert not torch.equal(backwards, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_ordered_fold_of_an_unbinned_stream(seed):
    """``ids_layout`` gives a stream that no binning made a layout (every
    Gaussian in tier 1, its pairs in stream order): the plain fold over it
    equals ``index_add_`` bit for bit, also with the zero-gradient tail past
    ``used`` left out, and on a reordering that keeps each Gaussian's pairs
    in order. The wrapper checks what it is given."""
    n, ids, g, shuffled, moved = fold_case(seed)
    want = torch.zeros(10, n).index_add_(1, ids.long(), g)
    layout = TPB.ids_layout(ids, n)
    m1 = layout.emission[1]
    assert layout.perm.shape == (n * m1,) and layout.shift == 0
    assert torch.equal(torch.sort(layout.perm).values, torch.arange(n * m1))
    assert layout.tier2_ids.shape == (0,)
    whole = torch.tensor(ids.numel(), dtype=torch.int32)
    got = TPB.fold_reference(g, layout, whole)
    assert torch.equal(got, want)
    assert torch.equal(TPB.fold_to_gaussians(g, ids, n), want)
    assert float(got[:, 40:].abs().max()) == 0.0  # Gaussians with no pair
    again = TPB.fold_reference(moved, TPB.ids_layout(shuffled, n), whole)
    assert torch.equal(again, got)
    ids[600:], g[:, 600:] = 0, 0.0
    used = torch.tensor(600, dtype=torch.int32)
    want = torch.zeros(10, n).index_add_(1, ids.long(), g)
    assert torch.equal(TPB.fold_reference(g, TPB.ids_layout(ids, n), used),
                       want)
    assert torch.equal(TPB.fold_to_gaussians(g, ids, n, used), want)
    with pytest.raises(ValueError, match="contiguous torch.float32"):
        TPB.fold_to_gaussians(g.double(), ids, n)
    with pytest.raises(ValueError, match=r"pair_ids \[Pc\]"):
        TPB.fold_to_gaussians(g, ids[:-1], n)
