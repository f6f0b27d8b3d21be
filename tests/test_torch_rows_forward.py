"""The forward pair-stream compositing split into a row pass and a per-tile
combine (the plain versions of the two kernels K1 and its log-space arm K5
are made of): ``rows_combine_reference(rows_forward_reference(...))``
against the plain version of the whole forward, against the JAX package's
Pallas pair-stream kernel in interpret mode, on the block-boundary fixture
and on a saturation fixture where every case of the combine fires. The
kernels' own cases are in test_torch_kernel.py (marked ``gpu``).

Tolerances: against the plain forward final T and boundary T exactly (K1's
form: the split decides every pair on the walk's own operands) and colour
1e-6, depth 1e-5 (T is multiplied into a row's sum once, not into every
term); the log-space form's T within 1e-7 (expf is not monotone, the
combine takes the last prefix where the plain version takes the least);
against the Pallas kernel colour 1e-4, depth 1e-3, T 2e-4, as
tests/test_pallas.py holds the JAX package's own kernels.

The CPU tests run single-threaded: with several threads PyTorch's CPU exp
can round an element differently depending on where the element falls in
a thread's share of the tensor, and the two versions lay their tensors out
differently (rows against tiles)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.ops import pallas_composite as JPC
from dge_tpu_torch.ops import composite as TCMP
from dge_tpu_torch.ops import cuda_build as CB
from dge_tpu_torch.ops import pairs_composite as TPC
from dge_tpu_torch.tools import proto_logdot as TLD
from tests.test_torch_kernel import random_stream
from tests.test_torch_ops import boundary_stream


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_case(seed, tile_px, chunk, num_tiles=6, tail=None):
    """A random stream as the port's tensors, with its row layout."""
    rng = np.random.default_rng(seed)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(
        rng, num_tiles, tile_px, tail=chunk + 5 if tail is None else tail)
    data = TPC.assemble_stream_data(*(torch.from_numpy(x)
                                      for x in (ids, m, c, r, d, o)))
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    blk_off, row_tile, n_rows = TPC.block_rows(st, ct, chunk, data.shape[1])
    return dict(data=data, st=st, ct=ct, blk_off=blk_off, row_tile=row_tile,
                n_rows=n_rows, num_tiles=num_tiles,
                kw=dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk),
                numpy=(ids, starts, counts, m, c, r, d, o))


def split(k, log_space=False):
    """The row pass then the combine → (out, boundary_T, scratch, mask)."""
    scratch, mask = TPC.rows_forward_reference(k["data"], k["st"], k["ct"],
                                               k["blk_off"], k["row_tile"],
                                               log_space=log_space, **k["kw"])
    out, bt = TPC.rows_combine_reference(scratch, mask, k["data"], k["st"],
                                         k["ct"], k["blk_off"],
                                         log_space=log_space, boundary=True,
                                         **k["kw"])
    return out, bt, scratch, mask


def whole(k, log_space=False):
    return TPC.composite_pairs_reference(
        k["data"], k["st"], k["ct"], log_prefix=log_space,
        boundary_rows=(k["blk_off"], k["n_rows"]), **k["kw"])


@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("tile_px", [8, 16])
def test_split_matches_plain_forward(tile_px, chunk, log_space):
    k = port_case(3, tile_px, chunk)
    out, bt, scratch, mask = split(k, log_space)
    want, bt_want = whole(k, log_space)
    used = k["row_tile"] < k["num_tiles"]
    # every pixel's first kept pair is in its group's keep mask
    j0 = scratch[used, 2].long()  # [U, P]
    words = mask[used][:, TPC.pixel_groups(tile_px ** 2)]  # [U, P, W]
    word = words.gather(2, (j0 // 32).clamp(max=words.shape[2] - 1)[..., None])
    has = (word[..., 0] >> (j0 % 32)) & 1
    kept = scratch[used, 1] < 1.0  # cp_first: some pair kept
    assert bool(kept.any()) and bool((has[kept] == 1).all())
    if log_space:
        assert float((out[:, 4] - want[:, 4]).abs().max()) <= 1e-7
        assert float((bt[used] - bt_want[used]).abs().max()) <= 1e-7
    else:
        assert torch.equal(out[:, 4], want[:, 4])
        assert torch.equal(bt[used], bt_want[used])
    assert float((out[:, 0:3] - want[:, 0:3]).abs().max()) <= 1e-6
    assert float((out[:, 3] - want[:, 3]).abs().max()) <= 1e-5
    assert float(want[:, 4].min()) < 2e-4  # some pixels saturate
    cases = TPC.combine_cases(scratch, bt, k["row_tile"], k["num_tiles"],
                              log_space=log_space)
    assert cases["all"] > 0 and cases["walk"] > 0, cases
    assert sum(cases.values()) == int(used.sum()) * tile_px ** 2


@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("chunk", [128, 256])
def test_split_matches_pallas(chunk, log_space):
    """Against the JAX pair-stream kernel in interpret mode on a stream that
    runs a block past the last tile's range (the Pallas wrapper re-runs the
    stream's last block for a tile whose range reaches it; the port visits
    each block once, so the tail keeps every range off that block)."""
    tile_px, num_tiles = 16, 6
    k = port_case(7, tile_px, chunk, num_tiles)
    ids, starts, counts, m, c, r, d, o = k["numpy"]
    tiles_x = k["kw"]["tiles_x"]
    geom = dict(height=(num_tiles // tiles_x) * tile_px,
                width=tiles_x * tile_px, tiles_x=tiles_x,
                tiles_y=num_tiles // tiles_x, tile_px=tile_px)
    ref = JPC.composite_pairs_pallas(
        *(jnp.asarray(x) for x in (ids, starts, counts, m, c, r, d, o)),
        bg=jnp.zeros(3), max_per_tile=512, chunk=chunk, **geom)
    out, _, _, _ = split(k, log_space)
    got = TCMP.tiles_to_image(out, torch.zeros(3), **geom)
    for g, want, tol in zip(got, ref, (1e-4, 1e-3, 2e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=tol)
    if log_space:
        plain = TLD.composite_pairs_logdot_reference(k["data"], k["st"],
                                                     k["ct"], **k["kw"])
        for rows, tol in ((slice(0, 3), 1e-6), (slice(3, 4), 1e-5),
                          (slice(4, 5), 1e-7)):
            assert float((out[:, rows] - plain[:, rows]).abs().max()) <= tol


def fixture_case(feat, counts, tile_px=16, chunk=128):
    """A hand-made stream [10, Pc] over one tile per count."""
    data = feat.contiguous()
    ct = torch.tensor(counts, dtype=torch.int32)
    st = torch.cumsum(ct, 0, dtype=torch.int32) - ct
    blk_off, row_tile, n_rows = TPC.block_rows(st, ct, chunk, data.shape[1])
    return dict(data=data, st=st, ct=ct, blk_off=blk_off, row_tile=row_tile,
                n_rows=n_rows, num_tiles=len(counts),
                kw=dict(tiles_x=len(counts), tile_px=tile_px, chunk=chunk))


def test_block_boundary_fixture():
    """The split keeps the block rule: slot 2 (alpha 0.99) is refused at T =
    0.005 and slot 128 (0.5) in the next block applied again: colour 0.9975,
    T 0.0025 (a hard per-pixel break would stop at 0.995, 0.005)."""
    f = boundary_stream(total=384)
    data = TPC.assemble_stream_data(*(torch.from_numpy(f[x]) for x in (
        "ids", "mean2d", "conic", "rgb", "depth", "opac")))
    k = fixture_case(data, [129])
    out, bt, scratch, mask = split(k)
    np.testing.assert_allclose(out[0, 0].numpy(), 0.9975, atol=1e-6)
    np.testing.assert_allclose(out[0, 4].numpy(), 0.0025, atol=1e-7)
    assert torch.equal(out[:, 4], whole(k)[0][:, 4])
    np.testing.assert_allclose(bt[1].numpy(), 0.005, atol=1e-7)
    # the first row walks again from T = 1: its prefix falls below 1e-4
    assert float(scratch[0, 0].max()) < 1e-4
    assert float(scratch[0, 2].max()) == 0.0  # j0
    # keep mask: row 0 keeps pairs 0-2 (the third stops every pixel),
    # row 1 its first pair, in every group of 32 pixels
    assert mask.shape == (k["n_rows"], 8, 4)
    assert bool((mask[0, :, 0] == 0b111).all())
    assert bool((mask[1, :, 0] == 1).all())
    assert int(mask[:2, :, 1:].abs().sum()) == 0


def saturation_stream():
    """One 16x16 tile, chunk 128, every pair covering the tile with one
    alpha (conic 0): row 0 one pair 0.5 (all applied: T 0.5), row 1 five
    pairs 0.9 (entered at 0.5: three applied, the fourth refused: walked),
    row 2 a pair 0.99 (entered at 5e-4: refused at once: none), row 3 two
    transparent pairs then 0.5 (all applied), row 4 opacity 0 only (no kept
    pair)."""
    rows = [[0.5], [0.9] * 5, [0.99], [0.0, 0.0, 0.5], [0.0]]
    total = 128 * len(rows)
    feat = torch.zeros(10, total)
    feat[0:2] = 8.0
    feat[6] = 1.0  # red
    feat[9] = 2.0  # depth
    for r, ops in enumerate(rows):
        feat[5, 128 * r:128 * r + len(ops)] = torch.tensor(ops)
        feat[7, 128 * r:128 * r + len(ops)] = 0.1 * (r + 1)  # green per row
    return fixture_case(feat, [total])


@pytest.mark.parametrize("log_space", [False, True])
def test_saturation_fixture_hits_every_case(log_space):
    k = saturation_stream()
    out, bt, scratch, _ = split(k, log_space)
    want, bt_want = whole(k, log_space)
    assert float((out - want).abs().max()) <= 1e-6
    assert float((bt - bt_want).abs().max()) <= 1e-7
    cases = TPC.combine_cases(scratch, bt, k["row_tile"], 1,
                              log_space=log_space)
    assert cases == {"empty": 256, "all": 512, "none": 256, "walk": 256}
    np.testing.assert_allclose(bt[:5, 0].numpy(),
                               [1.0, 0.5, 5e-4, 5e-4, 2.5e-4], rtol=1e-5)


@pytest.mark.parametrize("tile_px", [8, 16, 32])
def test_mask_groups_are_32_pixels_of_the_row_kernels_threads(tile_px):
    """Each keep-mask group holds 32 pixels (fewer where the tile ends),
    those of eight threads of one row-kernel warp (four pixels a thread);
    in a tile 32 pixels wide a group is an 8x4 patch."""
    p = tile_px ** 2
    groups = TPC.pixel_groups(p)
    n_groups = TPC.mask_shape(1, tile_px, 128)[1]
    assert int(groups.max()) < n_groups
    sizes = torch.bincount(groups, minlength=n_groups)
    assert int(sizes.sum()) == p
    assert bool((sizes == (32 if p >= 128 else p // 4)).all())
    thread = torch.arange(p) // 4
    for g in range(n_groups):
        members = thread[groups == g].unique()
        assert bool((members // 32 == g // 4).all())  # one warp
        assert bool(((members % 8) // 2 == g % 4).all())
    if tile_px == 32:
        q = torch.nonzero(groups == 5).flatten()
        assert torch.equal(q % 32 // 8, torch.full_like(q, 1))  # x 8..15
        assert torch.equal(q // 32 // 4, torch.full_like(q, 1))  # y 4..7


def test_plain_split_carries_a_nan_colour():
    """A pair with a NaN colour that every pixel applies gives NaN red at
    every pixel, as in the plain forward; green stays finite."""
    feat = torch.zeros(10, 8)
    feat[0:2] = 8.0
    feat[5] = 0.3
    feat[6:9] = 0.5
    feat[9] = 1.0
    feat[6, 2] = float("nan")
    k = fixture_case(feat, [5])
    out, _, _, _ = split(k)
    want = whole(k)[0]
    assert torch.equal(out.isnan(), want.isnan())
    assert bool(out[0, 0].isnan().all()) and bool(out[0, 1].isfinite().all())


def test_row_wrappers_take_plain_versions_for_cpu_tensors():
    """On CPU tensors the two kernels' wrappers (both forms) run their plain
    versions and count no launch; they still check what they are given."""
    k = port_case(5, 16, 128)
    args = (k["data"], k["st"], k["ct"], k["blk_off"])
    before = dict(CB.launch_counts)
    assert set(before) == {"pairs_composite", "pairs_composite_combine",
                           "pairs_pass1", "pairs_suffix", "pairs_pass2",
                           "pairs_fold", "list_stream", "tiles_composite",
                           "pairs_logdot",
                           "pairs_logdot_combine", "binning_rects",
                           "binning_emit", "binning_ranges", "preprocess",
                           "reuse_match"}
    for log_space in (False, True):
        scratch, mask = TPC.rows_forward(*args, k["row_tile"],
                                         log_space=log_space, **k["kw"])
        assert scratch.shape == (k["n_rows"], 7 + log_space, 256)
        assert mask.shape == (k["n_rows"], 8, 4)
        want = TPC.rows_forward_reference(*args, k["row_tile"],
                                          log_space=log_space, **k["kw"])
        assert torch.equal(scratch, want[0]) and torch.equal(mask, want[1])
        out = TPC.rows_combine(scratch, mask, *args, log_space=log_space,
                               **k["kw"])
        assert torch.equal(out, TPC.rows_combine_reference(
            scratch, mask, *args, log_space=log_space, **k["kw"]))
        with pytest.raises(ValueError, match=r"scratch must be \[R, "):
            TPC.rows_combine(scratch, mask, *args, log_space=not log_space,
                             **k["kw"])
        with pytest.raises(ValueError, match=r"mask must be \[R, G, W\]"):
            TPC.rows_combine(scratch, mask[:, :4].contiguous(), *args,
                             log_space=log_space, **k["kw"])
    assert CB.launch_counts == before
    with pytest.raises(ValueError, match="must be a contiguous torch.int32"):
        TPC.rows_forward(k["data"], k["st"].long(), k["ct"], k["blk_off"],
                         k["row_tile"], **k["kw"])
    with pytest.raises(ValueError, match=r"must be \[10, Pc\]"):
        TPC.rows_forward(k["data"][:9].contiguous(), k["st"], k["ct"],
                         k["blk_off"], k["row_tile"], **k["kw"])
    with pytest.raises(ValueError, match=r"must be \[T\]"):
        TPC.rows_forward(k["data"], k["st"], k["ct"], k["blk_off"][:-1],
                         k["row_tile"], **k["kw"])


@pytest.mark.parametrize("log_space", [False, True])
def test_combine_times_cell_on_plain_versions(monkeypatch, log_space):
    """dge_tpu_torch/tools/combine_times.py's cell, its device times stubbed
    (they come from a profiler trace on the card): the fullest tile's and
    the mean tile's rows from the stream, the combine's cases over every
    (row, pixel) visit in use, and hashes of out and of the used rows of
    boundary_T that repeat and tell two outputs apart."""
    from dge_tpu_torch.tools import combine_times as CT

    k = port_case(7, CT.TILE_PX, 128)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(CT, "kernel_times", lambda fn, calls=20: {
        name: dict(ms=0.5, launches=1) for name in ("rows_forward_kernel",
                                                    "rows_combine_kernel")})
    inp = dict(data=k["data"], starts=k["st"], counts=k["ct"],
               tiles_x=k["kw"]["tiles_x"], pairs=int(k["ct"].sum()),
               chunk=128)
    a = CT.forward_cell(inp, log_space=log_space, boundary=True)
    b = CT.forward_cell(inp, log_space=log_space, boundary=True)
    used = k["row_tile"] < k["num_tiles"]
    rows = int(used.sum())
    tile_rows = torch.bincount(k["row_tile"][used].long(),
                               minlength=k["num_tiles"])
    assert a["rows"] == rows
    assert a["fullest_tile_rows"] == int(tile_rows.max())
    assert a["mean_tile_rows"] == pytest.approx(
        float(tile_rows[tile_rows > 0].float().mean()))
    assert sum(a["cases"].values()) == rows * CT.TILE_PX ** 2
    assert a["sum_device_ms"] == 1.0 and a["boundary_store"]
    out, bt, _, _ = split(k, log_space)
    assert a["out_sha256"] == b["out_sha256"] == CT.sha256(out)
    assert a["boundary_t_sha256"] == CT.sha256(bt[used])
    assert CT.sha256(out + 1) != a["out_sha256"]
    bound = CT.bounds(a["pairs"], k["num_tiles"], rows, 128, log_space, True)
    assert a["combine_bound_ms"] == bound["combine"] > 0
    assert a["whole_bound_ms"] == bound["whole"] <= bound["row"]


def test_combine_times_needs_a_card(monkeypatch, capsys):
    from dge_tpu_torch.tools import combine_times as CT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        CT.main([])
    assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err
