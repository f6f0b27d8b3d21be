"""The CUDA kernels of the PyTorch port (forward compositing over the pair
stream: its row kernel and its combine kernel, backward pass 1, suffix and
pass 2, forward compositing over per-tile lists, the log-space arm of the
stream kernel): their wrappers' checks on the CPU, and each kernel against
its plain version on a card (marked ``gpu``; skips without a card). This
file imports neither JAX nor the JAX package, so the card's machine runs it
without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

Tolerances: colour 1e-4, depth 1e-3, final T, boundary T and the forward's
prefix fields 2e-4 (f32 rounding: the kernels walk pairs one by one, the
plain versions use torch.cumprod; the forward row kernel's first kept pair
may differ in one visit in a thousand, where an alpha rounds across
1/255); row totals, suffix sums and gradients 2e-3·max + 1e-7 per field
(the pixel sums run in another order: four pixels a thread, a warp
butterfly, then the warps' partial sums in warp order)."""

import contextlib
import os
import re
import types

import numpy as np
import pytest
import torch

from dge_tpu_torch.ops import binning as TB
from dge_tpu_torch.ops import cuda_build as CB
from dge_tpu_torch.ops import pairs_composite as TPC


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def random_stream(rng, num_tiles, tile_px, tail):
    """Random per-tile pair ranges over a feature table; the stream runs
    ``tail`` pairs past the last tile's range (as the sentinel tail of a
    real binning does)."""
    counts = rng.integers(0, 300, size=num_tiles).astype(np.int32)
    counts[1] = 0  # an empty tile
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    pc = int(counts.sum()) + tail
    n = 80
    tiles_x = 2
    span = tile_px * tiles_x
    mean2d = rng.uniform(-4, span + 4, size=(n, 2)).astype(np.float32)
    scale = rng.uniform(0.05, 0.6, size=(n, 1)).astype(np.float32)
    conic = np.concatenate([scale, rng.uniform(-0.02, 0.02, size=(n, 1)),
                            scale * 0.7], 1).astype(np.float32)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    depth = rng.uniform(1, 5, size=n).astype(np.float32)
    opac = rng.uniform(0.05, 1.0, size=n).astype(np.float32)
    ids = rng.integers(0, n, size=pc).astype(np.int32)
    return ids, starts, counts, mean2d, conic, rgb, depth, opac, tiles_x


# the fold's cases: a plain binning; tight culling (tier 2 packs its kept
# tiles); small m2 and tier-2 capacity, so that tier 2 overflows into tier 1
# and slots spill (with culling); a stream shifted to other block offsets;
# the stream cut by max_pairs; tiles cut by max_per_tile
FOLD_CASES = {
    "plain": dict(),
    "cull": dict(cull=True),
    "tier2_spill": dict(cull=True, max_tiles_per_gaussian=8, big_capacity=16),
    "shifted": dict(shift=37),
    "max_pairs": dict(max_pairs=700),
    "max_per_tile": dict(max_per_tile=24),
}


def binned_fold_case(seed, device="cpu", *, cull=False, shift=0, **caps):
    """A pair stream from ``bin_gaussians_pairs`` (400 random Gaussians, a
    sixth of them wide, at 96x128 and tile 16) and per-pair gradients over
    five decades, some -0.0, as pass 2 leaves them: 0 at every position in
    no tile's range. ``shift`` puts that many unused positions before the
    stream, as ``render._shift_stream`` does. Returns (pair_ids, starts,
    counts, grads, layout, n, bins)."""
    rng = np.random.default_rng(seed)
    n, h, w = 400, 96, 128
    mean2d = rng.uniform(-16, 1, size=(n, 2)) + rng.uniform(
        size=(n, 2)) * [w + 32, h + 32]
    radius = np.where(rng.uniform(size=n) < 1 / 6, rng.uniform(20, 45, n),
                      rng.uniform(1, 12, n))
    sigma2 = (radius / 3.0) ** 2
    a = rng.uniform(0.6, 1.0, n) / sigma2
    c = rng.uniform(0.6, 1.0, n) / sigma2
    b = rng.uniform(-0.3, 0.3, n) * np.sqrt(a * c)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    cull_kw = dict(conic=t(np.stack([a, b, c], 1)),
                   opacity=t(rng.uniform(0.02, 1.0, n))) if cull else {}
    pb = TB.bin_gaussians_pairs(
        t(mean2d), t(rng.uniform(1, 10, n)), t(radius),
        t(rng.uniform(size=n) < 0.95, torch.bool), height=h, width=w,
        tile_px=16, **cull_kw, **caps)
    pc = pb.pair_ids.shape[0]
    pos = np.arange(pc)
    st, ct = pb.starts.cpu().numpy(), pb.counts.cpu().numpy()
    in_range = ((pos[:, None] >= st) & (pos[:, None] < st + ct)).any(1)
    g = np.where(in_range, rng.normal(size=(10, pc))
                 * 10.0 ** rng.uniform(-2, 3, size=(1, pc)), 0.0).astype(
                     np.float32)
    g[:, in_range & (rng.uniform(size=pc) < 0.05)] = -0.0
    ids, starts = pb.pair_ids, pb.starts
    if shift:
        ids = torch.cat([ids.new_zeros(shift), ids])
        starts = starts + shift
        g = np.concatenate([np.zeros((10, shift), np.float32), g], 1)
    return (ids, starts, pb.counts, t(g), pb.fold_layout(shift), n, pb)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    """On CPU tensors the kernel's wrapper runs the plain version and counts
    no launch; it still checks what it is given."""
    rng = np.random.default_rng(0)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(rng, 4, 16, 0)
    data = TPC.assemble_stream_data(*(torch.from_numpy(x)
                                      for x in (ids, m, c, r, d, o)))
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    kw = dict(tiles_x=tiles_x, tile_px=16, chunk=128)
    before = CB.launch_counts["pairs_composite"]
    got = TPC.composite_pairs_stream(data, st, ct, **kw)
    assert CB.launch_counts["pairs_composite"] == before
    assert torch.equal(got, TPC.composite_pairs_reference(data, st, ct, **kw))
    with pytest.raises(ValueError, match="must be a contiguous torch.int32"):
        TPC.composite_pairs_stream(data, st.long(), ct, **kw)
    with pytest.raises(ValueError, match=r"must be \[10, Pc\]"):
        TPC.composite_pairs_stream(data[:9].contiguous(), st, ct, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [128, 256])
def test_kernel_matches_plain_on_card(chunk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(1)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(
        rng, 8, 32, tail=3)
    dev = torch.device("cuda")
    data = TPC.assemble_stream_data(*(torch.from_numpy(x).to(dev)
                                      for x in (ids, m, c, r, d, o)))
    st = torch.from_numpy(starts).to(dev)
    ct = torch.from_numpy(counts).to(dev)
    kw = dict(tiles_x=tiles_x, tile_px=32, chunk=chunk)
    before = CB.launch_counts["pairs_composite"]
    got = TPC.composite_pairs_stream(data, st, ct, **kw)
    torch.cuda.synchronize()
    assert CB.launch_counts["pairs_composite"] == before + 1
    want = TPC.composite_pairs_reference(data, st, ct, **kw)
    err = (got - want).abs()
    assert float(err[:, 0:3].max()) <= 1e-4
    assert float(err[:, 3].max()) <= 1e-3
    assert float(err[:, 4].max()) <= 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [128, 256])
def test_backward_kernels_match_plain_on_card(chunk):
    """Pass 1 and pass 2 against their plain versions, and the whole
    Function's gradients against autograd through the plain forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dge_tpu_torch.ops import pairs_backward as TPB

    rng = np.random.default_rng(4)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(
        rng, 8, 32, tail=3)
    dev = torch.device("cuda")
    ids_t = torch.from_numpy(ids).to(dev)
    feats = [torch.from_numpy(x).to(dev) for x in (m, c, r, d, o)]
    data = TPC.assemble_stream_data(ids_t, *feats)
    st = torch.from_numpy(starts).to(dev)
    ct = torch.from_numpy(counts).to(dev)
    kw = dict(tiles_x=tiles_x, tile_px=32, chunk=chunk)
    cot = torch.from_numpy(
        rng.normal(size=(8, 5, 1024)).astype(np.float32)).to(dev)
    fwd = TPC.composite_pairs_stream(data, st, ct, **kw)
    blk_off, row_tile, n_rows = TPB.block_rows(st, ct, chunk, data.shape[1])
    before = dict(CB.launch_counts)
    bt, suf = TPB.pairs_pass1(data, st, ct, blk_off, n_rows, cot, **kw)
    grads = TPB.pairs_pass2(data, st, ct, blk_off, row_tile, cot, fwd, bt,
                            suf, **kw)
    torch.cuda.synchronize()
    assert CB.launch_counts["pairs_pass1"] == before["pairs_pass1"] + 1
    assert CB.launch_counts["pairs_pass2"] == before["pairs_pass2"] + 1
    bt_p, suf_p = TPB.pass1_reference(data, st, ct, blk_off, n_rows, cot, **kw)
    grads_p = TPB.pass2_reference(data, st, ct, blk_off, row_tile, cot, fwd,
                                  bt, suf, **kw)
    used = row_tile < 8
    assert float((bt[used] - bt_p[used]).abs().max()) <= 2e-4

    assert close(suf[used], suf_p[used])
    for f in range(10):
        assert close(grads[f], grads_p[f]), f
    # the Function: kernels in both directions against plain autograd
    geom = dict(height=32 * (8 // tiles_x), width=32 * tiles_x,
                tiles_x=tiles_x, tiles_y=8 // tiles_x, tile_px=32, chunk=chunk)
    wt = torch.from_numpy(rng.normal(size=(
        geom["height"], geom["width"], 5)).astype(np.float32)).to(dev)
    res = []
    for use_kernels in (True, False):
        leaves = [x.clone().requires_grad_(True) for x in feats]
        if use_kernels:
            col, dep, tfin = TPB.stream_composite(
                *leaves, ids_t, st, ct,
                layout=TPB.ids_layout(ids_t, len(m)), **geom)
        else:
            col, dep, tfin = TPC.composite_pairs(
                ids_t, st, ct, *leaves, bg=torch.zeros(3, device=dev),
                use_kernel=False, **geom)
        loss = ((col * wt[..., :3]).sum() + (dep * wt[..., 3]).sum()
                + (tfin * wt[..., 4]).sum())
        res.append(torch.autograd.grad(loss, leaves))
    for got, want in zip(*res):
        assert close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_kernel_matches_plain_on_card(case):
    """The layout and fold kernels on a binned stream against their plain
    version and against ``index_add_`` on a CPU copy, bit for bit; one
    launch counted; two launches give the same bits; a call without the
    binning's layout raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dge_tpu_torch.ops import pairs_backward as TPB

    ids, starts, counts, g, layout, n, _ = binned_fold_case(
        5, "cuda", **FOLD_CASES[case])
    used = (starts + counts).max()
    before = dict(CB.launch_counts)
    got = TPB.fold_to_gaussians(g, ids, n, used, layout=layout)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in CB.launch_counts.items()
            if v != before[k]} == {"pairs_fold": 1}
    assert torch.equal(got, TPB.fold_to_gaussians(g, ids, n, used,
                                                  layout=layout))
    assert torch.equal(got, TPB.fold_reference(g, layout, used))
    want = torch.zeros(10, n).index_add_(1, ids.cpu().long(), g.cpu())
    assert torch.equal(got.cpu(), want)
    assert float(got.abs().max()) > 0
    with pytest.raises(ValueError, match="needs the binning's layout"):
        TPB.fold_to_gaussians(g, ids, n, used)


def card_backward_case(seed, tile_px, chunk, num_tiles=8):
    """A random stream on the card with its row layout, a random cotangent
    and the forward kernel's output with the boundary T it stores."""
    from dge_tpu_torch.ops import pairs_backward as TPB

    rng = np.random.default_rng(seed)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(
        rng, num_tiles, tile_px, tail=3)
    dev = torch.device("cuda")
    data = TPC.assemble_stream_data(*(torch.from_numpy(x).to(dev)
                                      for x in (ids, m, c, r, d, o)))
    st = torch.from_numpy(starts).to(dev)
    ct = torch.from_numpy(counts).to(dev)
    kw = dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk)
    cot = torch.from_numpy(rng.normal(size=(
        num_tiles, 5, tile_px * tile_px)).astype(np.float32)).to(dev)
    blk_off, row_tile, n_rows = TPB.block_rows(st, ct, chunk, data.shape[1])
    fwd, bt = TPC.composite_pairs_stream(
        data, st, ct, boundary_rows=(blk_off, n_rows), **kw)
    return dict(data=data, st=st, ct=ct, kw=kw, cot=cot, blk_off=blk_off,
                row_tile=row_tile, n_rows=n_rows, fwd=fwd, bt=bt,
                used=row_tile < num_tiles)


def close(a, b):
    return float((a - b).abs().max()) <= 2e-3 * float(b.abs().max()) + 1e-7


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("tile_px", [8, 16, 32])
def test_row_kernels_match_plain_on_card(tile_px, chunk):
    """K1's stored boundary T, the pass-1 row kernel (boundary T handed
    over, and from K1's walk), the suffix kernel and pass 2 against their
    plain versions, at tiles of 2, 8 and 32 warps' worth of pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dge_tpu_torch.ops import pairs_backward as TPB

    k = card_backward_case(11, tile_px, chunk)
    base = (k["data"], k["st"], k["ct"], k["blk_off"])
    used, kw = k["used"], k["kw"]
    before = dict(CB.launch_counts)
    bt, suf = TPB.pairs_pass1(*base, k["n_rows"], k["cot"], boundary_t=k["bt"],
                              row_tile=k["row_tile"], **kw)
    torch.cuda.synchronize()
    assert CB.launch_counts["pairs_pass1"] == before["pairs_pass1"] + 1
    assert CB.launch_counts["pairs_suffix"] == before["pairs_suffix"] + 1
    assert CB.launch_counts["pairs_composite"] == before["pairs_composite"]
    bt_w, suf_w = TPB.pairs_pass1(*base, k["n_rows"], k["cot"], **kw)
    assert CB.launch_counts["pairs_composite"] == \
        before["pairs_composite"] + 1
    assert torch.equal(bt_w[used], bt[used])
    assert torch.equal(suf_w[used], suf[used])
    bt_p, suf_p = TPB.pass1_reference(*base, k["n_rows"], k["cot"], **kw)
    assert float((bt[used] - bt_p[used]).abs().max()) <= 2e-4
    assert close(suf[used], suf_p[used])
    totals = TPB.pairs_row_totals(*base, k["row_tile"], k["cot"], bt, **kw)
    assert close(totals[used], TPB.row_totals_reference(
        *base, k["row_tile"], k["cot"], bt, **kw)[used])
    assert close(suf[used], TPB.suffix_reference(
        totals, k["st"], k["ct"], k["blk_off"], chunk=chunk)[used])
    grads = TPB.pairs_pass2(*base, k["row_tile"], k["cot"], k["fwd"], bt, suf,
                            **kw)
    torch.cuda.synchronize()
    assert CB.launch_counts["pairs_pass2"] == before["pairs_pass2"] + 1
    grads_p = TPB.pass2_reference(*base, k["row_tile"], k["cot"], k["fwd"],
                                  bt, suf, **kw)
    for f in range(10):
        assert close(grads[f], grads_p[f]), f


@pytest.mark.gpu
def test_pass2_repeats_bit_for_bit_on_card():
    """Two launches of pass 2 on the same inputs give the same bits (no
    atomics: each warp's sums go to its own slot, added in warp order), and
    so do two launches of pass 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dge_tpu_torch.ops import pairs_backward as TPB

    k = card_backward_case(12, 32, 128)
    base = (k["data"], k["st"], k["ct"], k["blk_off"])
    _, suf = TPB.pairs_pass1(*base, k["n_rows"], k["cot"], boundary_t=k["bt"],
                             row_tile=k["row_tile"], **k["kw"])
    args = base + (k["row_tile"], k["cot"], k["fwd"], k["bt"], suf)
    first = TPB.pairs_pass2(*args, **k["kw"])
    again = TPB.pairs_pass2(*args, **k["kw"])
    assert float(first.abs().max()) > 0
    assert torch.equal(first, again)
    _, suf_again = TPB.pairs_pass1(*base, k["n_rows"], k["cot"],
                                   boundary_t=k["bt"], row_tile=k["row_tile"],
                                   **k["kw"])
    assert torch.equal(suf_again[k["used"]], suf[k["used"]])


def nan_colour_case(dev):
    """One 16x16 tile under five wide pairs (alpha 0.28-0.3 at every pixel),
    the third with a NaN colour; pass 1 and pass 2 through the wrappers and
    through the plain versions."""
    from dge_tpu_torch.ops import pairs_backward as TPB

    feat = torch.zeros(10, 8)
    feat[0:2] = 8.0
    feat[2] = feat[4] = 1e-3
    feat[5] = 0.3
    feat[6:9] = 0.5
    feat[9] = 1.0
    feat[6, 2] = float("nan")
    data = feat.to(dev).contiguous()
    st = torch.zeros(1, dtype=torch.int32, device=dev)
    ct = torch.full((1,), 5, dtype=torch.int32, device=dev)
    kw = dict(tiles_x=1, tile_px=16, chunk=128)
    cot = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, 5, 256)).astype(np.float32)).to(dev)
    blk_off, row_tile, n_rows = TPB.block_rows(st, ct, 128, 8)
    fwd, bt = TPC.composite_pairs_stream(
        data, st, ct, boundary_rows=(blk_off, n_rows), **kw)
    base = (data, st, ct, blk_off)
    _, suf = TPB.pairs_pass1(*base, n_rows, cot, boundary_t=bt,
                             row_tile=row_tile, **kw)
    grads = TPB.pairs_pass2(*base, row_tile, cot, fwd, bt, suf, **kw)
    totals_p = TPB.row_totals_reference(*base, row_tile, cot, bt, **kw)
    grads_p = TPB.pass2_reference(*base, row_tile, cot, fwd, bt, suf, **kw)
    return suf[:1], grads[:, :5], totals_p[:1], grads_p[:, :5]


def test_plain_backward_carries_a_nan_colour():
    """A NaN colour is no reason to drop a pair: the plain versions carry it
    into the row's total at every pixel and into the mean, conic and opacity
    gradients of every pair of the row, and leave the colour and depth
    gradients (weights times cotangent) finite."""
    _, _, totals_p, grads_p = nan_colour_case(torch.device("cpu"))
    assert bool(totals_p.isnan().all())
    assert bool(grads_p[:6].isnan().all())
    assert bool(grads_p[6:].isfinite().all())
    assert float(grads_p[6:].abs().min()) > 0


@pytest.mark.gpu
def test_row_kernels_carry_a_nan_colour_on_card():
    """The kernels give NaN exactly where the plain versions do (the warp
    reject compares against a radius, and no comparison with a NaN holds, so
    it drops no such pair) and agree on the finite rest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    suf, grads, totals_p, grads_p = nan_colour_case(torch.device("cuda"))
    assert torch.equal(suf.isnan(), totals_p.isnan())
    assert torch.equal(grads.isnan(), grads_p.isnan())
    assert bool(grads[:6].isnan().all())
    assert close(grads[6:], grads_p[6:])


@pytest.mark.gpu
def test_refused_launch_raises_on_card(monkeypatch):
    """Chunk 512 needs 184 KB of dynamic shared memory and runs; a chunk
    whose slots exceed what an SM has is refused by the card, and the
    wrapper raises instead of returning unwritten gradients; the next
    launch is unharmed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from dge_tpu_torch.ops import pairs_backward as TPB

    k = card_backward_case(13, 32, 512)
    base = (k["data"], k["st"], k["ct"], k["blk_off"])
    _, suf = TPB.pairs_pass1(*base, k["n_rows"], k["cot"], boundary_t=k["bt"],
                             row_tile=k["row_tile"], **k["kw"])
    args = base + (k["row_tile"], k["cot"], k["fwd"], k["bt"], suf)
    grads = TPB.pairs_pass2(*args, **k["kw"])
    want = TPB.pass2_reference(*args, **k["kw"])
    for f in range(10):
        assert close(grads[f], want[f]), f
    with pytest.raises(ValueError, match="chunk 1024 outside"):
        TPB.pairs_pass2(*args, **dict(k["kw"], chunk=1024))
    monkeypatch.setattr(TPB, "MAX_CHUNK", 1024)
    before = CB.launch_counts["pairs_pass2"]
    with pytest.raises(RuntimeError, match="pairs_pass2 launch failed"):
        TPB.pairs_pass2(*args, **dict(k["kw"], chunk=1024))
    assert CB.launch_counts["pairs_pass2"] == before
    assert torch.equal(TPB.pairs_pass2(*args, **k["kw"]), grads)


def card_forward_case(seed, tile_px, chunk, num_tiles=8):
    """A random stream on the card with its row layout."""
    rng = np.random.default_rng(seed)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(
        rng, num_tiles, tile_px, tail=3)
    dev = torch.device("cuda")
    data = TPC.assemble_stream_data(*(torch.from_numpy(x).to(dev)
                                      for x in (ids, m, c, r, d, o)))
    st = torch.from_numpy(starts).to(dev)
    ct = torch.from_numpy(counts).to(dev)
    blk_off, row_tile, n_rows = TPC.block_rows(st, ct, chunk, data.shape[1])
    return dict(args=(data, st, ct, blk_off), row_tile=row_tile,
                n_rows=n_rows, used=row_tile < num_tiles,
                kw=dict(tiles_x=tiles_x, tile_px=tile_px, chunk=chunk))


def assert_forward_close(got, want):
    err = (got - want).abs()
    assert float(err[:, 0:3].max()) <= 1e-4
    assert float(err[:, 3].max()) <= 1e-3
    assert float(err[:, 4].max()) <= 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("chunk", [128, 256, 512])
@pytest.mark.parametrize("tile_px", [8, 16, 32])
def test_forward_row_and_combine_kernels_match_plain_on_card(
        tile_px, chunk, log_space):
    """K1's (K5's) row kernel and combine kernel each against its plain
    version: the scratch field by field (L where it is read: a prefix of at
    least 1e-4 in both) and the keep mask, the combine on the kernel's
    scratch and mask, boundary T;
    two launches of each give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    k = card_forward_case(21, tile_px, chunk)
    kw = dict(k["kw"], log_space=log_space)
    used = k["used"]
    keys = ("pairs_logdot", "pairs_logdot_combine") if log_space else (
        "pairs_composite", "pairs_composite_combine")
    before = dict(CB.launch_counts)
    scratch, mask = TPC.rows_forward(*k["args"], k["row_tile"], **kw)
    out, bt = TPC.rows_combine(scratch, mask, *k["args"], boundary=True, **kw)
    torch.cuda.synchronize()
    assert CB.launch_counts[keys[0]] == before[keys[0]] + 1
    assert CB.launch_counts[keys[1]] == before[keys[1]] + 1
    want, want_mask = TPC.rows_forward_reference(*k["args"], k["row_tile"],
                                                 **kw)
    assert float((mask[used] != want_mask[used]).float().mean()) <= 1e-3
    got, want = scratch[used], want[used]
    read = (got[:, 0] >= 1e-4) & (want[:, 0] >= 1e-4)
    assert float((got[:, 0:2] - want[:, 0:2]).abs().max()) <= 2e-4
    assert float((got[:, 2] != want[:, 2]).float().mean()) <= 1e-3  # j0
    for f, tol in ((3, 1e-4), (4, 1e-4), (5, 1e-4), (6, 1e-3)):
        assert float((got[:, f] - want[:, f])[read].abs().max()) <= tol
    out_p, bt_p = TPC.rows_combine_reference(scratch, mask, *k["args"],
                                             boundary=True, **kw)
    assert_forward_close(out, out_p)
    assert float((bt[used] - bt_p[used]).abs().max()) <= 2e-4
    whole = TPC.composite_pairs_reference(*k["args"][:3], log_prefix=log_space,
                                          **k["kw"])
    assert_forward_close(out, whole)
    s2, m2 = TPC.rows_forward(*k["args"], k["row_tile"], **kw)
    assert torch.equal(s2[used], scratch[used])
    assert torch.equal(m2[used], mask[used])
    again, bt_again = TPC.rows_combine(scratch, mask, *k["args"],
                                       boundary=True, **kw)
    assert torch.equal(again, out) and torch.equal(bt_again[used], bt[used])


@pytest.mark.gpu
def test_forward_kernels_nan_saturation_and_refusal_on_card(monkeypatch):
    """A NaN colour gives NaN where the plain version has it; a saturating
    stream takes all three combine cases; a chunk whose row stage exceeds
    what a block may have is refused by the card and the wrapper raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    feat = torch.zeros(10, 8)
    feat[0:2] = 8.0
    feat[5] = 0.3
    feat[6:9] = 0.5
    feat[9] = 1.0
    feat[6, 2] = float("nan")
    st = torch.zeros(1, dtype=torch.int32, device=dev)
    ct = torch.full((1,), 5, dtype=torch.int32, device=dev)
    kw = dict(tiles_x=1, tile_px=16, chunk=128)
    got = TPC.composite_pairs_stream(feat.to(dev), st, ct, **kw)
    want = TPC.composite_pairs_reference(feat.to(dev), st, ct, **kw)
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(got[0, 0].isnan().all())
    assert_forward_close(got.nan_to_num(), want.nan_to_num())

    rows = [[0.5], [0.9] * 5, [0.99], [0.0, 0.0, 0.5], [0.0]]
    sat = torch.zeros(10, 128 * len(rows))
    sat[0:2] = 8.0
    sat[6] = 1.0
    sat[9] = 2.0
    for r, ops in enumerate(rows):
        sat[5, 128 * r:128 * r + len(ops)] = torch.tensor(ops)
    data = sat.to(dev).contiguous()
    ct = torch.full((1,), data.shape[1], dtype=torch.int32, device=dev)
    blk_off, row_tile, n_rows = TPC.block_rows(st, ct, 128, data.shape[1])
    scratch, mask = TPC.rows_forward(data, st, ct, blk_off, row_tile, **kw)
    out, bt = TPC.rows_combine(scratch, mask, data, st, ct, blk_off,
                               boundary=True, **kw)
    assert_forward_close(out, TPC.composite_pairs_reference(data, st, ct,
                                                            **kw))
    assert TPC.combine_cases(scratch, bt, row_tile, 1) == {
        "empty": 256, "all": 512, "none": 256, "walk": 256}

    monkeypatch.setattr(TPC, "MAX_CHUNK", 4096)
    before = CB.launch_counts["pairs_composite"]
    with pytest.raises(RuntimeError, match="pairs_rows_forward launch failed"):
        TPC.composite_pairs_stream(data, st, ct, **dict(kw, chunk=2048))
    assert CB.launch_counts["pairs_composite"] == before
    assert torch.equal(TPC.composite_pairs_stream(data, st, ct, **kw), out)


def random_lists(rng, num_tiles, k):
    """Random capped per-tile lists over the feature table of
    ``random_stream`` (an empty tile, a full one, garbage past the counts)."""
    counts = rng.integers(0, k, size=num_tiles).astype(np.int32)
    counts[1], counts[2] = 0, k
    lists = rng.integers(0, 80, size=(num_tiles, k)).astype(np.int32)
    return lists, counts


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("with_order", [False, True])
def test_list_kernel_matches_plain_on_card(chunk, with_order):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from dge_tpu_torch.ops import composite as TCMP
    from dge_tpu_torch.ops import tiles_composite as TTC

    rng = np.random.default_rng(6)
    _, _, _, m, c, r, d, o, tiles_x = random_stream(rng, 8, 32, tail=0)
    lists, counts = random_lists(rng, 8, 300)
    dev = torch.device("cuda")
    feats = [torch.from_numpy(x).to(dev) for x in (m, c, r, d, o)]
    lt = torch.from_numpy(lists).to(dev)
    ct = torch.from_numpy(counts).to(dev)
    order = None
    if with_order:
        perm = rng.permutation(80).astype(np.int32)
        order = torch.from_numpy(perm).to(dev)
        lt = torch.from_numpy(np.argsort(perm).astype(np.int32)[lists]).to(dev)
    kw = dict(tiles_x=tiles_x, tile_px=32, chunk=chunk)
    before = dict(CB.launch_counts)
    got = TTC.composite_tiles_kernel(TTC.feature_table(*feats), lt, ct, order,
                                     **kw)
    torch.cuda.synchronize()
    # K2 runs its layout kernel, then K1's row and combine kernels over the
    # aligned list stream
    for k in ("list_stream", "tiles_composite", "pairs_composite",
              "pairs_composite_combine"):
        assert CB.launch_counts[k] == before[k] + 1, k
    want = TCMP.composite_lists(lt, ct, *feats, order=order, **kw)
    err = (got - want).abs()
    assert float(err[:, 0:3].max()) <= 1e-4
    assert float(err[:, 3].max()) <= 1e-3
    assert float(err[:, 4].max()) <= 2e-4
    assert float(got[1, 4].min()) == 1.0  # the empty tile
    # the layout kernel alone: the same bits as its plain version
    _, _, cum, n_rows = TTC.list_rows(ct, chunk)
    layout = (TTC.feature_table(*feats), lt, ct, order, cum, n_rows, chunk)
    for x, y in zip(TTC.list_stream(*layout),
                    TTC.list_stream_reference(*layout)):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [128, 256])
def test_logdot_kernel_matches_plain_on_card(chunk):
    """The log-space arm against its plain version and against the
    production kernel on the same stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from dge_tpu_torch.tools import proto_logdot as TLD

    rng = np.random.default_rng(1)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(
        rng, 8, 32, tail=3)
    dev = torch.device("cuda")
    data = TPC.assemble_stream_data(*(torch.from_numpy(x).to(dev)
                                      for x in (ids, m, c, r, d, o)))
    st = torch.from_numpy(starts).to(dev)
    ct = torch.from_numpy(counts).to(dev)
    kw = dict(tiles_x=tiles_x, tile_px=32, chunk=chunk)
    before = CB.launch_counts["pairs_logdot"]
    got = TLD.composite_pairs_logdot(data, st, ct, **kw)
    torch.cuda.synchronize()
    assert CB.launch_counts["pairs_logdot"] == before + 1
    for want in (TLD.composite_pairs_logdot_reference(data, st, ct, **kw),
                 TPC.composite_pairs_stream(data, st, ct, **kw)):
        err = (got - want).abs()
        assert float(err[:, 0:3].max()) <= 1e-4
        assert float(err[:, 3].max()) <= 1e-3
        assert float(err[:, 4].max()) <= 2e-4


@pytest.mark.gpu
def test_cuda_tiles_raises_when_the_library_cannot_load(monkeypatch):
    """K2 on the card raises when a library of the kernels it runs (its
    layout kernel; K1's row and combine kernels) cannot be built or loaded;
    it never falls back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dge_tpu_torch.ops import tiles_composite as TTC

    rng = np.random.default_rng(6)
    _, _, _, m, c, r, d, o, tiles_x = random_stream(rng, 4, 16, tail=0)
    lists, counts = random_lists(rng, 4, 40)
    dev = torch.device("cuda")
    table = TTC.feature_table(*(torch.from_numpy(x).to(dev)
                                for x in (m, c, r, d, o)))

    def broken(name):
        raise RuntimeError(f"nvcc failed: {name}")

    monkeypatch.setattr(CB, "_libs", {})
    monkeypatch.setattr(CB, "build_library", broken)
    before = CB.launch_counts["tiles_composite"]
    with pytest.raises(RuntimeError, match="nvcc failed: list_stream"):
        TTC.composite_tiles_kernel(
            table, torch.from_numpy(lists).to(dev),
            torch.from_numpy(counts).to(dev), tiles_x=tiles_x, tile_px=16,
            chunk=128)
    assert CB.launch_counts["tiles_composite"] == before


def test_backward_wrappers_take_plain_versions_for_cpu_tensors():
    """On CPU tensors pass 1 and pass 2 run their plain versions and count
    no launch; a chunk the kernels cannot stage is refused only for CUDA
    tensors, which the CPU never reaches."""
    from dge_tpu_torch.ops import pairs_backward as TPB

    rng = np.random.default_rng(0)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(rng, 4, 16, 5)
    data = TPC.assemble_stream_data(*(torch.from_numpy(x)
                                      for x in (ids, m, c, r, d, o)))
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    kw = dict(tiles_x=tiles_x, tile_px=16, chunk=128)
    cot = torch.from_numpy(rng.normal(size=(4, 5, 256)).astype(np.float32))
    fwd = TPC.composite_pairs_stream(data, st, ct, **kw)
    blk_off, row_tile, n_rows = TPB.block_rows(st, ct, 128, data.shape[1])
    before = dict(CB.launch_counts)
    bt, suf = TPB.pairs_pass1(data, st, ct, blk_off, n_rows, cot, **kw)
    grads = TPB.pairs_pass2(data, st, ct, blk_off, row_tile, cot, fwd, bt,
                            suf, **kw)
    assert CB.launch_counts == before
    want = TPB.pass1_reference(data, st, ct, blk_off, n_rows, cot, **kw)
    assert torch.equal(bt, want[0]) and torch.equal(suf, want[1])
    assert grads.shape == (10, data.shape[1])
    assert float(grads.abs().max()) > 0
    # positions past every tile's range carry no gradient
    assert float(grads[:, int(starts[-1] + counts[-1]):].abs().max()) == 0.0
    with pytest.raises(ValueError, match=r"must be \[R, P\]"):
        TPB.pairs_pass2(data, st, ct, blk_off, row_tile, cot, fwd, bt[:-1],
                        suf, **kw)


def test_launch_passes_pointers_checks_kinds_and_counts(monkeypatch):
    """``cuda_build.launch`` with Python stand-ins for two library entries
    (no card: the device guard and the stream are stubbed too): tensors go
    as their data pointers and None as NULL, the stream last, a NumPy
    integer as an int; an argument of another kind (a bool, a float, a
    tensor or None for an int) raises TypeError before the call; a non-zero return
    raises RuntimeError naming the entry and counts nothing; a zero return
    adds one to the named counter and to no other."""
    calls, ret = [], [0]

    def entry(*args):
        calls.append(args)
        return ret[0]

    for name in ("list_stream", "preprocess"):
        monkeypatch.setitem(CB._libs, name, types.SimpleNamespace(**{
            "list_stream": entry, "preprocess_forward": entry}))
    guarded = []
    monkeypatch.setattr(torch.cuda, "device",
                        lambda i: guarded.append(i) or contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 70 + i, raising=False)
    monkeypatch.setitem(CB.launch_counts, "list_stream",
                        CB.launch_counts["list_stream"])
    feat, data = torch.zeros(10, 8), torch.zeros(10, 4)
    lists, counts, cum, row_tile = (torch.zeros(k, dtype=torch.int32)
                                    for k in (6, 2, 2, 1))
    args = [feat, lists, 3, counts, None, cum, 2, 4, 1, data, row_tile]
    card = torch.device("cuda", 7)
    before = dict(CB.launch_counts)
    CB.launch("list_stream", "list_stream", card, *args)
    assert calls == [(feat.data_ptr(), lists.data_ptr(), 3, counts.data_ptr(),
                      None, cum.data_ptr(), 2, 4, 1, data.data_ptr(),
                      row_tile.data_ptr(), 77)] and guarded == [7]
    assert CB.launch_counts == dict(
        before, list_stream=before["list_stream"] + 1)
    CB.launch("list_stream", "list_stream", card, *args[:2], np.int32(3),
              *args[3:])
    assert calls[1] == calls[0] and type(calls[1][2]) is int
    for i, bad in ((0, feat.data_ptr()), (2, 3.0), (2, True), (2, 2 ** 31),
                   (2, torch.tensor(3)), (4, np.zeros(2)), (6, None)):
        with pytest.raises(TypeError, match=f"list_stream: argument {i} "):
            CB.launch("list_stream", "list_stream", card,
                      *args[:i], bad, *args[i + 1:])
    with pytest.raises(TypeError, match="takes 11 arguments"):
        CB.launch("list_stream", "list_stream", card, *args[:-1])
    prep = [None] * 10 + [1] * 6 + [1] + [None] * 6
    with pytest.raises(TypeError, match="argument 16 must be a float"):
        CB.launch("preprocess_forward", "preprocess", card, *prep)
    assert len(calls) == 2
    ret[0] = 700
    with pytest.raises(RuntimeError,
                       match="list_stream launch failed: cudaError 700"):
        CB.launch("list_stream", "list_stream", card, *args)
    assert len(calls) == 3
    assert CB.launch_counts == dict(
        before, list_stream=before["list_stream"] + 2)


def test_entries_match_the_c_signatures():
    """``cuda_build.ENTRIES`` declares every ``extern "C"`` entry of
    ``csrc/*.cu`` with the kinds of its parameters (p a pointer, i an int,
    f a float) and its library, the stream last in every one."""
    found = {}
    for name in CB.SOURCES:
        with open(CB.source_path(name)) as f:
            src = f.read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            assert params[-1] == "void* stream", m.group(1)
            found[m.group(1)] = (name, "".join(
                "p" if "*" in p else {"int": "i", "float": "f"}[p.split()[0]]
                for p in params[:-1]))
    assert found == CB.ENTRIES


def test_build_paths_stay_in_repo():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert CB.BUILD_DIR == os.path.join(root, "build")
    src = CB.source_path("pairs_composite")
    assert os.path.isfile(src) and src.startswith(root)
    for name in CB.SOURCES:
        assert os.path.isfile(CB.source_path(name))
    assert CB.SOURCES == ("pairs_composite", "pairs_backward",
                          "pairs_logdot", "list_stream", "binning",
                          "preprocess", "reuse_match")
    assert os.path.isfile(os.path.join(CB.CSRC_DIR, "pair_alpha.cuh"))


def test_cpu_render_takes_plain_version():
    """A scene on the CPU renders through the plain version, by default and
    when the kernel's backend is named, and launches nothing."""
    import math

    from dge_tpu_torch.ops import render as TR
    from dge_tpu_torch.scene import gaussians as TG
    from dge_tpu_torch.scene.camera_arrays import CameraArrays
    from dge_tpu_torch.scene.cameras import look_at_camera

    rng = np.random.default_rng(2)
    n = 40
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    scene = TG.from_arrays(
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 1, 3)).astype(np.float32),
        np.zeros((n, 0, 3), np.float32),
        rng.uniform(0, 3, size=(n, 1)).astype(np.float32),
        rng.uniform(-3, -2, size=(n, 3)).astype(np.float32),
        rot / np.linalg.norm(rot, axis=1, keepdims=True), max_sh_degree=0,
        device="cpu")
    cam = CameraArrays.from_camera(look_at_camera(
        np.array([0.0, 0.3, -4.0]), np.zeros(3), fovx=math.radians(60),
        height=32, width=32), device="cpu")
    before = CB.launch_counts["pairs_composite"]
    out = TR.render(scene, cam, tile_px=16)
    assert CB.launch_counts["pairs_composite"] == before
    plain = TR.render(scene, cam, tile_px=16, backend="torch")
    named = TR.render(scene, cam, tile_px=16, backend="cuda_stream")
    assert CB.launch_counts["pairs_composite"] == before
    assert torch.equal(out.color, plain.color)
    assert torch.equal(named.color, plain.color)
    assert float(out.alpha.max()) > 0.5


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA device."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run on it")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no CUDA device" in res.stderr
