"""The CUDA kernels of the PyTorch port (forward compositing over the pair
stream, backward pass 1 and pass 2, forward compositing over per-tile lists,
the log-space arm of the stream kernel): their wrappers' checks on the CPU,
and each kernel against its plain version on a card (marked ``gpu``; skips
without a card). This file imports neither JAX nor the JAX package, so the
card's machine runs it without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

Tolerances: colour 1e-4, depth 1e-3, final T and boundary T 2e-4 (f32
rounding: the kernels walk pairs one by one, the plain versions use
torch.cumprod); suffix sums and gradients 2e-3·max + 1e-7 per field (the
pixel sums run in another order, and with shared-memory atomics)."""

import os

import numpy as np
import pytest
import torch

from dge_tpu_torch.ops import pairs_composite as TPC


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


def test_wrapper_takes_plain_version_for_cpu_tensors():
    """On CPU tensors the kernel's wrapper runs the plain version and counts
    no launch; it still checks what it is given."""
    rng = np.random.default_rng(0)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(rng, 4, 16, 0)
    data = TPC.assemble_stream_data(*(torch.from_numpy(x)
                                      for x in (ids, m, c, r, d, o)))
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    kw = dict(tiles_x=tiles_x, tile_px=16, chunk=128)
    before = TPC.launch_counts["pairs_composite"]
    got = TPC.composite_pairs_stream(data, st, ct, **kw)
    assert TPC.launch_counts["pairs_composite"] == before
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
    before = TPC.launch_counts["pairs_composite"]
    got = TPC.composite_pairs_stream(data, st, ct, **kw)
    torch.cuda.synchronize()
    assert TPC.launch_counts["pairs_composite"] == before + 1
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
    before = dict(TPC.launch_counts)
    bt, suf = TPB.pairs_pass1(data, st, ct, blk_off, n_rows, cot, **kw)
    grads = TPB.pairs_pass2(data, st, ct, blk_off, row_tile, cot, fwd, bt,
                            suf, **kw)
    torch.cuda.synchronize()
    assert TPC.launch_counts["pairs_pass1"] == before["pairs_pass1"] + 1
    assert TPC.launch_counts["pairs_pass2"] == before["pairs_pass2"] + 1
    bt_p, suf_p = TPB.pass1_reference(data, st, ct, blk_off, n_rows, cot, **kw)
    grads_p = TPB.pass2_reference(data, st, ct, blk_off, row_tile, cot, fwd,
                                  bt, suf, **kw)
    used = row_tile < 8
    assert float((bt[used] - bt_p[used]).abs().max()) <= 2e-4

    def close(a, b):
        return float((a - b).abs().max()) <= 2e-3 * float(b.abs().max()) + 1e-7

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
            col, dep, tfin = TPB.stream_composite(*leaves, ids_t, st, ct,
                                                  **geom)
        else:
            col, dep, tfin = TPC.composite_pairs(
                ids_t, st, ct, *leaves, bg=torch.zeros(3, device=dev),
                use_kernel=False, **geom)
        loss = ((col * wt[..., :3]).sum() + (dep * wt[..., 3]).sum()
                + (tfin * wt[..., 4]).sum())
        res.append(torch.autograd.grad(loss, leaves))
    for got, want in zip(*res):
        assert close(got, want)


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
    before = TPC.launch_counts["tiles_composite"]
    got = TTC.composite_tiles_kernel(TTC.feature_table(*feats), lt, ct, order,
                                     **kw)
    torch.cuda.synchronize()
    assert TPC.launch_counts["tiles_composite"] == before + 1
    want = TCMP.composite_lists(lt, ct, *feats, order=order, **kw)
    err = (got - want).abs()
    assert float(err[:, 0:3].max()) <= 1e-4
    assert float(err[:, 3].max()) <= 1e-3
    assert float(err[:, 4].max()) <= 2e-4
    assert float(got[1, 4].min()) == 1.0  # the empty tile


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
    before = TPC.launch_counts["pairs_logdot"]
    got = TLD.composite_pairs_logdot(data, st, ct, **kw)
    torch.cuda.synchronize()
    assert TPC.launch_counts["pairs_logdot"] == before + 1
    for want in (TLD.composite_pairs_logdot_reference(data, st, ct, **kw),
                 TPC.composite_pairs_stream(data, st, ct, **kw)):
        err = (got - want).abs()
        assert float(err[:, 0:3].max()) <= 1e-4
        assert float(err[:, 3].max()) <= 1e-3
        assert float(err[:, 4].max()) <= 2e-4


@pytest.mark.gpu
def test_cuda_tiles_raises_when_the_library_cannot_load(monkeypatch):
    """A scene on the card with ``backend="cuda_tiles"`` raises when the
    kernel library cannot be built or loaded; it never falls back to the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dge_tpu_torch.ops import cuda_build
    from dge_tpu_torch.ops import tiles_composite as TTC

    rng = np.random.default_rng(6)
    _, _, _, m, c, r, d, o, tiles_x = random_stream(rng, 4, 16, tail=0)
    lists, counts = random_lists(rng, 4, 40)
    dev = torch.device("cuda")
    table = TTC.feature_table(*(torch.from_numpy(x).to(dev)
                                for x in (m, c, r, d, o)))

    def broken(name):
        raise RuntimeError(f"nvcc failed: {name}")

    monkeypatch.setattr(TTC, "_lib", None)
    monkeypatch.setattr(cuda_build, "build_library", broken)
    before = TPC.launch_counts["tiles_composite"]
    with pytest.raises(RuntimeError, match="nvcc failed: tiles_composite"):
        TTC.composite_tiles_kernel(
            table, torch.from_numpy(lists).to(dev),
            torch.from_numpy(counts).to(dev), tiles_x=tiles_x, tile_px=16,
            chunk=128)
    assert TPC.launch_counts["tiles_composite"] == before


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
    before = dict(TPC.launch_counts)
    bt, suf = TPB.pairs_pass1(data, st, ct, blk_off, n_rows, cot, **kw)
    grads = TPB.pairs_pass2(data, st, ct, blk_off, row_tile, cot, fwd, bt,
                            suf, **kw)
    assert TPC.launch_counts == before
    want = TPB.pass1_reference(data, st, ct, blk_off, n_rows, cot, **kw)
    assert torch.equal(bt, want[0]) and torch.equal(suf, want[1])
    assert grads.shape == (10, data.shape[1])
    assert float(grads.abs().max()) > 0
    # positions past every tile's range carry no gradient
    assert float(grads[:, int(starts[-1] + counts[-1]):].abs().max()) == 0.0
    with pytest.raises(ValueError, match=r"must be \[R, P\]"):
        TPB.pairs_pass2(data, st, ct, blk_off, row_tile, cot, fwd, bt[:-1],
                        suf, **kw)


def test_build_paths_stay_in_repo():
    from dge_tpu_torch.ops import cuda_build

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert TPC.BUILD_DIR == os.path.join(root, "build")
    assert os.path.isfile(TPC._SRC) and TPC._SRC.startswith(root)
    for name in cuda_build.SOURCES:
        assert os.path.isfile(cuda_build.source_path(name))
    assert cuda_build.SOURCES == ("pairs_composite", "pairs_backward",
                                  "tiles_composite", "pairs_logdot")
    assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, "pair_alpha.cuh"))


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
    before = TPC.launch_counts["pairs_composite"]
    out = TR.render(scene, cam, tile_px=16)
    assert TPC.launch_counts["pairs_composite"] == before
    plain = TR.render(scene, cam, tile_px=16, backend="torch")
    named = TR.render(scene, cam, tile_px=16, backend="cuda_stream")
    assert TPC.launch_counts["pairs_composite"] == before
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
