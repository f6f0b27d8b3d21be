"""The CUDA compositing kernel of the PyTorch port: its wrapper's checks
on the CPU, and the kernel against its plain version on a card (marked
``gpu``; skips without a card). This file imports neither JAX nor the JAX
package, so the card's machine runs it without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

Tolerances: colour 1e-4, depth 1e-3, final T 2e-4 (f32 rounding: the
kernel walks pairs one by one, the plain version uses torch.cumprod)."""

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


def test_build_paths_stay_in_repo():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert TPC.BUILD_DIR == os.path.join(root, "build")
    assert os.path.isfile(TPC._SRC) and TPC._SRC.startswith(root)


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
