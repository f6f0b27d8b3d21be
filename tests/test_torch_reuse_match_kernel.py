"""The pivot reuse's match kernel (``dge_tpu_torch/csrc/reuse_match.cu``)
against the torch path (``layers._epi_argmax_torch``) and a dense oracle.

On the CPU: the dispatch (CPU tensors take the torch path, no launch
counted), the wrapper's checks (a gradient, a width that is not a multiple
of 16, another dtype, a non-contiguous or misshapen tensor), which raise
before any launch, the arguments it hands the launch, the f32 tokens'
three-term bf16 split, and the torch path against a dense float64 oracle at
ragged token counts with planted exact ties, rows whose every pivot token
violates and the pivot frame's zero lines. On the card (marked ``gpu``;
skips without one): the kernel against the dense oracle bit for bit where
every sum is exact (integer tokens, dyadic lines), so exact ties go to the
first index; against the torch path on random unit tokens at the reuse
pass's shapes, indices equal wherever the torch path's top-2 gap clears
the summation-order bound; one launch a call. This file imports neither
JAX nor the JAX package, so the card's machine runs it without them:

    python -m pytest --noconftest -m gpu tests/test_torch_reuse_match_kernel.py
"""

import numpy as np
import pytest
import torch

from dge_tpu_torch.diffusion import epipolar
from dge_tpu_torch.models import layers as L
from dge_tpu_torch.ops import cuda_build as CB

THRESHOLD = 1.0
# two f32 sums of the same D exact products of unit tokens, taken in other
# orders, differ by at most 2·D·2^-24 (|a·b| <= 1): 1.5e-4 at D = 1,280.
# The rule of tests/test_torch_bf16.py (BF16_TIE, 5e-2) is for tokens that
# two packages rounded apart; these are the same tokens
SUM_ORDER_TIE = 2e-4
# the reuse pass's shapes: 20 frames, 2 keys, (tokens, channels) of the
# SD-1.5 UNet's first level and of the SDXL UNet's two levels
PASS_SHAPES = [(20, 2, 4096, 320), (20, 2, 2304, 640), (20, 2, 576, 1280)]


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the reuse match kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def grid(s):
    """pts [s, 3] of an h x w pixel grid with h * w = s, h the largest
    divisor of s up to its square root."""
    h = max(i for i in range(1, int(s ** 0.5) + 1) if s % i == 0)
    return epipolar.pixel_grid(h, s // h), h, s // h


def band_lines(rng, f, k, s, h, w, *, pivot=None, all_bad=0):
    """lines [f, k, s, 3]: each a band through a random pixel with
    coefficients in quarters, so every distance to a pixel is a multiple
    of 1/16 and exact in f32 in any order; the pivot frame's lines zero
    (distance 0: nothing violates), and ``all_bad`` rows of each (frame,
    key) off the image (distance 5 to every pixel)."""
    a = rng.integers(-4, 5, size=(f, k, s)) / 4
    b = rng.integers(-4, 5, size=(f, k, s)) / 4
    b[(a == 0) & (b == 0)] = 1.0
    x0 = rng.integers(0, w, size=(f, k, s))
    y0 = rng.integers(0, h, size=(f, k, s))
    c = -(a * x0 + b * y0) + rng.integers(-4, 5, size=(f, k, s)) / 4
    lines = np.stack([a, b, c], axis=-1).astype(np.float32)
    if all_bad:
        rows = rng.choice(s, size=all_bad, replace=False)
        lines[:, :, rows] = np.float32([0.0, 0.0, 5.0])
    if pivot is not None:
        lines[pivot] = 0.0
    return torch.from_numpy(lines)


def integer_tokens(rng, f, k, s, d, dtype, *, ties=()):
    """img [f, s, d] and piv [f, k, s, d] of integers in [-2, 2]: every
    product and every sum is exact in bf16 and f32, so similarities tie
    exactly; ``ties`` (j, j2) pairs copy pivot token j to j2."""
    img = rng.integers(-2, 3, size=(f, s, d))
    piv = rng.integers(-2, 3, size=(f, k, s, d))
    for j, j2 in ties:
        piv[:, :, j2] = piv[:, :, j]
    return (torch.from_numpy(img.astype(np.float32)).to(dtype),
            torch.from_numpy(piv.astype(np.float32)).to(dtype))


def dense_oracle(img, piv, lines, pts, threshold):
    """The match from the whole [F, K, S, S] similarity in float64: the
    first index of the masked maximum, or of the raw one where every pivot
    token of the row violates."""
    img = img.double().cpu().numpy()
    piv = piv.double().cpu().numpy()
    sim = np.matmul(img[:, None], np.swapaxes(piv, -1, -2))  # [F, K, S, S]
    dist = np.abs(np.matmul(lines.double().cpu().numpy(),
                            pts.double().cpu().numpy().T))
    viol = dist > threshold
    masked = np.where(viol, 0.0, sim)
    return torch.from_numpy(np.where(viol.all(axis=-1), sim.argmax(axis=-1),
                                     masked.argmax(axis=-1))), sim, viol


def tie_case(seed, f, k, s, d, dtype=torch.bfloat16):
    """Integer tokens with pivot tokens copied to later places (inside a
    block of 16 and across blocks), dyadic bands, the pivot frame 0 and
    three rows off the image: the inputs, the oracle's answer, and how many
    rows' maximum is tied and how many rows violate everywhere."""
    rng = np.random.default_rng(seed)
    pts, h, w = grid(s)
    ties = [(1, 2), (3, 3 + 16), (5, s - 1), (0, s // 2)]
    img, piv = integer_tokens(rng, f, k, s, d, dtype, ties=ties)
    lines = band_lines(rng, f, k, s, h, w, pivot=0, all_bad=3)
    want, sim, viol = dense_oracle(img, piv, lines, pts, THRESHOLD)
    bad = viol.all(axis=-1)
    vals = np.where(bad[..., None], sim, np.where(viol, 0.0, sim))
    tied = int(((vals == vals.max(axis=-1, keepdims=True)).sum(-1) > 1).sum())
    return (img, piv, lines, pts), want, tied, int(bad.sum())


# ---- on the CPU --------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [16, 512])
def test_cpu_tensors_take_the_torch_path(dtype, block):
    """On CPU tensors the match is the torch path, bit for bit, and no
    kernel launch is counted."""
    rng = np.random.default_rng(0)
    pts, h, w = grid(77)
    img = L._unit(torch.from_numpy(rng.normal(size=(3, 77, 32))).float())
    piv = L._unit(torch.from_numpy(rng.normal(size=(3, 2, 77, 32))).float())
    lines = band_lines(rng, 3, 2, 77, h, w, pivot=1, all_bad=2)
    args = (img.to(dtype), piv.to(dtype), lines, pts, THRESHOLD, block)
    before = CB.launch_counts["reuse_match"]
    got = L.epi_blockwise_argmax(*args)
    assert CB.launch_counts["reuse_match"] == before
    assert torch.equal(got, L._epi_argmax_torch(*args))
    assert got.dtype == torch.long and got.shape == (3, 2, 77)


@pytest.mark.parametrize("s, block", [(77, 16), (77, 512), (200, 64),
                                      (200, 33)])
def test_torch_path_against_dense_oracle(s, block):
    """The torch path against the float64 oracle at token counts that are
    no multiple of the key block or of the kernel's tiles, on exact ties
    (integer tokens, copied pivot tokens), the pivot frame's zero lines and
    rows whose every pivot token violates: the same indices."""
    args, want, tied, bad = tie_case(s, 4, 2, s, 32, torch.float32)
    assert tied > 50 and bad == (4 - 1) * 2 * 3  # not in the pivot frame
    got = L._epi_argmax_torch(*args, THRESHOLD, block)
    assert torch.equal(got, want)


def test_bf16_terms_keep_f32_products():
    """f32 unit tokens through the three-term bf16 split: three times the
    width, bf16, and the product over it within 2^-15 of the float64 one
    (bf16 alone is 2^-8 off)."""
    rng = np.random.default_rng(1)
    img = L._unit(torch.from_numpy(rng.normal(size=(2, 50, 64))).float())
    piv = L._unit(torch.from_numpy(rng.normal(size=(2, 3, 50, 64))).float())
    a, b = L.bf16_terms(img, piv)
    assert a.dtype == b.dtype == torch.bfloat16
    assert a.shape == (2, 50, 192) and b.shape == (2, 3, 50, 192)
    want = torch.einsum("fsd,fktd->fkst", img.double(), piv.double())
    got = torch.einsum("fsd,fktd->fkst", a.double(), b.double())
    plain = torch.einsum("fsd,fktd->fkst", img.bfloat16().double(),
                         piv.bfloat16().double())
    assert float((got - want).abs().max()) < 2.0 ** -15
    assert float((plain - want).abs().max()) > 2.0 ** -12


def _good_args(dtype=torch.bfloat16, f=2, k=2, s=40, d=32):
    rng = np.random.default_rng(2)
    pts, h, w = grid(s)
    img, piv = integer_tokens(rng, f, k, s, d, dtype)
    return dict(img=img, piv_img=piv,
                lines=band_lines(rng, f, k, s, h, w), pts=pts)


BAD_ARGS = {
    "gradient": (lambda a: a.update(img=a["img"].float().requires_grad_()),
                 "takes no gradient"),
    "width 24": (lambda a: a.update(**_good_args(d=24)),
                 "token width 24 is not a multiple of 16"),
    "float16": (lambda a: a.update(img=a["img"].half(),
                                   piv_img=a["piv_img"].half()),
                "bfloat16 or float32, got torch.float16"),
    "float64": (lambda a: a.update(img=a["img"].double(),
                                   piv_img=a["piv_img"].double()),
                "bfloat16 or float32, got torch.float64"),
    "mixed dtypes": (lambda a: a.update(piv_img=a["piv_img"].float()),
                     "piv_img must be a contiguous torch.bfloat16"),
    "piv strided": (lambda a: a.update(
        piv_img=a["piv_img"].transpose(0, 1).contiguous().transpose(0, 1)),
        "piv_img must be a contiguous"),
    "lines shape": (lambda a: a.update(lines=a["lines"][:, :1].contiguous()),
                    r"lines must be a contiguous .* shape \(2, 2, 40, 3\)"),
    "pts float64": (lambda a: a.update(pts=a["pts"].double()),
                    "pts must be a contiguous torch.float32"),
    "on the CPU": (lambda a: None, "the kernel runs on a CUDA device"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_kernel_wrapper_checks_before_any_launch(case, monkeypatch):
    """``_epi_argmax_kernel`` raises on what the kernel does not take
    before it loads the library (so before any launch); on CPU tensors
    that are otherwise right, for the device."""
    a = _good_args()
    edit, match = BAD_ARGS[case]
    edit(a)

    def no_launch(*args):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(CB, "load", no_launch)
    monkeypatch.setattr(CB, "launch", no_launch)
    before = CB.launch_counts["reuse_match"]
    with pytest.raises(ValueError, match=match):
        L._epi_argmax_kernel(a["img"], a["piv_img"], a["lines"], a["pts"],
                             THRESHOLD)
    assert CB.launch_counts["reuse_match"] == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_hands_the_launch_its_entry_arguments(dtype, monkeypatch):
    """Past its checks the wrapper launches ``reuse_match`` once with the
    kinds ``ENTRIES`` declares: bf16 tokens as they are, f32 tokens as
    their three-term split (three times the width), a long [F, K, S]
    output."""
    a = _good_args(dtype, f=3, k=2, s=40, d=32)
    seen = []
    monkeypatch.setattr(CB, "check_tensors", lambda owner, entries: False)
    monkeypatch.setattr(CB, "launch", lambda *args: seen.append(args))
    out = L._epi_argmax_kernel(a["img"], a["piv_img"], a["lines"], a["pts"],
                               THRESHOLD)
    (args,) = seen
    entry, counter, device, img, piv, lines, pts, f, k, s, d, thr, got = args
    assert (entry, counter, device) == ("reuse_match", "reuse_match",
                                        a["img"].device)
    kinds = CB.ENTRIES[entry][1]
    assert len(args) - 3 == len(kinds) == 10
    width = 32 if dtype == torch.bfloat16 else 96
    assert (f, k, s, d, thr) == (3, 2, 40, width, THRESHOLD)
    assert type(thr) is float and all(type(x) is int for x in (f, k, s, d))
    assert img.dtype == piv.dtype == torch.bfloat16
    assert img.shape == (3, 40, width) and piv.shape == (3, 2, 40, width)
    assert lines is a["lines"] and pts is a["pts"]
    assert got is out and out.dtype == torch.long and out.shape == (3, 2, 40)


# ---- on the card -------------------------------------------------------


def kernel_call(args):
    """One call through ``epi_blockwise_argmax`` on the card: one launch."""
    before = CB.launch_counts["reuse_match"]
    with torch.no_grad():
        got = L.epi_blockwise_argmax(*args, THRESHOLD)
    assert CB.launch_counts["reuse_match"] == before + 1
    torch.cuda.synchronize()
    return got


# (frames, keys, tokens, channels): 64-row tiles (the small ones), 128-row
# tiles (20 x 2 x 8 blocks of 128 fill the card twice), one and several
# channel stages, ragged token counts
TIE_SHAPES = [(4, 2, 77, 32), (3, 1, 200, 48), (2, 2, 64, 16),
              (20, 2, 1000, 320), (5, 2, 333, 1280)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", TIE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_exact_ties_go_to_the_first_index(card, shape, dtype):
    """Integer tokens and dyadic bands make every sum exact on any unit in
    any order: the kernel gives the float64 oracle's indices bit for bit,
    copied pivot tokens, tied maxima, rows off the image and the pivot
    frame included."""
    f, k, s, d = shape
    args, want, tied, bad = tie_case(7 + s, f, k, s, d, dtype)
    assert tied > 0 and bad == (f - 1) * k * 3
    got = kernel_call([t.to(card) for t in args])
    assert torch.equal(got.cpu(), want)


def unit_case(seed, f, k, s, d, dtype, device):
    """Random unit tokens as ``_unit`` gives them in ``dtype``, dyadic
    bands, the pivot frame 0, five rows of each pair off the image."""
    gen = torch.Generator(device=device).manual_seed(seed)
    img = L._unit(torch.randn(f, s, d, generator=gen, device=device))
    piv = L._unit(torch.randn(f, k, s, d, generator=gen, device=device))
    pts, h, w = grid(s)
    lines = band_lines(np.random.default_rng(seed), f, k, s, h, w, pivot=0,
                       all_bad=5)
    return [img.to(dtype), piv.to(dtype), lines.to(device), pts.to(device)]


def clear_rows(img, piv, lines, pts):
    """Whether each row's top-2 gap of the similarity that decides it (the
    masked one, the raw one where every pivot token violates) in the torch
    path's f32 exceeds ``SUM_ORDER_TIE``; per frame, so no [F, K, S, S]
    array."""
    out = []
    for i in range(img.shape[0]):
        sim = torch.einsum("sd,ktd->kst", img[i].float(), piv[i].float())
        viol = torch.einsum("ksc,tc->kst", lines[i], pts).abs() > THRESHOLD
        vals = torch.where(viol & ~viol.all(-1, keepdim=True), 0.0, sim)
        top2 = vals.topk(2, dim=-1).values
        out.append(top2[..., 0] - top2[..., 1] > SUM_ORDER_TIE)
    return torch.stack(out)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PASS_SHAPES + [(5, 2, 1024, 640),
                                                 (3, 2, 77, 32),
                                                 (20, 2, 64, 1280)], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_random_unit_tokens_kernel_equals_torch_path(card, shape, dtype):
    """Random unit tokens at the reuse pass's shapes and small ones: the
    kernel's indices equal the torch path's on the card wherever that
    path's top-2 gap exceeds ``SUM_ORDER_TIE``, and most rows are that
    clear."""
    args = unit_case(sum(shape), *shape, dtype, card)
    got = kernel_call(args)
    with torch.no_grad():
        want = L._epi_argmax_torch(*args, THRESHOLD)
    clear = clear_rows(*args)
    assert float(clear.float().mean()) > 0.5
    assert int(((got != want) & clear).sum()) == 0


@pytest.mark.gpu
def test_gradient_on_the_card_raises(card):
    """Tokens that require a gradient, in grad mode, raise before any
    launch; under no_grad the same tensors launch once."""
    args = unit_case(3, 2, 2, 64, 32, torch.float32, card)
    args[0].requires_grad_(True)
    before = CB.launch_counts["reuse_match"]
    with pytest.raises(ValueError, match="takes no gradient"):
        L.epi_blockwise_argmax(*args, THRESHOLD)
    assert CB.launch_counts["reuse_match"] == before
    kernel_call(args)
