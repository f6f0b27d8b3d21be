"""The ``sam2`` segmentor's CUDA graph replay (``systems/segmentation.
_BatchGraph``): on the card (marked ``gpu``; skips without one) every
output of a replayed batch against the eager batch's under ``torch.equal``,
in f32 and bf16, a second batch shape captured on its own, and the counts;
on the CPU, that nothing is captured. This file imports neither JAX nor the
JAX package, so the card's machine runs it without them:

    python -m pytest --noconftest -m gpu tests/test_torch_sam2_card.py
"""

import pytest
import torch

from dge_tpu_torch.models import sam2 as M
from dge_tpu_torch.systems import segmentation as SG
from dge_tpu_torch.utils import tracing


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


def _inputs(device, views=5, size=48):
    gen = torch.Generator().manual_seed(4)
    images = torch.rand(views, size, size, 3, generator=gen).to(device)
    lo = torch.rand(views, 2, generator=gen) * size / 2
    boxes = torch.cat([lo, lo + size / 3], 1).to(device)
    return images, boxes


def _counts():
    return dict(tracing.counters()["segment_counts"])


def test_the_cpu_never_captures():
    seg = SG.Sam2Segmentor(M.build_model(M.Sam2Config.tiny(), seed=1))
    before = _counts()
    seg.segment(*_inputs("cpu"), batch=2)
    after = _counts()
    assert after["captures"] == before["captures"]
    assert after["replays"] == before["replays"]
    assert not seg._graphs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_replays_equal_the_eager_batches(card, dtype):
    """Five views in batches of two: one graph of two views and one of one
    (three replays a call); each output of every call equal to the eager
    path's (under ``recording()``) bit for bit."""
    seg = SG.Sam2Segmentor(M.build_model(M.Sam2Config.tiny(), seed=1,
                                         device=card, dtype=dtype))
    images, boxes = _inputs(card)
    before = _counts()
    got = [seg.segment(images, boxes, batch=2) for _ in range(3)]
    with tracing.recording():
        want = seg.segment(images, boxes, batch=2)
    tracing.take()
    after = _counts()
    assert after["captures"] - before["captures"] == 2
    assert after["replays"] - before["replays"] == 9
    for out in got:
        for field in ("masks", "logits", "iou", "object_scores", "stability",
                      "choice", "hit"):
            assert torch.equal(getattr(out, field), getattr(want, field)), \
                field
