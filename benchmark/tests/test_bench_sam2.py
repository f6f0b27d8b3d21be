"""The segment cell (``segment.sam2l1024``) on the CPU at tiny sizes, through
``harness.load_cell(..., overrides=...)``: a whole run (correct, its
end-to-end metrics), the span window's counter, the reference at its
published size, the float8 control and planted faults of the program (not
correct against the committed limits)."""

import contextlib
import json
import os
from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.reference import sam2 as REF

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "segment.sam2l1024"


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "sam2.1-hiera-l-bf16.json")) as f:
        return json.load(f)


def _overrides():
    """128² inputs: token grids 32/16/8/4 under windows 8/6/6/2, so stages
    2 and 3 pad and the global block (4) spans four windows' worth."""
    cfg = _config()
    return {"config": {
        "image_size": 128,
        "trunk": dict(cfg["trunk"], embed_dim=8, num_heads=1,
                      stages=[1, 2, 3, 2], global_att_blocks=[4],
                      window_spec=[8, 6, 6, 2]),
        "neck": dict(cfg["neck"], d_model=16,
                     backbone_channel_list=[64, 32, 16, 8]),
        "mask_decoder": dict(cfg["mask_decoder"], transformer_dim=16,
                             num_heads=2, mlp_dim=32, iou_head_hidden_dim=16),
        "recipe": {"height": 48, "width": 48, "camera_batch_size": 2},
        "scene_scale": 0.01},
        "traffic": {"views": 4, "warmup_rounds": 1, "trace_rounds": 2}}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def _cell(trace=False, seed=2 ** 31 + 29):
    return harness.load_cell(CELL, seed, 0.3, trace, "cpu",
                             overrides=_overrides())


def test_the_reference_at_its_published_size():
    """On the meta device: Hiera-L's 48 blocks, 216,920,437 image-path
    entries, and a round's count of 20 views at 1024² (what ``seg.mfu``
    reads): 1.826 TFLOP an image."""
    with torch.device("meta"):
        net = REF.Sam2(_config())
    assert len(net.image_encoder.trunk.blocks) == 48
    assert sum(v.numel() for v in net.state_dict().values()) == 216_920_437
    flops = REF.pass_flops(net, 20)
    assert flops / 20 == pytest.approx(1.8265e12, rel=1e-3)


def test_a_run_of_the_cell_is_correct():
    out = harness.run_cell(_cell())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"edit_views_per_s", "setup_s"}
    assert set(out["checks"]) == {"mask_logit_gap", "mask_flip_share",
                                  "selection_disagrees"}


def test_the_span_window_counts_one_host_read_a_round():
    """The span window (the readers' ``measure``, which the harness calls on
    a card): one host read a round, ``seg.fallbacks``; the spans have no
    device interval on the CPU (no reading)."""
    cell = _cell(trace=True)
    d = harness.load_driver(cell)
    d.setup()
    ctx = harness.Context(cell, d, None)
    assert harness.load_reader("seg.host_syncs_per_round").measure(ctx) == 1.0
    names = [s["name"] for s in ctx.span_window["spans"]]
    assert names.count("seg.encode") == 2 * 2
    assert harness.load_reader("seg.encode_round_ms").measure(ctx) is None
    d.release()


def _run_gaps(patch=None):
    """A whole run's checks, with ``patch`` (a context) around set-up and
    the window."""
    cell = _cell()
    d = harness.load_driver(cell)
    with patch or contextlib.nullcontext():
        d.setup()
        d.window(0.0)
    d.release()
    return d.check(), cell.limits


def test_the_control_is_not_correct():
    """The reference with float8 e4m3 operands passes a limit."""
    cell = _cell()
    d = harness.load_driver(cell)
    d.setup()
    d.release()
    ref = d.reference_round(d.reference_net("float32"))
    low = d.reference_round(d.reference_net("fp8"))
    low["masks"] = low.pop("mask").float()
    gaps = d.gaps(low, ref)
    assert any(gaps[k] > cell.limits[k] for k in gaps), gaps


@contextlib.contextmanager
def _global_block_windowed():
    from dge_tpu_torch.models import sam2 as M

    real = M.MultiScaleBlock.__init__

    def init(self, dim, dim_out, heads, window, *a, **k):
        real(self, dim, dim_out, heads, window or 6, *a, **k)

    with mock.patch.object(M.MultiScaleBlock, "__init__", init):
        yield


@contextlib.contextmanager
def _pooled_shortcut_missing():
    from dge_tpu_torch.models import sam2 as M

    class Zero(torch.nn.Module):
        def __init__(self, dim):
            super().__init__()
            self.dim = dim

        def forward(self, y):
            return y.new_zeros(*y.shape[:-1], self.dim)

    real = M.MultiScaleBlock.forward

    def forward(self, x):
        if not self.q_pool:
            return real(self, x)
        # the pooled block with a zero shortcut
        with mock.patch.object(self, "proj", Zero(self.dim_out)):
            return real(self, x)

    with mock.patch.object(M.MultiScaleBlock, "forward", forward):
        yield


@contextlib.contextmanager
def _selection_inverted():
    from dge_tpu_torch.models import sam2 as M

    real = M.select_masks

    def select(logits, iou, delta, thresh):
        # the fallback where mask 0 is stable, mask 0 where it is not
        _, choice, stab = real(logits, iou, delta, thresh)
        best = 1 + iou[:, 1:].argmax(-1)
        flipped = torch.where(choice == 0, best, torch.zeros_like(best))
        return logits[torch.arange(len(logits)), flipped], flipped, stab

    with mock.patch.object(M, "select_masks", select):
        yield


@pytest.mark.parametrize("fault", [_global_block_windowed,
                                   _pooled_shortcut_missing,
                                   _selection_inverted],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(fault):
    checks, _ = _run_gaps(fault())
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
