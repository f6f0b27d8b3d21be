"""The SDXL edit cell (``edit.sdxl768``) on the CPU at tiny sizes: the
reference at its published and at a tiny size, a whole run of the cell
through ``harness.load_cell(..., overrides=...)`` (correct; its counter
metric read), its control and a planted fault (not correct against the
committed limits)."""

import contextlib
import json
import os
from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.reference import dge, sd15, sdxl

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "edit.sdxl768"


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "ip2p-sdxl768-bf16.json")) as f:
        return json.load(f)


def _overrides():
    cfg = _config()
    rc = dict(cfg["recipe"], height=64, width=64, camera_batch_size=2,
              diffusion_steps=3, resize_target=64)
    unet = dict(cfg["unet"], block_out_channels=[16, 32, 64],
                layers_per_block=1, attention_head_dim=[2, 4, 8],
                transformer_layers_per_block=[1, 2, 3],
                cross_attention_dim=32, norm_num_groups=8,
                addition_time_embed_dim=8,
                projection_class_embeddings_input_dim=72)
    text = {"vocab_size": 1000, "hidden_size": 16, "num_hidden_layers": 2,
            "num_attention_heads": 2, "max_position_embeddings": 16,
            "intermediate_size": 32, "hidden_act": "quick_gelu"}
    return {"config": {
        "unet": unet,
        "vae": dict(cfg["vae"], block_out_channels=[16, 32],
                    layers_per_block=1, norm_num_groups=8),
        "text_encoder": text,
        "text_encoder_2": dict(text, intermediate_size=64, hidden_act="gelu",
                               projection_dim=24),
        "scene_scale": 0.01, "recipe": rc},
        "traffic": {"views": 4}}


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
    """On the meta device: 70 transformer blocks, the SDXL UNet's
    2,567,475,204 parameters (2,567,463,684 at 4 input channels), the
    towers' 123,060,480 and 694,659,840; a round's count is the passes'
    sum over the round."""
    cfg = _config()
    with torch.device("meta"):
        unet = sdxl.UNet(cfg["unet"])
        towers = [sdxl.TextTower(cfg[k])
                  for k in ("text_encoder", "text_encoder_2")]
    assert sum(isinstance(m, sd15.TransformerBlock)
               for m in unet.modules()) == 70
    assert sum(p.numel() for p in unet.parameters()) == 2_567_475_204
    assert [sum(p.numel() for p in t.parameters()) for t in towers] == [
        123_060_480, 694_659_840]


def test_the_flop_count_at_a_tiny_size():
    """Each pass kind's count on the meta device (what ``editxl.mfu``
    reads) equals ``FlopCounterMode`` over the same networks on CPU
    tensors."""
    ov = _overrides()["config"]
    torch.manual_seed(0)
    unet, vae = sdxl.UNet(ov["unet"]), sd15.VAE(ov["vae"])
    real = sdxl.pass_flops(unet, vae, 4, 16, 16, 2, 7, 32, 24, device="cpu")
    meta = sdxl.pass_flops(unet, vae, 4, 16, 16, 2, 7, 32, 24,
                           device="meta")
    assert meta == real and min(real.values()) > 0
    recipe = {"camera_batch_size": 2, "diffusion_steps": 20}
    assert dge.round_flops(real, 4, recipe, 998) > 17 * real["reuse"]


def test_a_run_of_the_cell_is_correct():
    """A whole run at tiny sizes: correct, with its end-to-end metrics."""
    out = harness.run_cell(_cell())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"edit_views_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_the_span_window_reads_the_record_and_the_match():
    """The span window's round (the readers' ``measure``, which the harness
    calls on a card): the pivot record's megabytes a round as the counter
    counts them (two pivot steps of 18 blocks), the reuse's match spans
    without a device interval on the CPU (no reading)."""
    cell = _cell(trace=True)
    d = harness.load_driver(cell)
    d.setup()
    ctx = harness.Context(cell, d, None)
    mb = harness.load_reader("editxl.pivot_record_mb").measure(ctx)
    match = [s for s in ctx.span_window["spans"]
             if s["name"] == "attn.reuse_match"]
    # 2 pivots x 3 CFG chunks, bf16 normed states and outputs at 16^2
    # tokens x 32 (6 blocks) and 8^2 x 64 (12 blocks)
    per_pass = 6 * 2 * 2 * (6 * 256 * 32 + 12 * 64 * 64)
    assert mb == pytest.approx(2 * per_pass / 1e6)
    assert len(match) == 2 * 18
    assert harness.load_reader("editxl.reuse_match_round_ms").measure(
        ctx) is None
    d.release()


def test_the_control_is_not_correct():
    """The reference one precision below (float8 e4m3 operands) passes a
    limit."""
    cell = _cell()
    d = harness.load_driver(cell)
    d.setup()
    d.release()
    ref = d.reference_round(*d.reference_nets("float32"))
    low = d.reference_round(*d.reference_nets("fp8"))
    over = {k: v for k, v in d.gaps(low, ref).items()
            if v > cell.limits[k]}
    assert over


@contextlib.contextmanager
def _edit_altered():
    from dge_tpu_torch.diffusion import ip2p

    real = ip2p.decode_latents

    def altered(*a, **k):
        return real(*a, **k) * 0.9

    with mock.patch.object(ip2p, "decode_latents", altered):
        yield


def test_a_run_with_its_frames_altered_is_not_correct():
    with _edit_altered():
        out = harness.run_cell(_cell())
    assert not out["correct"], out["checks"]
