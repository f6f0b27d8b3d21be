"""What decides ``correct``, on the CPU at tiny sizes: each cell's control
(the reference one precision below the configuration's, put in the
program's place) and each fault the cell can have, planted in the program
underneath a whole run, come out not correct against the committed limits;
a sound run comes out correct."""

import contextlib
import json
import os
from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.reference.precision import Precision

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RENDER = {"config": {"scene_scale": 0.01},
          "traffic": {"height": 36, "width": 64, "orbit_frames": 8,
                      "warmup_frames": 1, "checked": 2, "checked_among": 3}}


def _edit_overrides():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "ip2p-sd15-bf16.json")) as f:
        rc = json.load(f)["recipe"]
    rc.update(height=64, width=64, camera_batch_size=2, diffusion_steps=3,
              resize_target=64)
    return {"config": {
        "unet": {"in_channels": 8, "out_channels": 4,
                 "block_out_channels": [32, 64], "layers_per_block": 1,
                 "cross_attention_dim": 32, "attention_head_dim": 2,
                 "norm_num_groups": 8},
        "vae": {"in_channels": 3, "latent_channels": 4,
                "block_out_channels": [16, 32], "layers_per_block": 1,
                "norm_num_groups": 8, "scaling_factor": 0.18215},
        "text_encoder": {"vocab_size": 1000, "hidden_size": 32,
                         "num_hidden_layers": 2, "num_attention_heads": 2,
                         "max_position_embeddings": 16,
                         "intermediate_size": 64},
        "scene_scale": 0.01, "recipe": rc},
        "traffic": {"views": 4}}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def _cell(name, overrides, seed=2 ** 31 + 17, seconds=0.3):
    return harness.load_cell(name, seed, seconds, False, "cpu",
                             overrides=overrides)


def _over(readings, limits):
    return {k: v for k, v in readings.items() if k in limits
            and v > limits[k]}


def _driven(cell):
    d = harness.load_driver(cell)
    d.setup()
    d.window(cell.seconds)
    d.release()
    return d


# ---- the controls ----

def test_render_control_is_not_correct():
    cell = _cell("render.blender1080", RENDER)
    d = _driven(cell)
    got = d.gaps(d.reference_frames(Precision("tf32")),
                 d.reference_frames(Precision()))
    assert _over(got, cell.limits)


def test_edit_control_is_not_correct():
    cell = _cell("edit.dge20", _edit_overrides())
    d = _driven(cell)
    ref = d.reference_round(*d.reference_nets("float32"))
    low = d.reference_round(*d.reference_nets("fp8"))
    assert _over(d.gaps(low, ref), cell.limits)


def test_render_limits_catch_one_wrong_tile_at_the_cell_size():
    """At 1920x1080 and the cell's six checked frames: frames within
    rounding of the reference, one of them with a patch of pixels blended
    in another order (near-equal depths), pass; one 32x32 tile off by 0.5
    in every frame, which the mean gap alone lets pass, does not."""
    from benchmark.drivers.render import Driver

    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "orbit_1080p.json")) as f:
        tr = json.load(f)
    h, w, n = tr["height"], tr["width"], tr["checked"]
    limits = _cell("render.blender1080", RENDER).limits
    g = torch.Generator().manual_seed(3)
    ref = {i: torch.rand(h, w, 3, generator=g) for i in range(n)}
    got = {i: ref[i] + 3e-5 * torch.randn(h, w, 3, generator=g)
           for i in range(n)}
    got[2][500:530, 700:730] += 0.3
    assert not _over(Driver.gaps(got, ref), limits)
    for i in range(n):
        got[i][64:96, 128:160] += 0.5
    over = _over(Driver.gaps(got, ref), limits)
    assert "wide_pixel_share_median" in over
    assert "frame_mean_gap" not in over


# ---- the faults, planted in the program under a whole run ----

@contextlib.contextmanager
def _frame_altered():
    """Each rendered frame altered where the renderer produces it."""
    from dge_tpu_torch.ops import render

    real = render.render

    def altered(*a, **k):
        out = real(*a, **k)
        return out._replace(color=out.color + 0.01)

    with mock.patch.object(render, "render", altered):
        yield


@contextlib.contextmanager
def _tile_altered():
    """One 8x8 block of each rendered frame altered by 0.5 where the
    renderer produces it."""
    from dge_tpu_torch.ops import render

    real = render.render

    def altered(*a, **k):
        out = real(*a, **k)
        color = out.color.clone()
        color[8:16, 8:16] += 0.5
        return out._replace(color=color)

    with mock.patch.object(render, "render", altered):
        yield


@contextlib.contextmanager
def _edit_altered():
    """The edited frames altered where the VAE decodes them."""
    from dge_tpu_torch.diffusion import ip2p

    real = ip2p.decode_latents

    def altered(*a, **k):
        return real(*a, **k) * 0.9

    with mock.patch.object(ip2p, "decode_latents", altered):
        yield


@pytest.mark.parametrize("name, overrides, fault", [
    ("render.blender1080", RENDER, None),
    ("render.blender1080", RENDER, _frame_altered),
    ("render.blender1080", RENDER, _tile_altered),
    ("edit.dge20", None, _edit_altered),
], ids=["render-sound", "render-frame-altered", "render-tile-altered",
        "edit-frame-altered"])
def test_a_run_with_its_path_broken_is_not_correct(name, overrides, fault):
    cell = _cell(name, overrides or _edit_overrides())
    with (fault() if fault else contextlib.nullcontext()):
        out = harness.run_cell(cell)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
