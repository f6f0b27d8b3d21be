"""SAM 2.1's image path in the port (``models/sam2``, the ``sam2`` segmentor
of ``systems/segmentation``, ``DGESystem.segment_views`` and ``update_mask``,
``launch --train system.segmentor=sam2``) against the plain reference
``benchmark/reference/sam2.py``, on the CPU at ``Sam2Config.tiny()`` with
seeded weights, and the Hiera-L layout on the meta device.

Tolerance: both sides compute in f32 on the CPU, the same operations in
another order (the port batches views and windows and runs
``layers.attend_heads``' dense softmax; the reference runs one image at a
time through ``sd15.attend_heads``' chunked einsums). The gaps read ~1e-6 of
each output's largest magnitude; ``TOL`` = 1e-4 of it leaves two orders of
room and still catches any change of the arithmetic, since a missing or
misplaced term moves an output by a share of its own size.

Two torch threads, as ``test_torch_plain_repeat.py`` sets them (the suite
runs in parallel workers).
"""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import sam2 as REF
from benchmark.yardstick import scene as S
from dge_tpu_torch import launch
from dge_tpu_torch.models import sam2 as M
from dge_tpu_torch.ops import render as TR
from dge_tpu_torch.scene import gaussians as TG
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.systems import edit as TE
from dge_tpu_torch.systems import segmentation as SG
from dge_tpu_torch.utils import tracing
from tests.test_torch_render import write_synthetic_capture

TOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def ref_config(c: M.Sam2Config) -> dict:
    """The port's configuration as the reference's dict (the keys of
    ``benchmark/configs/sam2.1-hiera-l-bf16.json``)."""
    widths = [c.embed_dim * 2 ** i for i in range(len(c.stages))]
    return {
        "image_size": c.image_size,
        "trunk": {"embed_dim": c.embed_dim, "num_heads": c.num_heads,
                  "stages": list(c.stages),
                  "global_att_blocks": list(c.global_att_blocks),
                  "window_spec": list(c.window_spec),
                  "window_pos_embed_bkg_spatial_size":
                      list(c.window_pos_embed_bkg_spatial_size),
                  "q_pool": c.q_pool, "dim_mul": c.dim_mul,
                  "head_mul": c.head_mul, "mlp_ratio": c.mlp_ratio},
        "neck": {"d_model": c.d_model, "backbone_channel_list": widths[::-1],
                 "fpn_top_down_levels": list(c.fpn_top_down_levels),
                 "scalp": c.scalp},
        "mask_decoder": {
            "transformer_depth": c.decoder_depth, "num_heads": c.decoder_heads,
            "mlp_dim": c.decoder_mlp_dim,
            "attention_downsample_rate": c.attention_downsample_rate,
            "num_multimask_outputs": c.num_multimask_outputs,
            "iou_head_depth": c.iou_head_depth,
            "iou_head_hidden_dim": c.d_model,
            "dynamic_multimask_stability_delta": c.stability_delta,
            "dynamic_multimask_stability_thresh": c.stability_thresh}}


TINY = M.Sam2Config.tiny()


@pytest.fixture(scope="module")
def nets():
    port = M.build_model(TINY, seed=5)
    ref = REF.Sam2(ref_config(TINY))
    ref.load_state_dict(port.state_dict())
    return port, ref.eval().requires_grad_(False)


def close(got, want, what=""):
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), (what, err)


def images(n=3, h=40, w=48, seed=0):
    return torch.rand(n, h, w, 3, generator=torch.Generator().manual_seed(
        seed))


BOXES = torch.tensor([[4.0, 6.0, 30.0, 35.0], [0.0, 0.0, 48.0, 40.0],
                      [20.0, 10.0, 26.0, 16.0]])


@pytest.mark.parametrize("preset", ["hiera_large", "tiny"])
def test_block_layout_and_names(preset):
    """On the meta device: the port's and the reference's state dicts under
    the same names and shapes; each block's widths, heads, window and
    pooling from the configuration; a stage's first block pools and keeps
    the previous stage's window. Hiera-L: 48 blocks, 144/288/576/1152 wide,
    every head 72 wide, global blocks 23/33/43, 216,920,437 image-path
    entries."""
    cfg = getattr(M.Sam2Config, preset)()
    with torch.device("meta"):
        port, ref = M.Sam2Model(cfg), REF.Sam2(ref_config(cfg))
    sp, sr = port.state_dict(), ref.state_dict()
    assert list(sp) == list(sr)
    assert all(sp[k].shape == sr[k].shape for k in sp)
    blocks = port.image_encoder.trunk.blocks
    plan, ends = REF.block_plan(ref_config(cfg)["trunk"])
    assert [(b.dim, b.dim_out, b.attn.heads, b.window, b.q_pool)
            for b in blocks] == plan
    starts = [e + 1 for e in ends[:-1]]
    for s, start in enumerate(starts):
        assert blocks[start].q_pool
        assert blocks[start].window == cfg.window_spec[s]
        assert blocks[start + 1].window in (cfg.window_spec[s + 1], 0)
    if preset == "hiera_large":
        assert len(blocks) == 48 and starts == [2, 8, 44]
        assert [b.dim_out for b in blocks[:2]] == [144] * 2
        assert {b.dim_out // b.attn.heads for b in blocks} == {72}
        assert [i for i, b in enumerate(blocks) if b.window == 0] == [
            23, 33, 43]
        assert [b.window for b in blocks[44:]] == [16, 8, 8, 8]
        assert sum(v.numel() for v in sp.values()) == 216_920_437


def test_trunk_neck_and_high_res_features(nets):
    """Each stage's output, the neck's levels and the encoder's three
    features of a batch of views, against the reference image by image;
    the tiny preset's windows pad at stages 2 and 3."""
    port, ref = nets
    x = M.prepare(images(), TINY.image_size)
    stages = port.image_encoder.trunk(x)
    levels = port.image_encoder(x)
    feats = port.encode(x)
    for i in range(len(x)):
        r_stages = ref.image_encoder.trunk(x[i:i + 1])
        for s, (got, want) in enumerate(zip(stages, r_stages)):
            close(got[i:i + 1].permute(0, 3, 1, 2), want, f"stage {s}")
        for s, (got, want) in enumerate(zip(levels,
                                            ref.image_encoder(x[i:i + 1]))):
            close(got[i:i + 1], want, f"level {s}")
        for s, (got, want) in enumerate(zip(feats, ref.encode(x[i:i + 1]))):
            close(got[i:i + 1], want, f"feature {s}")
    assert [tuple(f.shape[1:]) for f in feats] == [(16, 4, 4), (2, 16, 16),
                                                   (4, 8, 8)]


def test_logit_maps_iou_and_object_scores(nets):
    """All four low-resolution logit maps, the IoU and the object scores of
    the segmentor's batch call, and its masks, against ``REF.predict``."""
    port, ref = nets
    imgs = images()
    out = SG.Sam2Segmentor(port).segment(imgs, BOXES, batch=2)
    for i in range(len(imgs)):
        r = REF.predict(ref, imgs[i], BOXES[i].tolist())
        close(out.logits[i], r["logits"], "logits")
        close(out.iou[i], r["iou"], "iou")
        close(out.object_scores[i], r["object_score"], "object score")
        assert int(out.choice[i]) == int(r["choice"])
        assert float(out.stability[i]) == pytest.approx(float(r["stability"]))
        assert torch.equal(out.masks[i] > 0.5, r["mask"])
    assert out.logits.shape == (3, 4, 16, 16) and bool(out.hit.all())


def test_stability_selection_on_planted_maps():
    """Views whose mask-0 stability lies exactly at, just above and just
    below 0.98, one with no pixel above -delta (stability 1), and IoUs
    that pick each fallback: the port's choice, stability and chosen map
    equal the reference's and the rule's."""
    n = 400
    base = torch.full((n,), -1.0)

    def view(inner, union):
        # `inner` pixels above delta, `union - inner` in (-delta, delta]
        v = base.clone()
        v[:inner] = 1.0
        v[inner:union] = 0.0
        return v.reshape(20, 20)

    maps = [view(392, 400), view(393, 400), view(391, 400), base.reshape(
        20, 20), view(10, 400)]
    logits = torch.stack([torch.stack([m, m + 1, m + 2, m + 3]) for m in
                          maps])
    iou = torch.tensor([[0.5, 0.1, 0.9, 0.2], [0.5, 0.9, 0.1, 0.2],
                        [0.5, 0.1, 0.2, 0.9], [0.1, 0.9, 0.8, 0.7],
                        [0.5, 0.2, 0.9, 0.3]])
    got = M.select_masks(logits, iou, 0.05, 0.98)
    want = REF.select(logits, iou, 0.05, 0.98)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].tolist() == [0, 0, 3, 0, 2]
    assert got[2].tolist() == pytest.approx([0.98, 393 / 400, 391 / 400, 1.0,
                                             10 / 400])


def test_checkpoint_names_load(nets, tmp_path):
    """A checkpoint in SAM 2.1's layout (``{"model": state_dict}`` with the
    video parts beside the image path) loads by name into a network that
    gives the reference's outputs; one without an image-path entry is
    refused."""
    port, ref = nets
    sd = {k: v.clone() for k, v in ref.state_dict().items()}
    sd["memory_attention.layers.0.self_attn.q_proj.weight"] = torch.ones(4, 4)
    sd["maskmem_tpos_enc"] = torch.zeros(7, 1, 1, 64)
    path = str(tmp_path / "sam2.1_hiera_tiny_test.pt")
    torch.save({"model": sd}, path)
    loaded = M.build_model(TINY, checkpoint=path)
    imgs = images(2)
    a = SG.Sam2Segmentor(loaded).segment(imgs, BOXES[:2])
    b = SG.Sam2Segmentor(port).segment(imgs, BOXES[:2])
    assert torch.equal(a.logits, b.logits)
    del sd["sam_mask_decoder.conv_s0.weight"]
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="conv_s0"):
        M.build_model(TINY, checkpoint=path)


def scene_and_cameras(n_views=4, size=32):
    """The benchmark's ground-truth scene at a small fraction of its
    Gaussians, and views of its orbit (program and reference forms)."""
    a = S.gt_scene(3, sh_degree=1, scale=0.004)
    scene = TG.from_arrays(a["xyz"], a["features_dc"], a["features_rest"],
                           a["opacity"], a["scaling"], a["rotation"],
                           max_sh_degree=1, active_sh_degree=1, device="cpu")
    poses = S.orbit_cameras(n_views, size, size)
    cams = [CameraArrays(*(torch.as_tensor(np.asarray(p[k], np.float32))
                           for k in ("w2c", "full_proj", "campos",
                                     "tan_half_fovx", "tan_half_fovy")),
                         height=size, width=size) for p in poses]
    return scene, cams, poses


BOX = [-0.6, -1.0, -0.6, 0.6, 0.1, 0.6]


def system(nets, box=BOX, batch=2):
    scene, cams, poses = scene_and_cameras()
    cfg = TE.EditConfig(max_view_num=4, camera_batch_size=batch,
                        seg_prompt="object", seg_box=box, tile_px=16,
                        chunk=16)
    sys_ = TE.DGESystem(cfg, scene, cams,
                        segmentor=SG.Sam2Segmentor(nets[0]))
    sys_.render_all_views()
    return sys_, poses


def test_segment_views_equal_per_view_calls(nets):
    """``segment_views`` (batches of two) against the segmentor called one
    view at a time, and each view's box against the reference's own
    projection of the scene-space box."""
    sys_, poses = system(nets)
    out = sys_.segment_views()
    for i, v in enumerate(sys_.view_list):
        box = REF.box_in_view(BOX, poses[v])
        got = SG.project_box(BOX, CameraArrays(*(
            getattr(sys_.cameras[v], k)[None] for k in (
                "w2c", "full_proj", "campos", "tan_half_fovx",
                "tan_half_fovy")), height=32, width=32))[0]
        np.testing.assert_allclose(got.numpy(), box, atol=1e-3)
        one = sys_.segmentor.segment(
            torch.from_numpy(sys_.origin_frames[v])[None], got[None], 1)
        close(out.logits[i], one.logits[0], "logits")
        assert torch.equal(out.masks[i], one.masks[0])
    assert out.masks.shape == (4, 32, 32) and bool(out.hit.all())
    assert 0 < float(out.masks.mean()) < 1


def test_a_box_that_misses_its_view_takes_the_full_mask(nets):
    """A box behind every camera: each view falls back to the full mask,
    counted once per view in ``segment_counts`` with one host read."""
    sys_, _ = system(nets, box=[-0.1, 8.0, -0.1, 0.1, 8.2, 0.1])
    before = tracing.counters()
    out = sys_.segment_views()
    after = tracing.counters()
    assert not bool(out.hit.any()) and bool((out.masks == 1).all())
    delta = {k: after["segment_counts"][k] - before["segment_counts"][k]
             for k in ("views", "batches", "fallbacks")}
    assert delta == {"views": 4, "batches": 2, "fallbacks": 4}
    assert (after["host_syncs"]["seg.fallbacks"]
            - before["host_syncs"].get("seg.fallbacks", 0)) == 1


def test_spans_of_a_call(nets):
    """Under ``recording()``: ``seg.encode`` and ``seg.decode`` once a batch,
    ``seg.global_attn`` once a batch per global block inside its encode."""
    sys_, _ = system(nets)
    tracing.take()
    with tracing.recording():
        sys_.segment_views()
    spans = tracing.take()["spans"]
    names = [s["name"] for s in spans]
    assert names.count("seg.encode") == names.count("seg.decode") == 2
    enc = {s["id"] for s in spans if s["name"] == "seg.encode"}
    glob = [s for s in spans if s["name"] == "seg.global_attn"]
    assert len(glob) == 2 and all(s["parent"] in enc for s in glob)


def test_update_mask_through_sam2_equals_lifting_the_reference_masks(nets):
    """``update_mask`` with the ``sam2`` segmentor installs the mask that
    lifting the reference's masks of the same frames and boxes gives
    (``render_weights`` at the caps the system ended at, the threshold)."""
    sys_, poses = system(nets)
    sys_.update_mask()
    ref = nets[1]
    caps = sys_.lift_caps
    w = c = 0.0
    for v in sys_.view_list:
        mask = REF.predict(ref, torch.from_numpy(sys_.origin_frames[v]),
                           REF.box_in_view(BOX, poses[v]))["mask"]
        lift = TR.render_weights(sys_.scene, sys_.cameras[v], mask.float(),
                                 tile_px=16, chunk=16, **caps)
        assert int(lift.spill) == 0
        w, c = w + lift.weights, c + lift.counts
    frac = torch.where(c > 0, w / c.clamp(min=1.0), 0.0)
    want = ((frac > 0.8) & sys_.scene.alive).float()
    assert torch.equal(sys_.scene.grad_mask, want)
    assert 0 < float(want.sum()) < sys_.scene.n_alive


def test_cli_local_edit_with_sam2(tmp_path):
    """``--train --smoke --cpu system.segmentor=sam2 system.seg_box=...``
    with the tiny networks: the working views are segmented in batches of
    ``system.edit.camera_batch_size`` and the lifted mask is installed."""
    ply, capture = write_synthetic_capture(str(tmp_path), n_views=4)
    before = dict(SG.segment_counts)
    run = launch.main([
        "--train", "--smoke", "--cpu", "--gs_source", ply, "--source",
        capture, "--out", str(tmp_path / "out"), "data.height=32",
        "data.width=32", "data.max_view_num=4", "system.model_size=tiny",
        "system.seg_prompt=object", "system.segmentor=sam2",
        "system.seg_box=[-0.5,-0.5,-0.5,0.5,0.5,0.5]",
        "system.guidance.camera_batch_size=2",
        "system.guidance.diffusion_steps=2",
        "system.guidance.resize_target=64", "system.edit.max_steps=2",
        "system.edit.camera_batch_size=2", "system.edit.tile_px=16",
        "system.edit.chunk=16"])
    assert run.steps == 2 and run.losses_finite
    assert run.system.cfg.seg_box == [-0.5, -0.5, -0.5, 0.5, 0.5, 0.5]
    assert SG.segment_counts["views"] - before["views"] == 4
    assert SG.segment_counts["batches"] - before["batches"] == 2
    assert run.system.lift_spill == 0
    scene = run.system.scene
    assert 0 < float(scene.grad_mask.sum()) < scene.n_alive
    assert os.path.isdir(run.trial_dir)
