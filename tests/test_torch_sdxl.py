"""The SDXL InstructPix2Pix editor in the port (``UNetConfig.tiny_xl``, the
two text towers, ``ip2p.preset_configs("sdxl768")``) against the plain
reference ``benchmark/reference/sdxl.py``, on the CPU with seeded random
weights at two threads; and the edit system's host read of bf16 frames.

Tolerances. The float32 comparisons hold the port to 1e-4 of the
reference's largest magnitude, the repo's rule for the same arithmetic in
another order (``test_bench_reference.py``: the SD-1.5 round). The bf16
round is held to ``test_torch_bf16.py``'s rules against its own float32
run: within the frames' range and a mean gap under 2e-2.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.drivers import common as C
from benchmark.reference import dge, sd15, sdxl
from benchmark.yardstick import scene as S
from benchmark.yardstick import weights as WT
from dge_tpu_torch import launch
from dge_tpu_torch.diffusion import ip2p as P
from dge_tpu_torch.diffusion import weights as W
from dge_tpu_torch.models.layers import CrossViewState
from dge_tpu_torch.parallel.mesh import stack_cameras
from dge_tpu_torch.systems import edit as E
from dge_tpu_torch.systems import guidance as GD
from dge_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny XL layout in diffusers' keys (UNetConfig.tiny_xl,
# CLIPTextConfig.tiny_xl)
UNET = {"in_channels": 8, "out_channels": 4,
        "block_out_channels": [16, 32, 64], "layers_per_block": 1,
        "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                             "CrossAttnDownBlock2D"],
        "attention_head_dim": [2, 4, 8],
        "transformer_layers_per_block": [1, 2, 3],
        "cross_attention_dim": 32, "use_linear_projection": True,
        "norm_num_groups": 8, "addition_time_embed_dim": 8,
        "projection_class_embeddings_input_dim": 72}
VAE = {"in_channels": 3, "latent_channels": 4, "block_out_channels": [16, 32],
       "layers_per_block": 1, "norm_num_groups": 8, "scaling_factor": 0.13025}
TEXT = {"vocab_size": 1000, "hidden_size": 16, "num_hidden_layers": 2,
        "num_attention_heads": 2, "max_position_embeddings": 16,
        "intermediate_size": 32, "hidden_act": "quick_gelu"}
TEXT_2 = dict(TEXT, intermediate_size=64, hidden_act="gelu",
              projection_dim=24)


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, ref, rel=1e-4):
    scale = float(ref.abs().max())
    gap = float((got.float() - ref.float()).abs().max())
    assert gap <= rel * scale, (gap, scale)


@pytest.fixture(scope="module")
def nets():
    """The tiny XL networks: the reference's and the port's (float32), one
    seeded state dict."""
    ref = {"unet": sdxl.UNet(UNET), "vae": sd15.VAE(VAE),
           "text_encoder": sdxl.TextTower(TEXT),
           "text_encoder_2": sdxl.TextTower(TEXT_2)}
    shapes = {k: sd15.names_and_shapes(m) for k, m in ref.items()}
    flat = [(f"{k}/{n}", s) for k, v in shapes.items() for n, s in v]
    drawn = WT.draw(flat, 5, "cpu", torch.float32)
    w = {k: {n: drawn[f"{k}/{n}"] for n, _ in v} for k, v in shapes.items()}
    for k, m in ref.items():
        m.load_state_dict(w[k])
        m.eval().requires_grad_(False)
    cfgs = P.preset_configs("sdxl768", tiny=True)
    port = P.build_models(*cfgs[:3], params=w, device="cpu",
                          text_cfg_2=cfgs[3])
    return ref, port, w


def _inputs(b, seed=0, hw=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 8, hw, hw, generator=g)
    ctx = torch.randn(b, 7, 32, generator=g)
    pooled = torch.randn(b, 24, generator=g)
    return x, ctx, pooled


def _time_ids(b, hw, down=2):
    """The time ids ``unet_eps`` gives [b, h, w] latents (the tiny VAE
    scales by 2)."""
    return sdxl.time_ids(down * hw, down * hw).expand(b, 6)


def _cross_view(f, hw, seed=1):
    """A 2-key cross-view state for ``f`` frames at the tiny UNet's
    attended sizes, the same tensors for both."""
    g = torch.Generator().manual_seed(seed)
    lines, pts = {}, {}
    for ds in (2, 4):
        s = (hw // ds) ** 2
        lines[s] = torch.randn(f, 2, s, 3, generator=g)
        pts[s] = dge.pixel_grid(hw // ds, hw // ds, "cpu")
    closest = torch.randint(0, 2, (f, 2), generator=g)
    w1 = torch.rand(f, generator=g)
    ref = sd15.CrossView(closest, w1, lines, pts, 2, 1.0)
    port = CrossViewState(closest_cam=closest, blend_w1=w1, epi_lines=lines,
                          epi_pts=pts, n_key=2, epi_threshold=1.0)
    return ref, port


@pytest.mark.parametrize("mode", ["plain", "pivot_record", "pivot_reuse"])
def test_tiny_xl_unet_matches_the_reference(nets, mode):
    """The tiny XL UNet in each cross-view mode against the reference (the
    reuse reading each side's own pivot record)."""
    ref, port, _ = nets
    hw = 8
    kw_ref, kw_port = {}, {}
    if mode != "plain":
        rec_ref, rec_port = {}, {}
        x, ctx, pooled = _inputs(6, seed=2)
        ref["unet"](x, 500, ctx, pooled, _time_ids(6, hw),
                    mode="pivot_record", pivot=rec_ref)
        P.unet_eps(port, P.nhwc(x), 500, ctx, pooled, mode="pivot_record",
                   pivot=rec_port)
        assert set(rec_ref) == set(rec_port) and len(rec_ref) == 18
        kw_ref = dict(mode=mode, pivot=rec_ref)
        kw_port = dict(mode=mode, pivot=rec_port)
        if mode == "pivot_reuse":
            cv_ref, cv_port = _cross_view(3, hw)
            kw_ref["cross_view"], kw_port["cross_view"] = cv_ref, cv_port
    b = 9 if mode == "pivot_reuse" else 6
    x, ctx, pooled = _inputs(b)
    want = ref["unet"](x, 321, ctx, pooled, _time_ids(b, hw), **kw_ref)
    got = P.unet_eps(port, P.nhwc(x), 321, ctx, pooled, **kw_port)
    _close(P.nchw(got), want)


def test_added_embedding(nets):
    """The time ids are (H, W, 0, 0, H, W) of the frames, made on the
    device; the pooled embedding and the time ids both move the output,
    and the port follows the reference under each."""
    ref, port, _ = nets
    ids = P.time_ids(port, 8, 6, 2)
    np.testing.assert_array_equal(ids.numpy(), [[16, 12, 0, 0, 16, 12]] * 2)
    x, ctx, pooled = _inputs(3)
    outs = []
    for p, hw in ((pooled, 8), (pooled.flip(0), 8), (pooled, 4)):
        t_ids = _time_ids(3, hw)
        want = ref["unet"](x, 400, ctx, p, t_ids)
        got = port.unet(x, torch.full((3,), 400), ctx, text_embeds=p,
                        time_ids=t_ids)
        _close(got, want)
        outs.append(got)
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3
    assert float((outs[0] - outs[2]).abs().max()) > 1e-3
    with pytest.raises(ValueError):
        port.unet(x, 400, ctx)


def test_text_towers_match_the_reference(nets):
    """The quick-GELU and GELU towers at their penultimate layer, the
    pooled projection of the GELU tower's end token, and their
    concatenation as ``ip2p.encode_text`` gives it."""
    ref, port, _ = nets
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(1, 900, (2, 16), generator=g)
    ids[:, 9:] = 999  # the end token (the largest id) and its padding
    ids_2 = ids.clone()
    ids_2[:, 10:] = 0  # the second tokenizer pads with "!"
    for tower, r, i in (("text_encoder", ref["text_encoder"], ids),
                        ("text_encoder_2", ref["text_encoder_2"], ids_2)):
        want, want_pooled = r(i)
        got = getattr(port, tower)(i)
        _close(got, want)
    _, want_pooled = ref["text_encoder_2"](ids_2)
    states, pooled = P.encode_text(port, ids, ids_2)
    want_states, want_pooled = sdxl.encode_prompt(
        ref["text_encoder"], ref["text_encoder_2"], ids, ids_2)
    assert states.shape == (2, 16, 32) and pooled.shape == (2, 24)
    _close(states, want_states)
    _close(pooled, want_pooled)
    # the penultimate state is not the final norm's output
    assert float((states[..., :16] - port.text_encoder.text_model
                  .final_layer_norm(states[..., :16])).abs().max()) > 1e-2


def _round_inputs(n=4, hw=64):
    g = torch.Generator().manual_seed(0)
    rgb = torch.rand(n, hw, hw, 3, generator=g)
    cond = torch.rand(n, hw, hw, 3, generator=g)
    pos, neg = (torch.randn(1, 7, 32, generator=g) for _ in range(2))
    pp, pn = (torch.randn(1, 24, generator=g) for _ in range(2))
    cams = [C.program_camera(c, "cpu") for c in S.orbit_cameras(n, hw, hw)]
    return rgb, cond, pos, neg, pp, pn, cams


def test_tiny_round_through_the_guidance_matches_the_reference(nets):
    """One whole DGE round (4 views at 64², camera batch 2, 3 DDIM steps
    from t 998: two pivot steps with the batched reuse and one plain step)
    through ``DGEGuidance`` against ``sdxl.edit_round`` on the same draws;
    the cross-view states only at the UNet's attended sizes."""
    ref, port, _ = nets
    rgb, cond, pos, neg, pp, pn, cams = _round_inputs()
    guide = GD.DGEGuidance(GD.GuidanceConfig(
        camera_batch_size=2, diffusion_steps=3, batch_mode="vmap",
        resize_target=64, vae_batch=2), port)
    assert guide.downscales == (2, 4)
    built = []
    real = GD.make_cross_view_state

    def spy(*a, **k):
        built.append(real(*a, **k))
        return built[-1]

    GD.make_cross_view_state = spy
    try:
        got = guide(rgb, cond, pos.expand(4, -1, -1), neg.expand(4, -1, -1),
                    stack_cameras(cams), torch.Generator().manual_seed(11),
                    max_step=999, pooled_pos=pp.expand(4, -1),
                    pooled_neg=pn.expand(4, -1))
    finally:
        GD.make_cross_view_state = real
    # latents of 32² (the tiny VAE scales by 2): 16² and 8² tokens
    assert built and all(sorted(cv.epi_lines) == [64, 256] for cv in built)
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "ip2p-sd15-bf16.json")) as f:
        rc = dict(json.load(f)["recipe"], camera_batch_size=2,
                  diffusion_steps=3)
    want = sdxl.edit_round(
        ref["unet"], ref["vae"], rgb, cond, pos.expand(4, -1, -1),
        neg.expand(4, -1, -1), pp, pn,
        torch.stack([c.full_proj for c in cams]),
        torch.stack([c.campos for c in cams]),
        torch.Generator().manual_seed(11), rc, 998)
    _close(got, want)


def test_sdxl_diffusers_directory_loads_by_name(nets, tmp_path):
    """A diffusers-named SDXL directory (``unet/``, ``vae/``,
    ``text_encoder/``, ``text_encoder_2/``) loads by name into the tiny XL
    build; the SD-1.5 layout of three networks still loads as three."""
    _, port, w = nets
    for sub, name in (("unet", "diffusion_pytorch_model.bin"),
                      ("vae", "diffusion_pytorch_model.bin"),
                      ("text_encoder", "pytorch_model.bin"),
                      ("text_encoder_2", "pytorch_model.bin")):
        os.makedirs(tmp_path / sub)
        torch.save(w[sub], str(tmp_path / sub / name))
    loaded = W.load_ip2p_checkpoint(str(tmp_path))
    assert set(loaded) == {"unet", "vae", "text_encoder", "text_encoder_2"}
    assert ("down_blocks.2.attentions.0.transformer_blocks.2.attn1.to_q"
            ".weight") in loaded["unet"]
    assert "add_embedding.linear_1.weight" in loaded["unet"]
    cfgs = P.preset_configs("sdxl768", tiny=True)
    again = P.build_models(*cfgs[:3], params=loaded, device="cpu",
                           text_cfg_2=cfgs[3])
    for net in ("unet", "vae", "text_encoder", "text_encoder_2"):
        a, b = (getattr(m, net).state_dict() for m in (port, again))
        assert all(torch.equal(a[k], b[k]) for k in a), net
    for sub in ("text_encoder_2",):
        for f in os.listdir(tmp_path / sub):
            os.remove(tmp_path / sub / f)
        os.rmdir(tmp_path / sub)
    assert set(W.load_ip2p_checkpoint(str(tmp_path))) == {
        "unet", "vae", "text_encoder"}


def test_pivot_record_bytes_counts_the_record(nets):
    """The counter group grows, by token count, by the bytes of the normed
    states and attention outputs the pivot pass records; the reuse's
    argmax is the span ``attn.reuse_match``."""
    _, port, _ = nets
    before = dict(tracing.group("pivot_record_bytes"))
    x, ctx, pooled = _inputs(6)
    record = {}
    P.unet_eps(port, P.nhwc(x), 500, ctx, pooled, mode="pivot_record",
               pivot=record)
    after = tracing.counters()["pivot_record_bytes"]
    want = {}
    for n, a in record.values():
        want[n.shape[1]] = want.get(n.shape[1], 0) + n.nbytes + a.nbytes
    assert set(want) == {16, 4}
    assert {k: after[k] - before.get(k, 0) for k in want} == want
    _, cv = _cross_view(3, 8)
    x, ctx, pooled = _inputs(9)
    tracing.take()
    with tracing.recording():
        P.unet_eps(port, P.nhwc(x), 500, ctx, pooled, mode="pivot_reuse",
                   cross_view=cv, pivot=record)
    spans = tracing.take()["spans"]
    match = [s for s in spans if s["name"] == "attn.reuse_match"]
    assert len(match) == 18
    assert {s["attrs"]["tokens"] for s in match} == {16, 4}
    assert all(s["parent"] is not None for s in match)


def _system(models, hw=64, n=4):
    cfg_scene = S.gt_scene(3, sh_degree=1, sh_rest_std=0.04, scale=0.003)
    scene = C.program_scene(cfg_scene, 1, "cpu")
    poses = S.orbit_cameras(n, hw, hw)
    cams = [C.program_camera(c, "cpu") for c in poses]
    g = GD.DGEGuidance(GD.GuidanceConfig(
        camera_batch_size=2, diffusion_steps=2, batch_mode="vmap",
        resize_target=hw, vae_batch=2), models)
    d = models.unet.config.cross_attention_dim
    gen = torch.Generator().manual_seed(1)
    pooled = {}
    if models.text_encoder_2 is not None:
        p = models.text_encoder_2.config.projection_dim
        pooled = {"pooled_pos": torch.randn(1, p, generator=gen),
                  "pooled_neg": torch.randn(1, p, generator=gen)}
    return E.DGESystem(
        E.EditConfig(max_view_num=n, camera_batch_size=2, tile_px=16,
                     chunk=16),
        scene, cams, guidance=g,
        text_emb_pos=torch.randn(1, 7, d, generator=gen),
        text_emb_neg=torch.randn(1, 7, d, generator=gen),
        cameras_extent=S.cameras_extent(poses), **pooled)


@pytest.mark.parametrize("editor", ["sd15", "sdxl768"])
def test_edit_all_views_takes_bf16_networks(editor):
    """``edit_all_views`` with bf16 networks (the tiny layout of each
    editor) hands the frames to the host as float32, within the bf16
    rules of the float32 run's frames; the float32 frames are those of
    the guidance itself, quantised."""
    cfgs = P.preset_configs(editor, tiny=True)
    frames = {}
    for dt in (torch.float32, torch.bfloat16):
        models = P.build_models(*cfgs[:3], seed=2, device="cpu", dtype=dt,
                                text_cfg_2=cfgs[3])
        system = _system(models)
        system.render_all_views()
        system.edit_all_views(E.step_generator(5, 1_000_000, "cpu"))
        frames[dt] = np.stack([system.edit_frames[v] for v in range(4)])
        assert frames[dt].dtype == np.float32
    f32, bf = frames[torch.float32], frames[torch.bfloat16]
    assert 0.0 <= bf.min() <= bf.max() <= 1.0
    assert float(np.abs(bf - f32).mean()) < 2e-2


def test_cli_train_sdxl_tiny_on_cpu(tmp_path):
    """``--train --smoke --cpu system.editor=sdxl768 system.model_size=tiny``
    builds the XL layout through the normal path: two towers, pooled
    prompts, the edit round and the refit."""
    from tests.test_torch_render import write_synthetic_capture

    ply, capture = write_synthetic_capture(str(tmp_path), n_views=4)
    run = launch.main([
        "--train", "--smoke", "--cpu", "--gs_source", ply, "--source",
        capture, "--out", str(tmp_path / "out"), "data.height=32",
        "data.width=32", "data.max_view_num=4", "system.model_size=tiny",
        "system.editor=sdxl768", "system.prompt=make it snowy",
        "system.guidance.camera_batch_size=2",
        "system.guidance.diffusion_steps=2",
        "system.guidance.resize_target=64", "system.edit.max_steps=2",
        "system.edit.tile_px=16", "system.edit.chunk=16"])
    models = run.system.guidance.models
    assert models.text_encoder_2 is not None
    assert models.unet.config.addition_embed_type == "text_time"
    assert run.system.pooled_pos.shape == (1, 24)
    assert len(run.edit_frames) == 4 and run.losses_finite


def test_second_tokenizer_pads_as_its_config_says(tmp_path):
    """A tokenizer directory whose ``tokenizer_config.json`` names ``"!"``
    as its pad token (SDXL's ``tokenizer_2/``) pads with it; without the
    file the end token pads, as before."""
    from dge_tpu_torch.diffusion import tokenizer as T

    vocab = {"!": 0, "a</w>": 1, "<|startoftext|>": 2, "<|endoftext|>": 3}
    for sub, cfg in (("tokenizer", None),
                     ("tokenizer_2", {"pad_token": {"content": "!"}})):
        d = tmp_path / sub
        os.makedirs(d)
        (d / "vocab.json").write_text(json.dumps(vocab))
        (d / "merges.txt").write_text("#version: 0.2\n")
        if cfg:
            (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    ids = [T.load_tokenizer(str(tmp_path / s), max_length=6)("a")[0].tolist()
           for s in ("tokenizer", "tokenizer_2")]
    assert ids == [[2, 1, 3, 3, 3, 3], [2, 1, 3, 0, 0, 0]]
