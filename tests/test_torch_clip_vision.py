"""The port's CLIP vision tower and edit-quality scorer
(``dge_tpu_torch/models/clip_vision.py``), its weight loaders
(``diffusion/weights.py``) and ``launch --train``'s CLIP edit metrics, on
the CPU with tiny towers.

- ``clip_vision_params_from_jax`` carries the JAX tiny tower across: image
  features within 1e-5 relative; ``ClipSimilarity``'s four outputs within
  1e-5 of JAX's on the same towers and tokenizer; identical images score
  ``sim_image`` 1.
- A tiny transformers ``CLIPModel`` saved as a local directory loads through
  ``load_clip_checkpoint`` (configs from its shapes and ``config.json``):
  image and text features within 1e-5 relative of transformers' own.
- ``--train --cpu system.clip_checkpoint=DIR`` writes ``clip_metrics.json``
  with the four means and ``n_views``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.models import clip_text as JCT
from dge_tpu.models import clip_vision as JCV
from dge_tpu_torch import launch
from dge_tpu_torch.diffusion import tokenizer as TT
from dge_tpu_torch.diffusion import weights as TW
from dge_tpu_torch.models import clip_vision as TCV
from dge_tpu_torch.models.clip_text import CLIPTextConfig
from tests.test_torch_render import write_synthetic_capture

REL = 1e-5


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_towers():
    """The JAX tiny vision tower and a tiny text tower with a 16-wide
    projection, with their parameters."""
    vcfg = JCV.CLIPVisionConfig.tiny()
    tcfg = JCT.CLIPTextConfig.tiny().replace(projection_dim=16)
    vision = JCV.CLIPVisionModel(vcfg)
    text = JCT.CLIPTextModel(tcfg)
    vparams = vision.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))["params"]
    tparams = text.init(jax.random.PRNGKey(1), jnp.ones((1, 16), jnp.int32),
                        return_pooled=True)["params"]
    return vision, host(vparams), text, host(tparams)


def _port_similarity(jax_towers, tokenizer):
    _, vparams, _, tparams = jax_towers
    return TCV.build_clip_similarity(
        {"vision": TW.clip_vision_params_from_jax(vparams),
         "text": TW.clip_text_params_from_jax(tparams)}, tokenizer,
        TCV.CLIPVisionConfig.tiny(),
        dataclasses.replace(CLIPTextConfig.tiny(), projection_dim=16),
        device="cpu")


def test_vision_tower_matches_jax(jax_towers):
    vision, vparams, _, _ = jax_towers
    r = np.random.default_rng(0)
    pixels = r.normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(vision.apply({"params": vparams}, pixels))
    sim = _port_similarity(jax_towers, TT.HashTokenizer(1000, 16))
    got = sim.vision(torch.from_numpy(pixels).permute(0, 3, 1, 2)).numpy()
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), err


def test_clip_similarity_matches_jax(jax_towers):
    """Images of another size (the resize shrinks them, antialiased), two
    prompts; the four similarities of the port's scorer against JAX's."""
    vision, vparams, text, tparams = jax_towers
    tok = TT.HashTokenizer(vocab_size=1000, max_length=16)
    jsim = JCV.ClipSimilarity(
        vision, vparams, lambda ids: text.apply({"params": tparams}, ids),
        tok, text_pooled_fn=lambda ids: text.apply(
            {"params": tparams}, ids, return_pooled=True)[1])
    tsim = _port_similarity(jax_towers, tok)
    r = np.random.default_rng(1)
    src = r.uniform(size=(3, 48, 40, 3)).astype(np.float32)
    edit = r.uniform(size=(3, 48, 40, 3)).astype(np.float32)
    texts = (["a photo of a man"] * 3, ["a clown"] * 3)
    want = jsim(src, edit, *texts)
    got = tsim(src, edit, *texts)
    for name, g, w in zip(("source", "edit", "direction", "image"), got,
                          want):
        assert g.shape == (3,) and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(w), atol=REL, rtol=0,
                                   err_msg=name)
    same = tsim(src, src, *texts)[3]
    np.testing.assert_allclose(same, 1.0, atol=REL)


def _tiny_transformers_clip(root):
    """A tiny transformers CLIPModel saved as a local directory (the
    legacy end-of-text rule: the largest id pools)."""
    import transformers

    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=1000, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=16,
                         eos_token_id=2),
        vision_config=dict(hidden_size=48, intermediate_size=64,
                           num_hidden_layers=3, num_attention_heads=3,
                           image_size=32, patch_size=8),
        projection_dim=24)
    torch.manual_seed(0)
    model = transformers.CLIPModel(cfg).eval()
    model.save_pretrained(root)
    return model


def test_transformers_checkpoint_round_trip(tmp_path):
    ref = _tiny_transformers_clip(str(tmp_path))
    ck = TW.load_clip_checkpoint(str(tmp_path))
    assert ck["vision_config"] == TCV.CLIPVisionConfig(
        image_size=32, patch_size=8, hidden_size=48, num_layers=3,
        num_heads=3, intermediate_size=64, projection_dim=24)
    assert ck["text_config"] == CLIPTextConfig(
        vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
        max_length=16, intermediate_size=64, projection_dim=24)
    sim = TCV.build_clip_similarity(ck, TT.HashTokenizer(1000, 16),
                                    ck["vision_config"], ck["text_config"],
                                    device="cpu")
    r = np.random.default_rng(2)
    pixels = torch.from_numpy(r.normal(size=(2, 3, 32, 32))
                              .astype(np.float32))
    ids = torch.from_numpy(TT.HashTokenizer(1000, 16)(["a clown", "a dog"]))
    with torch.no_grad():
        for got, want in ((sim.vision(pixels),
                           ref.get_image_features(pixel_values=pixels)),
                          (sim.text(ids, return_pooled=True)[1],
                           ref.get_text_features(input_ids=ids))):
            err = float((got - want).abs().max())
            assert err <= REL * float(want.abs().max()), err


def test_cli_clip_metrics(tmp_path):
    _tiny_transformers_clip(str(tmp_path / "clip"))
    ply, capture = write_synthetic_capture(str(tmp_path), n_views=4)
    run = launch.main([
        "--train", "--smoke", "--cpu", "--gs_source", ply, "--source",
        capture, "--out", str(tmp_path / "out"), "data.height=32",
        "data.width=32", "data.max_view_num=4", "system.model_size=tiny",
        f"system.clip_checkpoint={tmp_path / 'clip'}",
        "system.prompt=turn him into a clown",
        "system.guidance.camera_batch_size=2",
        "system.guidance.diffusion_steps=2",
        "system.guidance.resize_target=64", "system.edit.max_steps=2",
        "system.edit.tile_px=16", "system.edit.chunk=16"])
    with open(os.path.join(run.trial_dir, "clip_metrics.json")) as f:
        saved = json.load(f)
    assert saved == run.clip_metrics and saved["n_views"] == 4
    for k in ("clip_sim_source", "clip_sim_edit", "clip_sim_direction",
              "clip_sim_image"):
        assert np.isfinite(saved[k]) and -1.0 - 1e-6 <= saved[k] <= 1 + 1e-6
