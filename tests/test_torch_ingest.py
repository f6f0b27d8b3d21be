"""The port's checkpoint ingestion (``tools/ingest_checkpoint.py``,
``diffusion/weights.{save,load}_ingested``, ``is_ingested``) on tiny
diffusers-layout twins written as ``tests/test_ingest.py`` writes them
(``.bin`` state dicts, the VAE under the old attention names, the text
encoder with its ``position_ids`` buffer, a real-format vocabulary), and
``ddim.pred_x0`` against the JAX function.

Tolerances: the cache's tensors equal the checkpoint's, and the guidance
from either equal bit for bit; against the JAX guidance with its draws and
cross-view states handed over, ``EDIT_TOL`` (1e-3) as in
``tests/test_torch_edit.py``; ``pred_x0`` within 1e-6 (float32)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.diffusion import ddim as JD
from dge_tpu.parallel.mesh import stack_cameras as j_stack
from dge_tpu.systems import guidance as JG
from dge_tpu_torch import launch
from dge_tpu_torch.diffusion import ddim as TD
from dge_tpu_torch.diffusion import ip2p as TP
from dge_tpu_torch.diffusion import tokenizer as TT
from dge_tpu_torch.diffusion import weights as TW
from dge_tpu_torch.models.clip_text import CLIPTextConfig
from dge_tpu_torch.models.unet import UNetConfig
from dge_tpu_torch.models.vae import VAEConfig
from dge_tpu_torch.parallel.mesh import stack_cameras as t_stack
from dge_tpu_torch.systems import guidance as TG
from dge_tpu_torch.tools import ingest_checkpoint as TI
from tests.test_parallel import ring_cameras
from tests.test_torch_diffusion import (EDIT_TOL, jax_tiny_models,
                                        port_models_from)
from tests.test_torch_edit import KW, jax_draws, jax_states, port_cam


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module: the suite runs in parallel
    workers, and there small parallel regions at the default count wait on
    the other workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def write_vocab(tok_dir):
    """The minimal real-format vocabulary of tests/test_ingest.py."""
    b2u = TT.bytes_to_unicode()
    a, b = b2u[ord("a")], b2u[ord("b")]
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, a: 2, b: 3,
             b + "</w>": 4, a + b + "</w>": 5}
    os.makedirs(tok_dir, exist_ok=True)
    with open(os.path.join(tok_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(tok_dir, "merges.txt"), "w") as f:
        f.write(f"#version\n{a} {b}</w>\n")


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """The JAX tiny models, the port's models on their parameters, and
    those parameters as a diffusers-layout directory."""
    jm = jax_tiny_models()
    tm = port_models_from(jm)
    root = str(tmp_path_factory.mktemp("ckpt") / "src")
    vae = {}
    for k, v in tm.vae.state_dict().items():
        for new, old in ((".to_q.", ".query."), (".to_k.", ".key."),
                         (".to_v.", ".value."), (".to_out.0.", ".proj_attn.")):
            k = k.replace(new, old)
        vae[k] = v
    text = dict(tm.text_encoder.state_dict())
    text["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    for sub, sd, fname in (("unet", tm.unet.state_dict(),
                            "diffusion_pytorch_model.bin"),
                           ("vae", vae, "diffusion_pytorch_model.bin"),
                           ("text_encoder", text, "pytorch_model.bin")):
        os.makedirs(os.path.join(root, sub))
        torch.save(sd, os.path.join(root, sub, fname))
    write_vocab(os.path.join(root, "tokenizer"))
    return jm, tm, root


def build(params):
    return TP.build_models(UNetConfig.tiny(), VAEConfig.tiny(),
                           CLIPTextConfig.tiny(), params=params, device="cpu")


def test_ingest_round_trip(twin, tmp_path):
    _, tm, src = twin
    out = TI.ingest(src, str(tmp_path / "ingested"), vendor_tokenizer=False)
    assert TW.is_ingested(out) and not TW.is_ingested(src)
    with open(os.path.join(out, "manifest.json")) as f:
        mf = json.load(f)
    assert mf["format"] == TW.INGEST_FORMAT and mf["kind"] == "ip2p"
    assert mf["source"] == os.path.abspath(src)
    got, want = TW.load_ingested(out), TW.load_ip2p_checkpoint(src)
    assert set(got) == set(want) == {"unet", "vae", "text_encoder"}
    # the launcher's loader takes either directory
    for d, direct in ((out, got), (src, want)):
        via = TW.load_checkpoint(d, TW.load_ip2p_checkpoint)
        assert all(torch.equal(via["unet"][k], v)
                   for k, v in direct["unet"].items())
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        assert mf["param_counts"][name] == sum(
            v.numel() for v in want[name].values())
        for k, v in want[name].items():
            assert got[name][k].dtype == v.dtype, k
            assert torch.equal(got[name][k], v), k
    # the cache drives the models with the twin's exact weights
    for a, b in zip(build(got)[:3], tm[:3]):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka
    tok = TT.load_tokenizer(os.path.join(out, "tokenizer"), max_length=8)
    assert isinstance(tok, TT.CLIPTokenizer)
    assert list(tok("ab")[0][:3]) == [0, 5, 1]


def test_ingested_guidance_matches_raw_and_jax(twin, tmp_path,
                                               monkeypatch):
    """A guidance pass from the cache equals one from the checkpoint bit
    for bit, and the JAX guidance within EDIT_TOL with its draws and
    cross-view states handed over (test_torch_edit's setting)."""
    jm, _, src = twin
    out = TI.ingest(src, str(tmp_path / "ingested"), vendor_tokenizer=False)
    raw, cached = build(TW.load_ip2p_checkpoint(src)), build(
        TW.load_ingested(out))
    r = np.random.default_rng(5)
    b = 4
    rgb, cond = (r.uniform(size=(b, 32, 32, 3)).astype(np.float32)
                 for _ in range(2))
    pos, neg = (r.normal(size=(b, 7, 32)).astype(np.float32)
                for _ in range(2))
    jcams = ring_cameras(b, height=32, width=32)
    tcams = t_stack([port_cam(c) for c in jcams])
    args = [torch.from_numpy(x) for x in (rgb, cond, pos, neg)]
    a, c = (TG.DGEGuidance(TG.GuidanceConfig(**KW), m)(
        *args, tcams, torch.Generator().manual_seed(3), max_step=500)
        for m in (raw, cached))
    assert torch.equal(a, c) and bool(torch.isfinite(a).all())

    key = jax.random.PRNGKey(1)
    want = np.asarray(JG.DGEGuidance(JG.GuidanceConfig(**KW), jm)(
        rgb, cond, pos, neg, j_stack(jcams), key, max_step=500))
    draws = jax_draws(key, (b, 32, 32, 4), [373, 249, 125, 1], 2, 2)
    monkeypatch.setattr(TP, "_normal", draws.normal)
    monkeypatch.setattr(TG, "_pivot_offsets", draws.pivot_offsets)
    jax_states(jcams, monkeypatch)
    got = TG.DGEGuidance(TG.GuidanceConfig(**KW), cached)(
        *args, tcams, torch.Generator(), max_step=500).numpy()
    err = float(np.abs(got - want).max())
    assert got.shape == (b, 32, 32, 3) and err < EDIT_TOL, err


def test_ingest_cli_clip_and_vendoring(tmp_path, monkeypatch):
    """``--clip`` ingests a transformers CLIPModel directory (towers and
    configs); the vocabulary goes into the assets directory unless
    ``--no-vendor-tokenizer``."""
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config={"vocab_size": 100, "hidden_size": 32,
                     "intermediate_size": 64, "num_hidden_layers": 2,
                     "num_attention_heads": 2, "max_position_embeddings": 16,
                     "hidden_act": "quick_gelu"},
        vision_config={"hidden_size": 32, "intermediate_size": 64,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "image_size": 32, "patch_size": 8,
                       "hidden_act": "quick_gelu"},
        projection_dim=24)
    torch.manual_seed(7)
    src = tmp_path / "clip_src"
    src.mkdir()
    torch.save(CLIPModel(cfg).eval().state_dict(), src / "pytorch_model.bin")
    write_vocab(str(src))
    assets = tmp_path / "assets"
    monkeypatch.setattr(TT, "ASSETS_TOKENIZER_DIR", str(assets))
    out = TI.main([str(src), "--out", str(tmp_path / "c1"), "--clip",
                   "--no-vendor-tokenizer"])
    assert not assets.exists()
    got, want = TW.load_ingested(out), TW.load_clip_checkpoint(str(src))
    assert set(got) == set(want)
    assert got["vision_config"] == want["vision_config"]
    assert got["text_config"] == want["text_config"]
    for name in ("vision", "text"):
        assert got[name].keys() == want[name].keys()
        for k, v in want[name].items():
            assert torch.equal(got[name][k], v), k
    TI.main([str(src), "--out", str(tmp_path / "c2"), "--clip"])
    assert sorted(os.listdir(assets)) == ["merges.txt", "vocab.json"]


def test_jax_orbax_cache_is_refused(twin, tmp_path):
    """The JAX package's orbax cache is not this package's: is_ingested is
    False, loading it names the port's tool, and --train refuses it rather
    than running random weights."""
    jax_cache = tmp_path / "orbax"
    jax_cache.mkdir()
    with open(jax_cache / "manifest.json", "w") as f:
        json.dump({"format": "dge_tpu_ip2p_orbax_v1",
                   "param_counts": {"unet": 1}}, f)
    assert not TW.is_ingested(str(jax_cache))
    with pytest.raises(ValueError, match="dge_tpu_torch.tools.ingest_check"):
        TW.load_ingested(str(jax_cache))
    with pytest.raises(ValueError, match="dge_tpu_ip2p_orbax_v1"):
        TW.check_not_jax_ingest(str(jax_cache))
    with pytest.raises(ValueError, match="dge_tpu_ip2p_orbax_v1"):
        TW.load_checkpoint(str(jax_cache), TW.load_ip2p_checkpoint)
    TW.check_not_jax_ingest(twin[2])  # a diffusers directory passes
    from tests.test_torch_render import write_synthetic_capture

    ply, capture = write_synthetic_capture(str(tmp_path / "cap"))
    with pytest.raises(ValueError, match="orbax cache of the JAX package"):
        launch.main(["--train", "--smoke", "--cpu", "--gs_source", ply,
                     "--source", capture, "--out", str(tmp_path / "o"),
                     f"system.ip2p_checkpoint={jax_cache}",
                     "system.model_size=tiny"])


def test_pred_x0_matches_jax():
    r = np.random.default_rng(0)
    eps = r.normal(size=(2, 8, 8, 4)).astype(np.float32)
    x = r.normal(size=(2, 8, 8, 4)).astype(np.float32)
    js, ts = JD.make_schedule(), TD.make_schedule(device="cpu")
    for t in (1, 261, 999):
        want = np.asarray(JD.pred_x0(js, jnp.asarray(eps), jnp.asarray(t),
                                     jnp.asarray(x)))
        got = TD.pred_x0(ts, torch.from_numpy(eps), t, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
        # step goes through it, with the bits of its own former expression
        a_t, a_prev = ts.alphas_cumprod[t], (
            ts.alphas_cumprod[t - 50] if t >= 50 else ts.final_alpha_cumprod)
        e, xt = torch.from_numpy(eps), torch.from_numpy(x)
        inline = (xt - torch.sqrt(1.0 - a_t) * e) / torch.sqrt(a_t)
        assert torch.equal(got, inline)
        assert torch.equal(TD.step(ts, e, t, xt, 20),
                           torch.sqrt(a_prev) * inline
                           + torch.sqrt(1.0 - a_prev) * e)
