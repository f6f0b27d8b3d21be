"""The port's diffusion networks (``dge_tpu_torch/models/{layers,unet,vae,
clip_text}.py``) against the JAX package's, at small widths on the CPU.

JAX parameters (random, every leaf perturbed so that norms and biases are
not trivial) are carried across with ``*_params_from_jax``, and the same
numpy inputs go through both packages: ``ResnetBlock2D``, ``Attention``
(dense, and chunked when a small threshold forces it), the transformer
block in each cross-view mode, ``Transformer2DModel``, Down/Upsample in both
paddings, the VAE (moments, decode), the UNet and the CLIP text encoder. The
other way round, a port state dict goes through JAX's ``convert_*`` into the
JAX models; and a tiny diffusers-layout directory written with
``safetensors`` loads into the port. Tolerance ``atol=3e-5, rtol=1e-4``
(tests/test_model_parity.py); the CLIP text encoder 1e-5. TF32 is off."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.diffusion import weights as JW
from dge_tpu.models import clip_text as JC
from dge_tpu.models import layers as JL
from dge_tpu.models import unet as JU
from dge_tpu.models import vae as JV
from dge_tpu.parallel.mesh import stack_cameras as j_stack
from dge_tpu.systems import guidance as JG
from dge_tpu_torch.diffusion import ip2p as TP
from dge_tpu_torch.diffusion import weights as TW
from dge_tpu_torch.models import clip_text as TC
from dge_tpu_torch.models import layers as TL
from dge_tpu_torch.models import unet as TU
from dge_tpu_torch.models import vae as TV
from tests.test_parallel import ring_cameras

TOL = dict(atol=3e-5, rtol=1e-4)
CLIP_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def perturbed(params, seed):
    """The JAX parameters as numpy, every leaf moved by N(0, 0.05)."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * r.normal(size=np.shape(a))
                   ).astype(np.float32), params)


def init(module, seed, *args, **kw):
    return perturbed(module.init(jax.random.PRNGKey(seed), *args,
                                 **kw)["params"], seed)


def carried(module, params, convert=TW.unet_params_from_jax):
    module.load_state_dict(convert(params))
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def t_(x):
    return torch.from_numpy(np.asarray(x))


# ---- blocks ---------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,temb,eps", [
    (16, 16, 32, 1e-5), (16, 32, 32, 1e-5), (16, 32, None, 1e-6)])
def test_resnet_block(cin, cout, temb, eps):
    r = np.random.default_rng(cin + cout)
    x = r.normal(size=(2, 8, 8, cin)).astype(np.float32)
    te = r.normal(size=(2, temb)).astype(np.float32) if temb else None
    jm = JL.ResnetBlock2D(cout, groups=8, eps=eps)
    p = init(jm, 1, jnp.asarray(x), None if te is None else jnp.asarray(te))
    want = jm.apply({"params": p}, x, te)
    tm = carried(TL.ResnetBlock2D(cin, cout, temb, 8, eps), p)
    got = tm(nchw(x), None if te is None else t_(te))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("context", [False, True])
def test_attention(chunked, context, monkeypatch):
    """Dense, and the online-softmax loop over key blocks forced by a small
    threshold (k_chunk 512 over 600 keys: a short last block)."""
    if chunked:
        monkeypatch.setattr(JL.Attention, "CHUNKED_LOGITS_THRESHOLD", 64)
        monkeypatch.setattr(TL, "CHUNKED_LOGITS_THRESHOLD", 64)
    r = np.random.default_rng(7)
    x = r.normal(size=(2, 600, 32)).astype(np.float32)
    ctx = r.normal(size=(2, 9, 24)).astype(np.float32) if context else None
    jm = JL.Attention(32, 2, 16, context_dim=24 if context else None)
    p = init(jm, 2, jnp.asarray(x), None if ctx is None else jnp.asarray(ctx))
    want = jm.apply({"params": p}, x, ctx)
    tm = carried(TL.Attention(32, 2, 16, 24 if context else None), p)
    got = tm(t_(x), None if ctx is None else t_(ctx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_extended_attention_chunked(monkeypatch):
    """Extended attention (K/V over the frames of each CFG chunk) through
    the chunked loop at k_chunk 1024."""
    monkeypatch.setattr(JL.Attention, "CHUNKED_LOGITS_THRESHOLD", 64)
    monkeypatch.setattr(TL, "CHUNKED_LOGITS_THRESHOLD", 64)
    r = np.random.default_rng(8)
    x = r.normal(size=(6, 400, 32)).astype(np.float32)  # 3 chunks x 2 frames
    jm = JL.Attention(32, 2, 16)
    p = init(jm, 3, jnp.asarray(x))
    want = jm.apply({"params": p}, x, extended_frames=2)
    tm = carried(TL.Attention(32, 2, 16), p)
    got = tm(t_(x), extended_frames=2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _block_inputs(r, frames, s, d=32, ctx_dim=24):
    x = r.normal(size=(3 * frames, s, d)).astype(np.float32)
    ctx = r.normal(size=(3 * frames, 5, ctx_dim)).astype(np.float32)
    return x, ctx


def port_state(jcv):
    """A JAX CrossViewState carried into the port's (the block tests hold
    the blocks alone; the state's own parity is in test_torch_diffusion)."""

    def conv(d):
        return None if d is None else {s: t_(v) for s, v in d.items()}

    return TL.CrossViewState(
        closest_cam=t_(jcv.closest_cam).long(), blend_w1=t_(jcv.blend_w1),
        epipolar=conv(jcv.epipolar), epi_lines=conv(jcv.epi_lines),
        epi_pts=conv(jcv.epi_pts), n_key=jcv.n_key,
        epi_threshold=jcv.epi_threshold)


def _states(n_key, mode, latent=4):
    """The JAX cross-view state of a 2-frame batch against 2 key cameras
    (pivot frame 1), and the same state in the port's form."""
    jcams = j_stack(ring_cameras(2, height=32, width=32))
    jkeys = j_stack(ring_cameras(2, height=32, width=32, dist=3.4))
    jcv = JG.make_cross_view_state(jcams, jkeys, jnp.asarray(1), latent,
                                   latent, n_key, 1.0, mode)
    return jcv, port_state(jcv)


@pytest.mark.parametrize("mode", ["plain", "extended", "pivot_record",
                                  "reuse_banded_1", "reuse_banded_2",
                                  "reuse_dense_1", "reuse_dense_2"])
def test_transformer_block_modes(mode):
    """BasicTransformerBlock in every cross-view mode; the pivot record
    (normed hidden states, attention output) equal too; the reuse gather
    on both epipolar forms with one and two key cameras."""
    r = np.random.default_rng(11)
    x, ctx = _block_inputs(r, 2, 16)
    jm = JL.BasicTransformerBlock(32, 2, 16, 24)
    p = init(jm, 4, jnp.asarray(x), jnp.asarray(ctx))
    tm = carried(TL.BasicTransformerBlock(32, 2, 16, 24), p)
    if mode in ("plain", "extended"):
        want = jm.apply({"params": p}, x, ctx, mode=mode)
        got = tm(t_(x), t_(ctx), mode=mode)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        return
    xk, ck = _block_inputs(r, 2, 16)  # the key frames' pass
    want, jvars = jm.apply({"params": p}, xk, ck, mode="pivot_record",
                           mutable=["pivot"])
    record = {}
    got = tm(t_(xk), t_(ck), mode="pivot_record", pivot=record)
    if mode == "pivot_record":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        hidden, attn_out = record[""]
        np.testing.assert_allclose(hidden.detach().numpy(),
                                   np.asarray(jvars["pivot"]["hidden"][0]),
                                   **TOL)
        np.testing.assert_allclose(
            attn_out.detach().numpy(),
            np.asarray(jvars["pivot"]["attn_out"][0]), **TOL)
        return
    _, form, n_key = mode.split("_")
    jcv, tcv = _states(int(n_key), form)
    want = jm.apply({"params": p, "pivot": jvars["pivot"]}, x, ctx,
                    mode="pivot_reuse", cross_view=jcv)
    got = tm(t_(x), t_(ctx), mode="pivot_reuse", cross_view=tcv,
             pivot=record)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_transformer2d():
    r = np.random.default_rng(12)
    x = r.normal(size=(2, 4, 4, 32)).astype(np.float32)
    ctx = r.normal(size=(2, 5, 24)).astype(np.float32)
    jm = JL.Transformer2DModel(32, 2, 16, 24, groups=8)
    p = init(jm, 5, jnp.asarray(x), jnp.asarray(ctx))
    want = jm.apply({"params": p}, x, ctx)
    tm = carried(TL.Transformer2DModel(32, 2, 16, 24, 8), p)
    np.testing.assert_allclose(nhwc(tm(nchw(x), t_(ctx))), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("kind", ["down_vae", "down_unet", "up"])
def test_resampling(kind):
    """Downsample2D with the VAE's (0,1,0,1) and the UNet's symmetric pad;
    nearest Upsample2D."""
    r = np.random.default_rng(13)
    x = r.normal(size=(2, 8, 8, 16)).astype(np.float32)
    if kind == "up":
        jm, tm = JL.Upsample2D(16), TL.Upsample2D(16)
    else:
        pad = 0 if kind == "down_vae" else 1
        jm, tm = JL.Downsample2D(16, padding=pad), TL.Downsample2D(16, pad)
    p = init(jm, 6, jnp.asarray(x))
    want = jm.apply({"params": p}, x)
    np.testing.assert_allclose(nhwc(carried(tm, p)(nchw(x))),
                               np.asarray(want), **TOL)


def test_timestep_embedding():
    t = np.array([1, 250, 999], np.int32)
    want = JL.timestep_embedding(jnp.asarray(t), 32)
    got = TL.timestep_embedding(torch.from_numpy(t), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- whole models ----------------------------------------------------------

@pytest.fixture(scope="module")
def unets():
    cfg = JU.UNetConfig.tiny()
    jm = JU.UNet2DConditionModel(cfg)
    p = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8, 8, 8)),
                                   jnp.zeros((1,), jnp.int32),
                                   jnp.zeros((1, 7, 32)))["params"], 0)
    tm = carried(TU.UNet2DConditionModel(TU.UNetConfig.tiny()), p)
    return jm, p, tm


def test_unet_plain(unets):
    jm, p, tm = unets
    r = np.random.default_rng(14)
    x = r.normal(size=(2, 8, 8, 8)).astype(np.float32)
    ctx = r.normal(size=(2, 7, 32)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    want = jax.jit(lambda p, x, t, c: jm.apply({"params": p}, x, t, c))(
        p, x, t, ctx)
    got = tm(nchw(x), torch.from_numpy(t), t_(ctx))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_key", [1, 2])
def test_unet_pivot_record_and_reuse(unets, n_key):
    """The whole UNet's pivot pass (2 key frames) and a reuse pass (2
    frames) through every transformer block at 8x8 and 4x4."""
    jm, p, tm = unets
    r = np.random.default_rng(15)
    xk = r.normal(size=(6, 8, 8, 8)).astype(np.float32)
    xq = r.normal(size=(6, 8, 8, 8)).astype(np.float32)
    ctx = r.normal(size=(6, 7, 32)).astype(np.float32)
    t = np.full((6,), 400, np.int32)
    want_k, jvars = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, t, ctx, mode="pivot_record",
        mutable=["pivot"]))(p, xk)
    record = {}
    got_k = tm(nchw(xk), torch.from_numpy(t), t_(ctx), mode="pivot_record",
               pivot=record)
    np.testing.assert_allclose(nhwc(got_k), np.asarray(want_k), **TOL)
    assert len(record) == 4  # down 0, mid, up 1 (two)
    jcv, tcv = _states(n_key, "banded", latent=8)
    want = jax.jit(lambda p, v, x, cv: jm.apply(
        {"params": p, "pivot": v}, x, t, ctx, mode="pivot_reuse",
        cross_view=cv))(p, jvars["pivot"], xq, jcv)
    got = tm(nchw(xq), torch.from_numpy(t), t_(ctx), mode="pivot_reuse",
             cross_view=tcv, pivot=record)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def vaes():
    cfg = JV.VAEConfig.tiny()
    jm = JV.AutoencoderKL(cfg)
    p = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 16, 16, 3)))["params"], 1)
    return jm, p, carried(TV.AutoencoderKL(TV.VAEConfig.tiny()), p,
                          TW.vae_params_from_jax)


def test_vae_moments_and_decode(vaes):
    jm, p, tm = vaes
    r = np.random.default_rng(16)
    x = r.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    jmean, jlogvar = jm.apply({"params": p}, x, method=jm.encode_moments)
    mean, logvar = tm.encode_moments(nchw(x))
    np.testing.assert_allclose(nhwc(mean), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(nhwc(logvar), np.asarray(jlogvar), **TOL)
    z = r.normal(size=(2, 8, 8, 4)).astype(np.float32)
    want = jm.apply({"params": p}, z, method=jm.decode)
    np.testing.assert_allclose(nhwc(tm.decode(nchw(z))), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("projection", [None, 16])
def test_clip_text(projection):
    """Hidden states, and the pooled EOS projection where the config has
    one, at 1e-5."""
    cfg = JC.CLIPTextConfig.tiny()
    if projection:
        cfg = cfg.replace(projection_dim=projection)
    jm = JC.CLIPTextModel(cfg)
    r = np.random.default_rng(17)
    ids = r.integers(1, 990, size=(2, 16)).astype(np.int32)
    ids[:, 9:] = 999  # EOS padding: the largest id
    p = perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(ids),
                          return_pooled=bool(projection))["params"], 2)
    tcfg = TC.CLIPTextConfig(**{**TC.CLIPTextConfig.tiny().__dict__,
                                "projection_dim": projection})
    tm = carried(TC.CLIPTextModel(tcfg), p, TW.clip_text_params_from_jax)
    tids = torch.from_numpy(ids.astype(np.int64))
    if projection:
        jh, jpool = jm.apply({"params": p}, ids, return_pooled=True)
        h, pool = tm(tids, return_pooled=True)
        np.testing.assert_allclose(pool.detach().numpy(), np.asarray(jpool),
                                   **CLIP_TOL)
    else:
        jh, h = jm.apply({"params": p}, ids), tm(tids)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **CLIP_TOL)


# ---- state dicts the other way, and the loader ------------------------------

def port_models(seed=3):
    """Tiny port models with random weights (flax-like init, then every
    parameter perturbed so that norms and biases are not trivial)."""
    m = TP.build_models(TU.UNetConfig.tiny(), TV.VAEConfig.tiny(),
                        TC.CLIPTextConfig.tiny(), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in m[:3]:
            for v in net.parameters():
                v.add_(0.05 * torch.randn(v.shape, generator=gen))
    return m


def test_state_dicts_through_jax_converters():
    """Port state dicts through JAX's convert_unet / convert_vae /
    convert_clip_text drive the JAX models to the port's outputs."""
    m = port_models()
    r = np.random.default_rng(18)
    x = r.normal(size=(2, 8, 8, 8)).astype(np.float32)
    ctx = r.normal(size=(2, 7, 32)).astype(np.float32)
    t = np.array([3, 500], np.int32)
    ju = JU.UNet2DConditionModel(JU.UNetConfig.tiny())
    want = jax.jit(ju.apply)({"params": JW.convert_unet(m.unet.state_dict())},
                             x, t, ctx)
    np.testing.assert_allclose(
        nhwc(m.unet(nchw(x), torch.from_numpy(t), t_(ctx))),
        np.asarray(want), **TOL)
    img = r.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    jv = JV.AutoencoderKL(JV.VAEConfig.tiny())
    vp = JW.convert_vae(m.vae.state_dict())
    np.testing.assert_allclose(
        nhwc(m.vae.encode(nchw(img))),
        np.asarray(jv.apply({"params": vp}, img, None, method=jv.encode)),
        **TOL)
    z = r.normal(size=(2, 8, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(
        nhwc(m.vae.decode(nchw(z))),
        np.asarray(jv.apply({"params": vp}, z, method=jv.decode)), **TOL)
    ids = r.integers(1, 999, size=(2, 16))
    jc = JC.CLIPTextModel(JC.CLIPTextConfig.tiny())
    np.testing.assert_allclose(
        m.text_encoder(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jc.apply(
            {"params": JW.convert_clip_text(m.text_encoder.state_dict())},
            ids.astype(np.int32))), **CLIP_TOL)


def test_load_diffusers_directory(tmp_path):
    """A tiny diffusers-layout IP2P directory (safetensors UNet and text
    encoder with its position_ids buffer, a torch .bin VAE under the old
    attention names) loads into the port bit for bit."""
    from safetensors.torch import save_file

    m = port_models(4)
    for sub in ("unet", "vae", "text_encoder"):
        (tmp_path / sub).mkdir()
    save_file(m.unet.state_dict(),
              str(tmp_path / "unet" / "diffusion_pytorch_model.safetensors"))
    old = {}
    for k, v in m.vae.state_dict().items():
        for new, was in ((".to_q.", ".query."), (".to_k.", ".key."),
                         (".to_v.", ".value."), (".to_out.0.", ".proj_attn.")):
            k = k.replace(new, was)
        old[k] = v
    torch.save(old, str(tmp_path / "vae" / "diffusion_pytorch_model.bin"))
    text = dict(m.text_encoder.state_dict())
    text["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    save_file(text, str(tmp_path / "text_encoder" / "model.safetensors"))
    loaded = TP.build_models(TU.UNetConfig.tiny(), TV.VAEConfig.tiny(),
                             TC.CLIPTextConfig.tiny(),
                             params=TW.load_ip2p_checkpoint(str(tmp_path)),
                             device="cpu")
    for a, b in zip(m[:3], loaded[:3]):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_random_init_scale():
    """Random weights are drawn as flax draws them: kernels of std
    1/sqrt(fan_in), zero biases, unit norms, the CLIP position table at
    0.01; the same seed gives the same weights."""
    a, b = (TP.build_models(TU.UNetConfig.tiny(), TV.VAEConfig.tiny(),
                            TC.CLIPTextConfig.tiny(), seed=5, device="cpu")
            for _ in range(2))
    for x, y in zip(a.unet.parameters(), b.unet.parameters()):
        assert torch.equal(x, y)
    w = a.unet.mid_block.resnets[0].conv1.weight
    assert abs(float(w.std()) * math.sqrt(w[0].numel()) - 1.0) < 0.05
    assert float(a.unet.conv_in.bias.abs().max()) == 0.0
    assert float(a.vae.encoder.conv_norm_out.weight.min()) == 1.0
    pos = a.text_encoder.text_model.embeddings.position_embedding.weight
    assert 0.005 < float(pos.std()) < 0.015
