"""The port's edit networks and guidance in bfloat16 against the JAX
package's, on the CPU with the tiny configs.

One JAX parameter tree (random, every leaf perturbed so that norms and
biases are not trivial) builds the JAX models at ``jnp.bfloat16`` and
``jnp.float32`` and, through ``*_params_from_jax``, the port's at
``torch.bfloat16``; the same numpy inputs go through all three. Covered:
the UNet (plain, pivot pass, 1- and 2-key reuse with the JAX cross-view
states), VAE encode (sample, with the JAX draw handed over; cond) and
decode, the CLIP text encoder, and one guidance DDIM step (loop and vmap
reuse, the JAX pivot offsets and cross-view states handed over). The
reuse passes gather at JAX's argmax indices, the port's own equal to them
wherever JAX's top-2 gap exceeds 5e-2 (bf16 tokens break ties apart);
the norms lie within one bf16 step of flax's.

Tolerance, computed in each test: the port's bf16 output lies within 2x
the largest distance between JAX's own bf16 and f32 outputs on that input
(max-abs), and its mean absolute difference from JAX's bf16 output is
within 2e-2 of JAX's mean magnitude. Parity is held network by network and
step by step: over a whole multi-step edit the DDIM loop and the epipolar
argmax amplify bf16 rounding in JAX alone. Every public function returns
the dtype its JAX twin returns. At the default dtype the networks give the
bits they gave before they took a dtype; ``dge_tpu_torch/tools/
profile_edit.py`` runs ``--tiny`` on the CPU."""

import functools
import math
import os

import flax.linen as nnf
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dge_tpu.diffusion import ddim as JD
from dge_tpu.diffusion import ip2p as JP
from dge_tpu.models import clip_text as JC
from dge_tpu.models import layers as JL
from dge_tpu.models import unet as JU
from dge_tpu.models import vae as JV
from dge_tpu.models.clip_text import CLIPTextConfig as JCC
from dge_tpu.models.unet import UNetConfig as JUC
from dge_tpu.models.vae import VAEConfig as JVC
from dge_tpu.parallel.mesh import stack_cameras as j_stack
from dge_tpu.systems import guidance as JG
from dge_tpu_torch.diffusion import ddim as TD
from dge_tpu_torch.diffusion import ip2p as TP
from dge_tpu_torch.diffusion import weights as TW
from dge_tpu_torch.models import layers as TL
from dge_tpu_torch.models.clip_text import CLIPTextConfig
from dge_tpu_torch.models.unet import UNetConfig
from dge_tpu_torch.models.vae import VAEConfig
from dge_tpu_torch.parallel.mesh import stack_cameras as t_stack
from dge_tpu_torch.systems import guidance as TG
from dge_tpu_torch.tools import profile_edit
from tests.test_parallel import ring_cameras
from tests.test_torch_diffusion import Draws
from tests.test_torch_edit import jax_states, port_cam
from tests.test_torch_models import _states, perturbed

BF = torch.bfloat16
MAX_ABS_FACTOR = 2.0  # x max |JAX bf16 - JAX f32| on the same input
MEAN_REL = 2e-2  # mean |port - JAX bf16| / mean |JAX bf16|
# the reuse gather's argmax: the port's own indices equal JAX's wherever
# JAX's top-2 gap of the masked cosine similarity exceeds this; bf16 tokens
# (2^-8 relative) that two packages round apart after a few blocks move
# the cosines of 32-wide tokens by a few 1e-2
BF16_TIE = 5e-2


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_params(p):
    return {"unet": TW.unet_params_from_jax(host(p["unet"])),
            "vae": TW.vae_params_from_jax(host(p["vae"])),
            "text_encoder": TW.clip_text_params_from_jax(
                host(p["text_encoder"]))}


def port_build(p, dtype=BF):
    return TP.build_models(UNetConfig.tiny(), VAEConfig.tiny(),
                           CLIPTextConfig.tiny(), params=port_params(p),
                           device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def nets():
    """(JAX bf16, JAX f32, port bf16) tiny models on one perturbed JAX
    parameter tree."""
    cfgs = (JUC.tiny(), JVC.tiny(), JCC.tiny())
    nets = [JU.UNet2DConditionModel(cfgs[0]), JV.AutoencoderKL(cfgs[1]),
            JC.CLIPTextModel(cfgs[2])]
    args = [(jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,), jnp.int32),
             jnp.zeros((1, 7, 32))), (jnp.zeros((1, 16, 16, 3)),),
            (jnp.zeros((1, 4), jnp.int32),)]
    p = {name: perturbed(jax.jit(net.init)(jax.random.PRNGKey(i), *a)[
        "params"], 20 + i) for i, (name, net, a) in enumerate(zip(
            ("unet", "vae", "text_encoder"), nets, args))}
    return (JP.build_models(*cfgs, dtype=jnp.bfloat16, params=p),
            JP.build_models(*cfgs, params=p), port_build(p), p)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def same_dtype(got, want):
    """A port tensor has the dtype of a JAX array."""
    assert str(got.dtype).split(".")[-1] == str(jnp.asarray(want).dtype), (
        got.dtype, want.dtype)


def held(got, want16, want32, what):
    """The port's bf16 output against JAX's bf16 one, at the tolerance that
    JAX's own bf16-vs-f32 distance sets on this input."""
    same_dtype(got, want16)
    got, w16, w32 = f32(got), f32(want16), f32(want32)
    assert got.shape == w16.shape == w32.shape
    assert np.isfinite(got).all()
    own = float(np.abs(w16 - w32).max())
    err = float(np.abs(got - w16).max())
    rel = float(np.abs(got - w16).mean() / np.abs(w16).mean())
    own_rel = float(np.abs(w32 - w16).mean() / np.abs(w16).mean())
    print(f"{what}: max |port - JAX bf16| {err:.4g}, max |JAX bf16 - f32| "
          f"{own:.4g}; mean relative {rel:.4g} (JAX bf16 - f32: "
          f"{own_rel:.4g})")
    assert err <= MAX_ABS_FACTOR * own, (what, err, own)
    assert rel <= MEAN_REL, (what, rel)


def bf16_values(x):
    """Numpy f32 values that bf16 holds exactly (inputs every package
    reads alike)."""
    return f32(torch.from_numpy(np.asarray(x, np.float32)).to(BF))


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def hand_over_indices(monkeypatch):
    """JAX's ``epi_blockwise_argmax`` records its indices and the top-2 gap
    of its masked similarity (an ordered ``jax.debug.callback``: in call
    order, under jit and vmap too); the port's returns JAX's indices, in
    call order and laid end to end over as many JAX calls as its frames
    take (the port's batched reuse is one call over every camera batch,
    JAX's a vmap), after noting where its own differ. Returns that record:
    per call, (mismatched, gap)."""
    j_fn, t_fn = JL.epi_blockwise_argmax, TL.epi_blockwise_argmax
    recs, seen = [], []

    def record(idx, img, piv, lines, pts, threshold):
        sim = np.einsum("fsd,fktd->fkst", np.asarray(img, np.float32),
                        np.asarray(piv, np.float32))
        viol = np.abs(np.einsum("fksc,tc->fkst", np.asarray(lines),
                                np.asarray(pts))) > threshold
        viol &= ~viol.all(axis=-1, keepdims=True)
        top2 = -np.sort(-np.where(viol, 0.0, sim), axis=-1)[..., :2]
        recs.append((np.asarray(idx), top2[..., 0] - top2[..., 1]))

    def jax_fn(img, piv, lines, pts, threshold, block=512):
        idx = j_fn(img, piv, lines, pts, threshold, block)
        jax.debug.callback(functools.partial(record, threshold=threshold),
                           idx, img, piv, lines, pts, ordered=True)
        return idx

    def port_fn(img, piv, lines, pts, threshold, block=512):
        own = t_fn(img, piv, lines, pts, threshold, block)
        taken = []
        while sum(len(i) for i, _ in taken) < img.shape[0]:
            taken.append(recs.pop(0))
        idx = np.concatenate([i for i, _ in taken])
        gap = np.concatenate([g for _, g in taken])
        seen.append((own.numpy() != idx, gap))
        return torch.from_numpy(idx.astype(np.int64))

    monkeypatch.setattr(JL, "epi_blockwise_argmax", jax_fn)
    monkeypatch.setattr(TL, "epi_blockwise_argmax", port_fn)
    return seen


def equal_but_at_ties(seen, what):
    """The port's own argmax indices equal JAX's wherever JAX's top-2 gap
    exceeds ``BF16_TIE``."""
    assert seen
    mis = np.concatenate([m.ravel() for m, _ in seen])
    gap = np.concatenate([g.ravel() for _, g in seen])
    worst = float(gap[mis].max()) if mis.any() else 0.0
    print(f"{what}: {int(mis.sum())} of {mis.size} gather indices differ "
          f"from JAX's, at top-2 gaps up to {worst:.3g}")
    assert worst <= BF16_TIE, (what, worst)


# ---- the networks ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["group_norm", "layer_norm"])
@pytest.mark.parametrize("in_dtype", ["bfloat16", "float32"])
def test_norms_match_flax(kind, in_dtype):
    """The bf16 norms against flax's ``GroupNorm`` / ``LayerNorm(dtype=
    jnp.bfloat16)`` on bf16 and on f32 input (the CLIP residual stream is
    f32): f32 statistics, normalisation and affine, then one rounding, so
    every element equals JAX's or lies one bf16 step from it (the f32
    statistics sum in another order); a norm computed in bf16 lies tens
    to hundreds of steps off. The layers the networks share with flax
    otherwise (Dense, Conv, attention) round apart: XLA rounds a product
    and then its bias, torch once."""
    r = np.random.default_rng(37)
    x = (r.normal(size=(2, 6, 6, 32)) * 2 + 0.5).astype(np.float32)
    if in_dtype == "bfloat16":
        x = bf16_values(x)
    if kind == "group_norm":
        jm = nnf.GroupNorm(8, epsilon=1e-6, dtype=jnp.bfloat16)
        tm = TL.GroupNorm(8, 32, 1e-6, BF)
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    else:
        jm = nnf.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
        tm = TL.LayerNorm(32, 1e-5, BF)
        tx = torch.from_numpy(x)
    p = perturbed(jm.init(jax.random.PRNGKey(0), x)["params"], 38)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(p["scale"]))
        tm.bias.copy_(torch.from_numpy(p["bias"]))
    want = jm.apply({"params": p}, jnp.asarray(x, in_dtype))
    got = tm(tx.to(getattr(torch, in_dtype)))
    if kind == "group_norm":
        got = nhwc(got)
    same_dtype(got, want)
    got, want = f32(got), f32(want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    steps = np.abs(got - want) / step
    print(f"{kind} on {in_dtype}: {int((steps > 0).sum())} of {steps.size} "
          f"elements off JAX's, at most {steps.max():g} bf16 steps")
    assert steps.max() <= 1.0


@pytest.mark.parametrize("mode", ["plain", "pivot_record", "reuse_1",
                                  "reuse_2"])
def test_unet(nets, monkeypatch, mode):
    """The UNet at 8x8 latents: plain mode, the pivot pass (2 key frames),
    and a reuse pass over 2 frames with one and two keys on the JAX
    cross-view states (banded), each package reusing its own pivot record;
    the reuse gathers at JAX's argmax indices, the port's own equal to them
    but at ties."""
    j16, j32, tm, _ = nets
    r = np.random.default_rng(30)
    xk = r.normal(size=(6, 8, 8, 8)).astype(np.float32)
    xq = r.normal(size=(6, 8, 8, 8)).astype(np.float32)
    ctx = bf16_values(r.normal(size=(6, 7, 32)))
    t = np.full((6,), 400, np.int32)
    tt = torch.from_numpy(t.astype(np.int64))
    tctx = torch.from_numpy(ctx).to(BF)

    def jax_run(jm, x, **kw):
        return jm.unet.apply({"params": jm.unet_params}, x, t,
                             jnp.asarray(ctx, jm.unet.dtype), **kw)

    if mode == "plain":
        got = tm.unet(torch.from_numpy(xq).permute(0, 3, 1, 2), tt, tctx)
        held(nhwc(got), jax_run(j16, xq), jax_run(j32, xq), "UNet plain")
        return
    rec = [jax_run(m, xk, mode="pivot_record", mutable=["pivot"])
           for m in (j16, j32)]
    record = {}
    got = tm.unet(torch.from_numpy(xk).permute(0, 3, 1, 2), tt, tctx,
                  mode="pivot_record", pivot=record)
    if mode == "pivot_record":
        held(nhwc(got), rec[0][0], rec[1][0], "UNet pivot pass")
        return
    jcv, tcv = _states(int(mode[-1]), "banded", latent=8)

    def reuse(m, vs):
        return m.unet.apply({"params": m.unet_params, "pivot": vs["pivot"]},
                            xq, t, jnp.asarray(ctx, m.unet.dtype),
                            mode="pivot_reuse", cross_view=jcv)

    want32 = reuse(j32, rec[1][1])
    seen = hand_over_indices(monkeypatch)
    want16 = reuse(j16, rec[0][1])
    got = tm.unet(torch.from_numpy(xq).permute(0, 3, 1, 2), tt, tctx,
                  mode="pivot_reuse", cross_view=tcv, pivot=record)
    equal_but_at_ties(seen, f"UNet {mode}")
    held(nhwc(got), want16, want32, f"UNet {mode}")


def test_vae(nets, monkeypatch):
    """``encode_images`` (the posterior sample at JAX's bf16 draw),
    ``encode_cond_images`` and ``decode_latents`` at 16^2 (8^2 latents)."""
    j16, j32, tm, _ = nets
    r = np.random.default_rng(31)
    rgb = r.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want16 = JP.encode_images(j16, rgb, key)
    # JAX's f32 sample at the same draw: its f32 moments and the bf16 noise
    draw = f32(jax.random.normal(key, want16.shape, jnp.bfloat16))
    mean, logvar = j32.vae.apply({"params": j32.vae_params}, rgb * 2.0 - 1.0,
                                 method=j32.vae.encode_moments)
    want32 = (mean + jnp.exp(0.5 * logvar) * draw) * JVC.tiny().scaling_factor
    monkeypatch.setattr(TP, "_normal", Draws([draw]).normal)
    got = TP.encode_images(tm, torch.from_numpy(rgb), torch.Generator())
    held(got, want16, want32, "VAE encode (sample)")
    held(TP.encode_cond_images(tm, torch.from_numpy(rgb)),
         JP.encode_cond_images(j16, rgb), JP.encode_cond_images(j32, rgb),
         "VAE encode (cond)")
    z = r.normal(size=(2, 8, 8, 4)).astype(np.float32)
    held(TP.decode_latents(tm, torch.from_numpy(z)),
         JP.decode_latents(j16, z), JP.decode_latents(j32, z), "VAE decode")


def test_clip_text(nets):
    j16, j32, tm, _ = nets
    ids = np.random.default_rng(32).integers(1, 990, size=(2, 16))
    ids[:, 9:] = 999  # EOS padding: the largest id
    held(TP.encode_text(tm, ids), JP.encode_text(j16, jnp.asarray(ids)),
         JP.encode_text(j32, jnp.asarray(ids)), "CLIP text")


# ---- one guidance DDIM step ------------------------------------------------

@pytest.mark.parametrize("batch_mode", ["loop", "vmap"])
def test_guidance_step(nets, monkeypatch, batch_mode):
    """One CFG-combined multi-view noise prediction at t = 400 over 4 views
    in camera batches of 2 (the pivot pass, 1- and 2-key reuse) and its DDIM
    update, from f32 noisy latents and bf16 conditioning latents and text
    embeddings; JAX's pivot offsets, cross-view states and, from its bf16
    run, argmax indices handed over, the port's own indices equal but at
    ties. The noise prediction is bf16, the updated latents f32, in both
    packages. The updated latents are held at the module's tolerance; the
    noise prediction within 2x JAX's own bf16-vs-f32 distance in the max
    and in the mean: CFG multiplies ``eps_text - eps_image`` by 7.5, and
    JAX's own bf16 prediction lies about 4% from its f32 one in the
    mean."""
    j16, j32, tm, _ = nets
    r = np.random.default_rng(33)
    b, cbs, lat, t, steps = 4, 2, 16, 400, 20
    latents = r.normal(size=(b, lat, lat, 4)).astype(np.float32)
    cond = bf16_values(r.normal(size=(3 * b, lat, lat, 4)))
    cond[2 * b:] = 0.0
    emb = bf16_values(r.normal(size=(2 * b, 7, 32)))
    jcams = ring_cameras(b, height=2 * lat, width=2 * lat)
    key = jax.random.PRNGKey(4)
    offsets = jax.random.randint(key, (b // cbs,), 0, cbs)
    kw = dict(camera_batch_size=cbs, diffusion_steps=steps,
              batch_mode=batch_mode)
    sched = j32.schedule

    def jax_step(jm):
        g = JG.DGEGuidance(JG.GuidanceConfig(**kw), jm)
        c = jnp.asarray(cond, jm.unet.dtype)
        e = jnp.asarray(emb, jm.unet.dtype)

        def triple_for(idx):
            return (jnp.concatenate([e[idx], e[b + idx], e[b + idx]], 0),
                    jnp.concatenate([c[idx], c[b + idx], c[2 * b + idx]], 0))

        eps = g._predict_eps_multiview(latents, t, j_stack(jcams),
                                       triple_for, b, cbs, b // cbs, lat,
                                       lat, key)
        return eps, JD.step(sched, eps, jnp.asarray(t), latents, steps)

    e32, s32 = jax_step(j32)
    seen = hand_over_indices(monkeypatch)
    e16, s16 = jax_step(j16)
    jax.effects_barrier()
    monkeypatch.setattr(TG, "_pivot_offsets",
                        Draws(offsets=[offsets]).pivot_offsets)
    states = jax_states(jcams, monkeypatch)
    tcond = torch.from_numpy(cond).to(BF)
    temb = torch.from_numpy(emb).to(BF)

    def triple_for(idx):
        return (torch.cat([temb[idx], temb[b + idx], temb[b + idx]], 0),
                torch.cat([tcond[idx], tcond[b + idx], tcond[2 * b + idx]],
                          0))

    g = TG.DGEGuidance(TG.GuidanceConfig(**kw), tm)
    tlat = torch.from_numpy(latents)
    eps = g._predict_eps_multiview(tlat, t, t_stack([port_cam(c)
                                                     for c in jcams]),
                                   triple_for, b, cbs, b // cbs, lat, lat,
                                   torch.Generator())
    assert states.calls == b // cbs
    equal_but_at_ties(seen, f"guidance step ({batch_mode})")
    held(TD.step(tm.schedule, eps, t, tlat, steps), s16, s32,
         f"guidance DDIM step ({batch_mode})")
    same_dtype(eps, e16)
    got, w16, w32 = f32(eps), f32(e16), f32(e32)
    dist = [(float(np.abs(a - b).max()), float(np.abs(a - b).mean()))
            for a, b in ((got, w16), (w16, w32))]
    print(f"guidance eps ({batch_mode}): |port - JAX bf16| max, mean "
          f"{dist[0]}, |JAX bf16 - f32| {dist[1]}, mean |JAX bf16| "
          f"{float(np.abs(w16).mean()):.4g}")
    assert dist[0][0] <= MAX_ABS_FACTOR * dist[1][0]
    assert dist[0][1] <= MAX_ABS_FACTOR * dist[1][1]


# ---- dtypes ----------------------------------------------------------------

def test_result_dtypes(nets):
    """The public functions return the dtypes JAX returns: the networks'
    dtype from the VAE, the UNet, CLIP and ``DGEGuidance.__call__``; f32
    from ``add_noise``, ``step`` and ``pred_x0`` on bf16 latents and
    noise predictions (torch alone would keep bf16 against the schedule's
    0-dim f32 entries)."""
    j16, _, tm, _ = nets
    assert tm.dtype == BF and all(
        m.dtype == BF for m in (tm.unet, tm.vae, tm.text_encoder))
    r = np.random.default_rng(34)
    x16 = r.normal(size=(2, 8, 8, 4)).astype(np.float32)
    jx, tx = jnp.asarray(x16, jnp.bfloat16), torch.from_numpy(x16).to(BF)
    js, ts = j16.schedule, tm.schedule
    same_dtype(TD.add_noise(ts, tx, tx, 300),
               JD.add_noise(js, jx, jx, jnp.full((2,), 300)))
    same_dtype(TD.step(ts, tx, 301, tx, 20),
               JD.step(js, jx, jnp.asarray(301), jx, 20))
    same_dtype(TD.step(ts, tx, 301, tx, 20, 0.5, tx),
               JD.step(js, jx, jnp.asarray(301), jx, 20, 0.5, jx))
    same_dtype(TD.pred_x0(ts, tx, 301, tx),
               JD.pred_x0(js, jx, jnp.asarray(301), jx))
    # the whole edit: 4 views at 32^2, two DDIM steps (one pivot step, one
    # plain); bf16 frames in [0, 1] in both packages
    rgb = r.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    emb = r.normal(size=(4, 7, 32)).astype(np.float32)
    kw = dict(camera_batch_size=2, diffusion_steps=2, resize_target=64)
    jcams = ring_cameras(4, height=32, width=32)
    want = JG.DGEGuidance(JG.GuidanceConfig(**kw), j16)(
        rgb, rgb, emb, emb, j_stack(jcams), jax.random.PRNGKey(5),
        max_step=500)
    got = TG.DGEGuidance(TG.GuidanceConfig(**kw), tm)(
        *(torch.from_numpy(x) for x in (rgb, rgb, emb, emb)),
        t_stack([port_cam(c) for c in jcams]),
        torch.Generator().manual_seed(5), max_step=500)
    same_dtype(got, want)
    assert got.shape == (4, 32, 32, 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


# ---- the default dtype, the weights --------------------------------------

def test_default_build_is_todays(nets, monkeypatch):
    """At the default dtype every weight is f32 and the networks give the
    bits of the same networks with ``torch.nn``'s own Linear, Conv2d,
    Embedding and norm forwards (the port before it took a dtype)."""
    _, _, _, p = nets
    tm = port_build(p, torch.float32)
    assert tm.dtype == torch.float32
    assert all(v.dtype == torch.float32 for m in tm[:3]
               for v in m.state_dict().values())
    r = np.random.default_rng(35)
    rgb = torch.from_numpy(r.uniform(size=(2, 16, 16, 3)).astype(np.float32))
    ids = r.integers(1, 990, size=(2, 16))
    x = torch.from_numpy(r.normal(size=(2, 8, 8, 8)).astype(np.float32))
    noise = torch.from_numpy(r.normal(size=(2, 8, 8, 4)).astype(np.float32))

    def run():
        te = TP.encode_text(tm, ids)
        return (te, TP.encode_images_with(tm, rgb, noise),
                TP.encode_cond_images(tm, rgb), TP.decode_latents(tm, noise),
                TP.unet_eps(tm, x, 300, te))

    got = run()
    for cls, base in ((TL.Linear, nn.Linear), (TL.Conv2d, nn.Conv2d),
                      (TL.Embedding, nn.Embedding),
                      (TL.GroupNorm, nn.GroupNorm),
                      (TL.LayerNorm, nn.LayerNorm)):
        monkeypatch.setattr(cls, "forward", base.forward)
    for a, b in zip(got, run()):
        assert torch.equal(a, b)


def test_ingested_weights_load_into_bf16(nets, tmp_path):
    """The f32 state dicts of an ingest cache load into a bf16 build: f32
    on disk, bf16 copies in the networks, the same networks as the JAX
    tree's bf16 build."""
    _, _, tm, p = nets
    params = port_params(p)
    TW.save_ingested(str(tmp_path), params)
    loaded = TW.load_ingested(str(tmp_path))
    assert all(v.dtype == torch.float32 for sd in loaded.values()
               if isinstance(sd, dict) for v in sd.values())
    ing = TP.build_models(UNetConfig.tiny(), VAEConfig.tiny(),
                          CLIPTextConfig.tiny(), params=loaded, device="cpu",
                          dtype=BF)
    for name, net in (("unet", ing.unet), ("vae", ing.vae),
                      ("text_encoder", ing.text_encoder)):
        sd = net.state_dict()
        for k, v in params[name].items():
            # bf16 where the JAX module computes in its dtype, f32 for the
            # norms and the CLIP position table
            assert sd[k].dtype in (BF, torch.float32)
            assert torch.equal(sd[k], v.to(sd[k].dtype)), k
        assert any(v.dtype == BF for v in sd.values())
    ids = np.random.default_rng(36).integers(1, 990, size=(2, 16))
    assert torch.equal(TP.encode_text(ing, ids), TP.encode_text(tm, ids))


# ---- the tool --------------------------------------------------------------

def test_profile_edit_tiny(tmp_path):
    """``profile_edit --tiny --cpu``: the JAX tool's stages and counts a
    round, each with its FLOP count and bound, written as a table."""
    out = str(tmp_path / "profile_edit.md")
    res = profile_edit.main(["--tiny", "--cpu", "--iters", "1", "--out",
                             out])
    rows = res["rows"]
    assert [(r["stage"], r["count"]) for r in rows] == [
        ("VAE encode sample", 1), ("VAE encode cond", 1),
        ("cross-view state", 72), ("UNet pivot pass", 18),
        ("UNet reuse pass (2-key)", 54), ("UNet reuse pass (1-key)", 18),
        ("UNet plain pass", 8), ("DDIM update", 20), ("VAE decode", 1)]
    # FlopCounterMode counts products, convolutions and attention
    assert all(r["gflop"] > 0 for r in rows
               if r["stage"] not in ("cross-view state", "DDIM update"))
    assert all(math.isfinite(r["ms"]) and r["bound_ms"] > 0 for r in rows)
    with open(out) as f:
        table = f.read()
    assert "| UNet pivot pass | 18 |" in table
    assert os.path.getsize(out) > 0
