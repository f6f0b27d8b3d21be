"""InstructPix2Pix pipeline (functional).

JAX counterpart: ``dge_tpu/diffusion/ip2p.py``. Reference analog: the
diffusers StableDiffusionInstructPix2PixPipeline that the guidance wraps
(dge_guidance.py:53-135) and its latent helpers (encode_images :190-199,
encode_cond_images :201-218 with the 3-way [img, img, zeros] conditioning,
decode_latents :221-235).

The networks run NCHW inside; at this module's edges images are
``[B, H, W, 3]`` in [0, 1] and latents ``[B, h, w, 4]``, the JAX layout. The
UNet input is ``concat([noisy_latent, cond_latent], channel)`` (8 channels)
and classifier-free guidance is IP2P's 3-way form (dge_guidance.py:362-368):

    eps = eps_uncond + s_text * (eps_text - eps_image)
                     + s_image * (eps_image - eps_uncond)

Every random draw goes through ``_normal`` with an explicit
``torch.Generator`` on the models' device.

Two editors (``preset_configs``): ``"sd15"``, timbrooks/instruct-pix2pix
(the SD-1.5 UNet, the CLIP-L text tower, the f8 VAE at scale 0.18215), and
``"sdxl768"``, diffusers/sdxl-instructpix2pix-768 (the SDXL UNet, CLIP-L
and OpenCLIP bigG read at their penultimate layers and concatenated to a
2,048-wide context, bigG's projected EOS state as the pooled embedding, the
f8 VAE at scale 0.13025). The SDXL UNet also takes the pooled embedding and
the time ids (original size, crop corner, target size: the frames' own
size, uncropped); ``unet_eps`` makes the time ids from the latents' size.

The networks compute in ``IP2PModels.dtype`` (``build_models(dtype=...)``,
f32 or bf16, as the JAX package's ``build_models``), and each function here
returns the dtype its JAX twin returns: ``encode_text``, ``encode_images``,
``encode_cond_images``, ``decode_latents`` and ``unet_eps`` give the
networks' dtype; ``ddim.add_noise`` and ``ddim.step`` give f32 from bf16
latents.

Spans (utils/tracing.py): ``vae.encode``, ``vae.encode_cond``,
``vae.decode`` and ``unet.<mode>`` (``plain``, ``pivot_record``,
``pivot_reuse``), each with a device interval on a card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dge_tpu_torch import resolve_device
from dge_tpu_torch.diffusion import ddim
from dge_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from dge_tpu_torch.models.layers import init_like_flax, store_compute_dtype
from dge_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from dge_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from dge_tpu_torch.utils import tracing

# diffusers/sdxl-instructpix2pix-768's vae/config.json
SDXL_VAE_SCALE = 0.13025


class IP2PModels(NamedTuple):
    """The networks and the DDIM schedule. ``dtype`` is the dtype the
    networks compute in (all share it); their norms, the CLIP position
    tables and the schedule stay f32. ``text_encoder_2``: SDXL's second
    text tower (None for SD-1.5)."""

    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    schedule: ddim.DDIMSchedule
    text_encoder_2: Optional[CLIPTextModel] = None

    @property
    def device(self) -> torch.device:
        return self.schedule.alphas_cumprod.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.dtype


def preset_configs(editor: str = "sd15", tiny: bool = False) -> Tuple[
        UNetConfig, VAEConfig, CLIPTextConfig, Optional[CLIPTextConfig]]:
    """(UNet, VAE, text tower, second text tower) configs of ``editor``:
    ``"sd15"`` or ``"sdxl768"``; ``tiny``: its layout at test size."""
    if editor == "sd15":
        if tiny:
            return (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                    None)
        return UNetConfig(), VAEConfig(), CLIPTextConfig(), None
    if editor == "sdxl768":
        if tiny:
            text, text_2 = CLIPTextConfig.tiny_xl()
            return (UNetConfig.tiny_xl(
                        context_dim=text.hidden_size + text_2.hidden_size,
                        pooled_dim=text_2.projection_dim),
                    dataclasses.replace(VAEConfig.tiny(),
                                        scaling_factor=SDXL_VAE_SCALE),
                    text, text_2)
        return (UNetConfig.sdxl_ip2p_768(),
                VAEConfig(scaling_factor=SDXL_VAE_SCALE),
                CLIPTextConfig.sdxl_l(), CLIPTextConfig.open_clip_bigg())
    raise ValueError(f"unknown editor {editor!r}; one of 'sd15', 'sdxl768'")


def build_models(unet_cfg: Optional[UNetConfig] = None,
                 vae_cfg: Optional[VAEConfig] = None,
                 text_cfg: Optional[CLIPTextConfig] = None,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 text_cfg_2: Optional[CLIPTextConfig] = None) -> IP2PModels:
    """The networks on ``device`` in eval mode, frozen, computing in
    ``dtype`` (``torch.float32`` or ``torch.bfloat16``; the JAX
    ``build_models(dtype=...)``); a second text tower with ``text_cfg_2``.
    ``params`` (``{"unet", "vae", "text_encoder"}`` f32 state dicts, and
    ``"text_encoder_2"`` with a second tower, from
    ``weights.load_ip2p_checkpoint``, ``weights.load_ingested`` or
    ``*_params_from_jax``) load strictly; without them the weights are
    drawn as flax initialises the JAX modules (``layers.init_like_flax``)
    from ``seed``, the second tower's last. Either way they are drawn or
    loaded in f32 and then cast to ``dtype`` once
    (``layers.store_compute_dtype``): one seed or one parameter tree gives
    the f32 and the bf16 networks the same weights, rounded."""
    dev = resolve_device(device)
    with dev:
        unet = UNet2DConditionModel(unet_cfg or UNetConfig(), dtype)
        vae = AutoencoderKL(vae_cfg or VAEConfig(), dtype)
        text = CLIPTextModel(text_cfg or CLIPTextConfig(), dtype)
        text_2 = (CLIPTextModel(text_cfg_2, dtype)
                  if text_cfg_2 is not None else None)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_like_flax(unet, gen)
        init_like_flax(vae, gen)
        text.init_like_flax(gen)
        if text_2 is not None:
            text_2.init_like_flax(gen)
    else:
        unet.load_state_dict(params["unet"])
        vae.load_state_dict(params["vae"])
        text.load_state_dict(params["text_encoder"])
        if text_2 is not None:
            text_2.load_state_dict(params["text_encoder_2"])
    nets = (unet, vae, text) + ((text_2,) if text_2 is not None else ())
    for m in nets:
        store_compute_dtype(m).eval().requires_grad_(False)
    return IP2PModels(unet, vae, text, ddim.make_schedule(device=dev),
                      text_2)


def _normal(shape, generator: torch.Generator) -> torch.Tensor:
    """A standard normal draw of ``shape`` (f32, the generator's device)."""
    return torch.randn(shape, generator=generator, device=generator.device)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def encode_text(models: IP2PModels, input_ids, input_ids_2=None):
    """Token ids [B, S] -> the text tower's hidden states [B, S, D]. With a
    second tower (SDXL): (both towers' states concatenated [B, S, D1 + D2],
    the second's pooled embedding [B, P]); ``input_ids_2`` are its ids (its
    tokenizer pads otherwise), ``input_ids`` by default."""
    def ids_of(x):
        return torch.as_tensor(x, dtype=torch.long, device=models.device)

    states = models.text_encoder(ids_of(input_ids))
    if models.text_encoder_2 is None:
        return states
    states_2, pooled = models.text_encoder_2(
        ids_of(input_ids if input_ids_2 is None else input_ids_2),
        return_pooled=True)
    return torch.cat([states, states_2], dim=-1), pooled


def _chunks(b: int, chunk: Optional[int]):
    """Leading-axis slices of at most ``chunk`` (all of it when None).
    Full-size VAE activations at 512^2 are ~1.3 GB per conv buffer per 20
    images, so the guidance encodes and decodes in chunks."""
    step = chunk if chunk and b > chunk else b
    return [slice(i, i + step) for i in range(0, b, step)]


def latent_shape(models: IP2PModels, rgb: torch.Tensor) -> Tuple[int, ...]:
    """The latent shape [B, H/8, W/8, 4] of images [B, H, W, 3]."""
    b, h, w = rgb.shape[:3]
    f = models.vae.downscale
    return (b, h // f, w // f, models.vae.config.latent_channels)


def encode_images_with(models: IP2PModels, rgb: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> the scaled posterior sample at the standard
    normal draw ``noise`` [B, H/8, W/8, 4], in the networks' dtype. Keeps
    the autograd graph: the SDS refit differentiates through it with the
    draw that made its target latents (the JAX package reuses the same key,
    systems/edit.py:405, 471)."""
    return nhwc(models.vae.encode(nchw(rgb) * 2.0 - 1.0, nchw(noise)))


@torch.no_grad()
def encode_images(models: IP2PModels, rgb: torch.Tensor,
                  generator: torch.Generator,
                  chunk: Optional[int] = None) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> sampled scaled latents [B, H/8, W/8, 4]
    (encode_images, dge_guidance.py:190-199); one posterior draw per chunk,
    in chunk order."""
    with tracing.span("vae.encode", device=models.device):
        return torch.cat([
            encode_images_with(models, rgb[sl], _normal(
                latent_shape(models, rgb[sl]), generator))
            for sl in _chunks(rgb.shape[0], chunk)], dim=0)


@torch.no_grad()
def encode_cond_images(models: IP2PModels, rgb: torch.Tensor,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """Conditioning latents: the posterior mode, tripled [img, img, zeros]
    (encode_cond_images, dge_guidance.py:201-218)."""
    with tracing.span("vae.encode_cond", device=models.device):
        lat = torch.cat([nhwc(models.vae.encode(nchw(rgb[sl]) * 2.0 - 1.0))
                         for sl in _chunks(rgb.shape[0], chunk)], dim=0)
        return torch.cat([lat, lat, torch.zeros_like(lat)], dim=0)


@torch.no_grad()
def decode_latents(models: IP2PModels, latents: torch.Tensor,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """[B, h, w, 4] -> images [B, 8h, 8w, 3] in [0, 1]."""
    with tracing.span("vae.decode", device=models.device):
        return torch.cat([
            nhwc(models.vae.decode(nchw(latents[sl]))).mul(0.5).add(0.5)
            .clamp(0.0, 1.0) for sl in _chunks(latents.shape[0], chunk)],
            dim=0)


def time_ids(models: IP2PModels, latent_h: int, latent_w: int,
             batch: int) -> torch.Tensor:
    """SDXL's time ids [batch, 6] for frames of the latents' size: original
    size (H, W), crop corner (0, 0), target size (H, W). Made on the device
    by fills (no upload)."""
    f = models.vae.downscale
    ids = torch.full((batch, 6), float(latent_h * f), device=models.device)
    ids[:, 1::4] = float(latent_w * f)
    ids[:, 2:4] = 0.0
    return ids


@torch.no_grad()
def unet_eps(models: IP2PModels, inp: torch.Tensor, t: int,
             text_emb: torch.Tensor, pooled: Optional[torch.Tensor] = None,
             **kw) -> torch.Tensor:
    """The UNet on [B, h, w, 8] latents at timestep ``t`` -> eps
    [B, h, w, 4]; ``pooled`` [B, P]: the pooled text embeddings the SDXL
    UNet takes (with ``time_ids``); ``kw``: the cross-view ``mode``,
    ``cross_view``, ``pivot``."""
    with tracing.span("unet." + kw.get("mode", "plain"), device=inp.device,
                      batch=inp.shape[0]):
        ts = torch.full((inp.shape[0],), int(t), dtype=torch.long,
                        device=inp.device)
        if pooled is not None:
            kw = dict(kw, text_embeds=pooled,
                      time_ids=time_ids(models, inp.shape[1], inp.shape[2],
                                        inp.shape[0]))
        return nhwc(models.unet(nchw(inp), ts, text_emb, **kw))


def cfg_combine(eps_text, eps_image, eps_uncond, guidance_scale: float,
                condition_scale: float):
    return (eps_uncond + guidance_scale * (eps_text - eps_image)
            + condition_scale * (eps_image - eps_uncond))


def triple(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x, x], dim=0)


@torch.no_grad()
def edit_images_single_view(
        models: IP2PModels, rgb: torch.Tensor, cond_rgb: torch.Tensor,
        text_emb_pos: torch.Tensor, text_emb_neg: torch.Tensor,
        generator: torch.Generator, *, t_start: int = 999,
        num_steps: int = 20, guidance_scale: float = 7.5,
        condition_scale: float = 1.5) -> torch.Tensor:
    """Per-view IP2P editing with no cross-view attention (BASELINE.md
    config 3). Returns the edited [B, H, W, 3]."""
    latents = encode_images(models, rgb, generator)
    cond_lat = encode_cond_images(models, cond_rgb)
    text_emb = torch.cat([text_emb_pos, text_emb_neg, text_emb_neg], dim=0)
    # truncated schedule over [0, t_start] (edit_latents sets
    # num_train_timesteps to the sampled t and noises at the same t,
    # dge_guidance.py:267-296)
    sched = models.schedule._replace(
        num_train_timesteps=max(t_start, num_steps))
    noise = _normal(tuple(latents.shape), generator)
    latents = ddim.add_noise(sched, latents, noise, t_start)
    for t in ddim.inference_timesteps(sched, num_steps):
        inp = torch.cat([triple(latents), cond_lat], dim=-1)
        e_text, e_img, e_unc = unet_eps(models, inp, int(t),
                                        text_emb).chunk(3, dim=0)
        eps = cfg_combine(e_text, e_img, e_unc, guidance_scale,
                          condition_scale)
        latents = ddim.step(sched, eps, int(t), latents, num_steps)
    return decode_latents(models, latents)


def resize_to_64_multiple(h: int, w: int,
                          target: int = 512) -> Tuple[int, int]:
    """The guidance's 64-multiple resize rule (dge_guidance.py:505-511):
    scale the long side to ~``target`` and round to 64 multiples."""
    factor = target / max(w, h)
    factor = math.ceil(min(w, h) * factor / 64) * 64 / min(w, h)
    width = int((w * factor) // 64) * 64
    height = int((h * factor) // 64) * 64
    return height, width
