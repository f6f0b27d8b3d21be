"""Checkpoint loading and carrying weights across from the JAX package.

JAX counterpart: ``dge_tpu/diffusion/weights.py``. The port's parameter
names are the diffusers / transformers names, so a local diffusers
InstructPix2Pix directory (``timbrooks/instruct-pix2pix``) loads with
``load_state_dict`` after one rename: the old diffusers VAE attention names
(``query`` / ``key`` / ``value`` / ``proj_attn``).

The ingest cache (``save_ingested`` / ``is_ingested`` / ``load_ingested``,
written by ``python -m dge_tpu_torch.tools.ingest_checkpoint``) is the
port's own format: ``manifest.json`` (``format`` ``INGEST_FORMAT``, the
``kind``, the source and each model's parameter count) and one ``torch.save``
state dict a model in the port's names, which ``torch.load(...,
weights_only=True)`` reads back with no ``safetensors`` installed. The JAX
package's orbax cache (``"dge_tpu_ip2p_orbax_v1"``) needs JAX to read:
``is_ingested`` is False for it and ``check_not_jax_ingest`` names the
port's tool instead. ``load_checkpoint`` takes either kind of directory.

A local transformers ``CLIPModel`` directory (``openai/clip-vit-large-patch14``)
loads for the edit metrics with ``load_clip_checkpoint``.

``*_params_from_jax`` turn the JAX packages' parameter trees (numpy leaves)
into the port's state dicts, the inverse of the JAX ``convert_*``: flax's
flat module names go back to diffusers' (``down_blocks_0_attentions_1`` ->
``down_blocks.0.attentions.1``), Dense kernels ``[in, out]`` become Linear
weights ``[out, in]``, Conv kernels ``[kh, kw, in, out]`` become
``[out, in, kh, kw]``, norm scales and embedding tables become ``weight``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_SEGMENTS = (
    (re.compile(r"^(down_blocks|up_blocks)_(\d+)_"
                r"(resnets|attentions|downsamplers|upsamplers)_(\d+)$"),
     r"\1.\2.\3.\4"),
    (re.compile(r"^mid_block_(resnets|attentions)_(\d+)$"), r"mid_block.\1.\2"),
    (re.compile(r"^transformer_blocks_(\d+)$"), r"transformer_blocks.\1"),
    (re.compile(r"^to_out_0$"), "to_out.0"),
    (re.compile(r"^net_0_proj$"), "net.0.proj"),
    (re.compile(r"^net_2$"), "net.2"),
    (re.compile(r"^layers_(\d+)$"), r"layers.\1"),
    (re.compile(r"^mlp_(fc1|fc2)$"), r"mlp.\1"),
)


def _flat(tree: Mapping, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _segment(name: str) -> str:
    for pat, rep in _SEGMENTS:
        if pat.match(name):
            return pat.sub(rep, name)
    return name


def _leaf(name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            return "weight", arr.transpose(3, 2, 0, 1)
        return "weight", arr.T
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def _from_jax(tree: Mapping, rename) -> Dict[str, torch.Tensor]:
    out = {}
    for path, arr in _flat(tree):
        leaf, arr = _leaf(path[-1], arr)
        key = ".".join([_segment(p) for p in path[:-1]] + [leaf])
        out[rename(key)] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    return out


def unet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``UNet2DConditionModel`` params -> port UNet state dict."""
    return _from_jax(tree, lambda k: k)


def vae_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``AutoencoderKL`` params -> port VAE state dict (the JAX package
    keeps quant_conv in its encoder and post_quant_conv in its decoder)."""

    def rename(k):
        for old, new in (("encoder.quant_conv.", "quant_conv."),
                         ("decoder.post_quant_conv.", "post_quant_conv.")):
            if k.startswith(old):
                return new + k[len(old):]
        return k

    return _from_jax(tree, rename)


def clip_text_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPTextModel`` params -> port (transformers) state dict."""

    def rename(k):
        if k.startswith("text_projection."):
            return k
        if k == "position_embedding":
            return "text_model.embeddings.position_embedding.weight"
        if k.startswith("token_embedding."):
            return "text_model.embeddings." + k
        if k.startswith("layers."):
            return "text_model.encoder." + k
        return "text_model." + k

    return _from_jax(tree, rename)


def clip_vision_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPVisionModel`` params -> port (transformers
    ``CLIPVisionModelWithProjection``) state dict."""

    def rename(k):
        if k.startswith("visual_projection."):
            return k
        if k == "class_embedding":
            return "vision_model.embeddings.class_embedding"
        if k == "position_embedding":
            return "vision_model.embeddings.position_embedding.weight"
        if k.startswith("patch_embedding."):
            return "vision_model.embeddings." + k
        if k.startswith("layers."):
            return "vision_model.encoder." + k
        return "vision_model." + k

    return _from_jax(tree, rename)


def _n_layers(sd: Mapping, prefix: str) -> int:
    return len({k[len(prefix):].split(".")[0] for k in sd
                if k.startswith(prefix)})


def _clip_configs(sd: Mapping, root: str):
    """The towers' configs from the state dict's shapes; the head counts
    from the directory's ``config.json`` (a head width of 64, CLIP's,
    without one)."""
    import json

    from dge_tpu_torch.models.clip_text import CLIPTextConfig
    from dge_tpu_torch.models.clip_vision import CLIPVisionConfig

    heads = {}
    p = os.path.join(root, "config.json")
    if os.path.exists(p):
        with open(p) as f:
            js = json.load(f)
        heads = {t: js.get(f"{t}_config", {}).get("num_attention_heads")
                 for t in ("vision", "text")}
    patch = sd["vision_model.embeddings.patch_embedding.weight"].shape
    n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
    vision = CLIPVisionConfig(
        image_size=patch[2] * int(round((n_pos - 1) ** 0.5)),
        patch_size=patch[2], hidden_size=patch[0],
        num_layers=_n_layers(sd, "vision_model.encoder.layers."),
        num_heads=heads.get("vision") or patch[0] // 64,
        intermediate_size=sd["vision_model.encoder.layers.0.mlp.fc1.weight"]
        .shape[0],
        projection_dim=sd["visual_projection.weight"].shape[0])
    tok = sd["text_model.embeddings.token_embedding.weight"].shape
    text = CLIPTextConfig(
        vocab_size=tok[0], hidden_size=tok[1],
        num_layers=_n_layers(sd, "text_model.encoder.layers."),
        num_heads=heads.get("text") or tok[1] // 64,
        max_length=sd["text_model.embeddings.position_embedding.weight"]
        .shape[0],
        intermediate_size=sd["text_model.encoder.layers.0.mlp.fc1.weight"]
        .shape[0],
        projection_dim=sd["text_projection.weight"].shape[0])
    return vision, text


def load_clip_checkpoint(root: str) -> Dict[str, Any]:
    """A local transformers ``CLIPModel`` directory (``model.safetensors``
    or ``pytorch_model.bin``, e.g. openai/clip-vit-large-patch14) ->
    ``{"vision", "text"}`` state dicts in the port's names and the towers'
    configs ``"vision_config"`` / ``"text_config"`` (load_clip_checkpoint,
    weights.py:210-247; the reference's metric loads the same towers)."""
    for fname in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(root, fname)
        if os.path.exists(p):
            sd = {k: v for k, v in load_state_dict_file(p).items()
                  if "position_ids" not in k}
            break
    else:
        raise FileNotFoundError(f"no CLIP checkpoint under {root}")
    vision_cfg, text_cfg = _clip_configs(sd, root)
    return {
        "vision": {k: v for k, v in sd.items()
                   if k.startswith("vision_model.")
                   or k == "visual_projection.weight"},
        "text": {k: v for k, v in sd.items()
                 if k.startswith("text_model.")
                 or k == "text_projection.weight"},
        "vision_config": vision_cfg, "text_config": text_cfg}


def _modern_vae_names(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Old diffusers VAE attention names -> the current ones."""
    out = {}
    for k, v in sd.items():
        for old, new in ((".query.", ".to_q."), (".key.", ".to_k."),
                         (".value.", ".to_v."), (".proj_attn.", ".to_out.0.")):
            k = k.replace(old, new)
        out[k] = v
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file (through ``safetensors``) or a torch
    ``.bin``."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_ip2p_checkpoint(root: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A local diffusers InstructPix2Pix directory -> ``{"unet", "vae",
    "text_encoder"}`` state dicts in the port's names (load_ip2p_checkpoint,
    weights.py:178), and ``"text_encoder_2"`` where the directory has a
    ``text_encoder_2/`` (SDXL's second tower)."""

    def load_sd(subdir):
        d = os.path.join(root, subdir)
        for fname in ("diffusion_pytorch_model.safetensors",
                      "diffusion_pytorch_model.bin", "model.safetensors",
                      "pytorch_model.bin"):
            p = os.path.join(d, fname)
            if os.path.exists(p):
                return load_state_dict_file(p)
        raise FileNotFoundError(f"no checkpoint found under {d}")

    def text(subdir):
        return {k: v for k, v in load_sd(subdir).items()
                if "position_ids" not in k}

    out = {"unet": load_sd("unet"), "vae": _modern_vae_names(load_sd("vae")),
           "text_encoder": text("text_encoder")}
    if os.path.isdir(os.path.join(root, "text_encoder_2")):
        out["text_encoder_2"] = text("text_encoder_2")
    return out


INGEST_FORMAT = "dge_tpu_torch_ip2p_v1"
JAX_INGEST_FORMAT = "dge_tpu_ip2p_orbax_v1"


def _manifest(path: str) -> Dict[str, Any]:
    import json

    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def is_ingested(path: str) -> bool:
    """True if ``path`` is a cache that ``save_ingested`` wrote (a JAX orbax
    cache is not)."""
    return _manifest(path).get("format") == INGEST_FORMAT


def check_not_jax_ingest(path: str) -> None:
    """Raise if ``path`` holds the JAX package's orbax cache, which this
    package cannot read."""
    if _manifest(path).get("format") == JAX_INGEST_FORMAT:
        raise ValueError(
            f"{path} is an orbax cache of the JAX package (format "
            f"{JAX_INGEST_FORMAT!r}), which needs JAX to read; ingest the "
            "diffusers checkpoint with python -m "
            "dge_tpu_torch.tools.ingest_checkpoint, or give the diffusers "
            "directory itself")


def save_ingested(out_dir: str, params: Dict[str, Any],
                  meta: Optional[Dict] = None) -> str:
    """Write ``params`` (``{"unet", "vae", "text_encoder"}`` or
    ``{"vision", "text", "vision_config", "text_config"}`` as the loaders
    return them) as the port's ingest cache under ``out_dir``."""
    import dataclasses
    import json

    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    counts, configs = {}, {}
    for name, value in params.items():
        if dataclasses.is_dataclass(value):
            configs[name] = dataclasses.asdict(value)
            continue
        sd = {k: v.detach().cpu().contiguous() for k, v in value.items()}
        torch.save(sd, os.path.join(out_dir, f"{name}.pt"))
        counts[name] = int(sum(v.numel() for v in sd.values()))
    manifest = {"format": INGEST_FORMAT, "param_counts": counts,
                "configs": configs, **(meta or {})}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def load_ingested(out_dir: str) -> Dict[str, Any]:
    """The parameters (and, for a CLIP cache, the towers' configs) that
    ``save_ingested`` wrote, on the CPU."""
    from dge_tpu_torch.models.clip_text import CLIPTextConfig
    from dge_tpu_torch.models.clip_vision import CLIPVisionConfig

    mf = _manifest(out_dir)
    if mf.get("format") != INGEST_FORMAT:
        check_not_jax_ingest(out_dir)
        raise ValueError(f"{out_dir} holds no ingest cache of this package")
    out: Dict[str, Any] = {
        name: torch.load(os.path.join(out_dir, f"{name}.pt"),
                         map_location="cpu", weights_only=True)
        for name in mf["param_counts"]}
    kinds = {"vision_config": CLIPVisionConfig, "text_config": CLIPTextConfig}
    for name, fields in mf.get("configs", {}).items():
        out[name] = kinds[name](**fields)
    return out


def load_checkpoint(path: str, load_raw) -> Dict[str, Any]:
    """The ingest cache at ``path``, or ``load_raw(path)`` for a checkpoint
    directory; a JAX orbax cache raises (never random weights instead)."""
    check_not_jax_ingest(path)
    return load_ingested(path) if is_ingested(path) else load_raw(path)
