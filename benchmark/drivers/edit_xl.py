"""The edit driver for the SDXL InstructPix2Pix editor: DGE's multi-view
edit round, rounds back to back, through the program's own path.

Traffic parameters as ``drivers/edit.py``'s. The configuration holds the
UNet in diffusers' keys (``unet/config.json``: ``down_block_types``,
``transformer_layers_per_block``, ``attention_head_dim`` as heads a level,
the ``text_time`` added embedding) and two text towers.

Set-up draws the networks' weights on the card from the seed (the UNet, the
VAE and both towers, in one call), builds them with
``diffusion/ip2p.build_models`` in the configuration's dtype, the scene of
the configuration named under ``scene`` and a ``systems/edit.DGESystem``
over the views with the text states and pooled embeddings drawn from the
seed; ``render_all_views`` probes the caps and renders the original
frames. A round is ``DGESystem.edit_all_views`` itself with noise drawn
from (seed, round): the views rendered in ring order, the guidance, the
frames read to the host as float32 and rounded to 8-bit levels. The
comparison holds the first round's frames (by view) to the plain reference
``reference/sdxl.py`` on the same draws, rounded to 8-bit levels too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.drivers import common as C
from benchmark.drivers import edit
from benchmark.reference import dge as REF
from benchmark.reference import raster, sd15, sdxl
from benchmark.yardstick import scene as S
from benchmark.yardstick import trace as TR


class Driver(edit.Driver):
    # ---- weights and inputs, made alike for the program and the reference
    def weight_shapes(self):
        cfg = self.cell.config
        with torch.device("meta"):
            nets = {"unet": sdxl.UNet(cfg["unet"]), "vae": sd15.VAE(cfg["vae"]),
                    "text_encoder": sdxl.TextTower(cfg["text_encoder"]),
                    "text_encoder_2": sdxl.TextTower(cfg["text_encoder_2"])}
        return {k: sd15.names_and_shapes(m) for k, m in nets.items()}

    def pooled(self):
        """The prompt's and the negative prompt's pooled embeddings [1, P],
        drawn from the seed and rounded to the networks' dtype."""
        p = int(self.cell.config["text_encoder_2"]["projection_dim"])
        gen = torch.Generator(device=self.dev).manual_seed(
            self.cell.torch_seed(10))
        return [torch.randn(1, p, generator=gen, device=self.dev).to(
            self.dtype) for _ in range(2)]

    def text_cfg(self, name: str = "text_encoder"):
        from dge_tpu_torch.models.clip_text import CLIPTextConfig

        t = self.cell.config[name]
        return CLIPTextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            num_layers=t["num_hidden_layers"],
            num_heads=t["num_attention_heads"],
            max_length=t["max_position_embeddings"],
            intermediate_size=t["intermediate_size"],
            projection_dim=t.get("projection_dim"),
            hidden_act=t["hidden_act"],
            hidden_state_index=self.cell.config["text_hidden_state_index"])

    def unet_cfg(self):
        """The configuration's UNet as the program's ``UNetConfig`` (a
        program without the SDXL layout raises here)."""
        from dge_tpu_torch.models.unet import UNetConfig

        u = self.cell.config["unet"]
        ch = tuple(u["block_out_channels"])
        (head_dim,) = {c // h for c, h in zip(ch, u["attention_head_dim"])}
        return UNetConfig(
            in_channels=u["in_channels"], out_channels=u["out_channels"],
            block_out_channels=ch, layers_per_block=u["layers_per_block"],
            cross_attention_dim=u["cross_attention_dim"],
            norm_groups=u["norm_num_groups"],
            attention_levels=tuple(t.startswith("CrossAttn")
                                   for t in u["down_block_types"]),
            transformer_depth=tuple(u["transformer_layers_per_block"]),
            head_dim=head_dim,
            use_linear_projection=u["use_linear_projection"],
            addition_embed_type=u["addition_embed_type"],
            addition_time_embed_dim=u["addition_time_embed_dim"],
            projection_class_embeddings_input_dim=u[
                "projection_class_embeddings_input_dim"])

    # ---- the program ----
    def setup(self) -> None:
        from dge_tpu_torch.diffusion import ip2p as P
        from dge_tpu_torch.models.vae import VAEConfig
        from dge_tpu_torch.systems import edit as E
        from dge_tpu_torch.systems import guidance as GD

        cell, dev = self.cell, self.dev
        cfg, tr = cell.config, cell.traffic
        rc = cfg["recipe"]
        unet_cfg = self.unet_cfg()
        self.dtype = getattr(torch, cfg["dtype"])
        self.scene_cfg = edit.scene_config(cfg)
        v = cfg["vae"]
        models = P.build_models(
            unet_cfg,
            VAEConfig(in_channels=v["in_channels"],
                      latent_channels=v["latent_channels"],
                      block_out_channels=tuple(v["block_out_channels"]),
                      layers_per_block=v["layers_per_block"],
                      norm_groups=v["norm_num_groups"],
                      scaling_factor=v["scaling_factor"]),
            self.text_cfg(), params=self.weights(self.dtype), device=dev,
            dtype=self.dtype, text_cfg_2=self.text_cfg("text_encoder_2"))
        self.h, self.w = int(rc["height"]), int(rc["width"])
        n = int(tr["views"])
        self.poses = S.orbit_cameras(n, self.h, self.w)
        sc = dict(self.scene_cfg, scene_scale=cfg.get("scene_scale", 1.0))
        self.arrays = S.gt_scene(cell.seed % (1 << 63),
                                 sh_degree=int(sc["sh_degree"]),
                                 sh_rest_std=float(
                                     sc["assumed"]["sh_rest_std"]),
                                 scale=float(sc["scene_scale"]))
        scene = C.program_scene(self.arrays, int(sc["sh_degree"]), dev)
        self.pos, self.neg = self.text_states()
        self.pooled_pos, self.pooled_neg = self.pooled()
        self.gcfg = GD.GuidanceConfig(
            guidance_scale=rc["guidance_scale"],
            condition_scale=rc["condition_scale"],
            camera_batch_size=rc["camera_batch_size"],
            diffusion_steps=rc["diffusion_steps"],
            batch_mode=rc["batch_mode"], epipolar_mode=rc["epipolar_mode"],
            epipolar_threshold=rc["epipolar_threshold"],
            resize_target=rc["resize_target"],
            vae_batch=rc["camera_batch_size"])
        self.guidance = GD.DGEGuidance(self.gcfg, models)
        schedule = tuple(rc["added_noise_schedule"])
        ecfg = E.EditConfig(max_view_num=n,
                            camera_batch_size=rc["camera_batch_size"],
                            added_noise_schedule=schedule,
                            tile_px=int(sc["tile_px"]))
        cams = [C.program_camera(c, dev) for c in self.poses]
        self.system = E.DGESystem(
            ecfg, scene, cams, guidance=self.guidance, text_emb_pos=self.pos,
            text_emb_neg=self.neg, pooled_pos=self.pooled_pos,
            pooled_neg=self.pooled_neg,
            cameras_extent=S.cameras_extent(self.poses))
        self.system.render_all_views()
        self.global_step = int(tr["global_step"])
        idx = min(len(schedule) - 1,
                  self.global_step // max(ecfg.camera_update_per_step, 1))
        self.max_step = int(schedule[idx])
        self.system.guidance = GD.DGEGuidance(dataclasses.replace(
            self.gcfg, diffusion_steps=int(tr["warmup_diffusion_steps"])),
            models)
        self.round(None)
        self.system.guidance = self.guidance
        TR.sync()

    def round(self, r) -> torch.Tensor:
        """One edit round with the noise of round ``r`` (None: the set-up's
        round): the edited frames [views, H, W, 3] by view, on the host."""
        system = self.system
        gen = torch.Generator(device=self.dev).manual_seed(
            self.cell.torch_seed(9) if r is None else self.cell.torch_seed(8, r))
        with record_function("bench.round"):
            system.edit_all_views(gen, global_step=self.global_step)
        return torch.from_numpy(np.stack([system.edit_frames[v]
                                          for v in system.view_list]))

    # ---- the reference ----
    def reference_nets(self, mode: str = "float32"):
        cfg = self.cell.config
        w = self.weights(self.dtype)
        with torch.device("meta"):
            unet, vae = sdxl.UNet(cfg["unet"]), sd15.VAE(cfg["vae"])
        nets = []
        for net, sd in ((unet, w["unet"]), (vae, w["vae"])):
            net = net.to_empty(device=self.dev)
            net.load_state_dict({k: v.float() for k, v in sd.items()})
            sd15.set_precision(net, mode)
            nets.append(net.eval().requires_grad_(False))
        del w
        return tuple(nets)

    def reference_round(self, unet, vae, r: int = 0) -> torch.Tensor:
        """Round ``r`` by the plain reference: its own renders, ring order,
        original frames at 8-bit levels and edit; the frames by view, at
        8-bit levels."""
        sc = self.scene_cfg
        params = C.reference_params(self.arrays, self.dev)
        cams = [C.reference_camera(c, self.dev) for c in self.poses]
        bg = torch.zeros(3, device=self.dev)
        imgs = [raster.render(params, c, int(sc["sh_degree"]), bg,
                              int(sc["tile_px"])).color for c in cams]
        centers = np.stack([c["campos"] for c in self.poses])
        forwards = np.stack([c["w2c"][2, :3] for c in self.poses])
        order = REF.ring_order(centers, forwards)
        rgb = torch.stack([imgs[i] for i in order])
        cond = C.quantize_u8(rgb)
        fp = torch.stack([cams[i]["full_proj"] for i in order])
        pos = torch.stack([cams[i]["campos"] for i in order])
        n = len(order)
        tp, tn = (t.float().expand(n, -1, -1) for t in self.text_states())
        pp, pn = (p.float() for p in self.pooled())
        gen = torch.Generator(device=self.dev).manual_seed(
            self.cell.torch_seed(8, r))
        out = sdxl.edit_round(unet, vae, rgb, cond, tp, tn, pp, pn, fp, pos,
                              gen, self.cell.config["recipe"],
                              self.max_step - 1)
        by_view = torch.empty_like(out)
        by_view[torch.as_tensor(order, device=out.device)] = out
        return C.quantize_u8(by_view)

    @staticmethod
    def gaps(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
        return edit.Driver.gaps(got.to(ref.device), ref)

    def round_flops(self) -> float:
        cfg = self.cell.config
        with torch.device("meta"):
            unet, vae = sdxl.UNet(cfg["unet"]), sd15.VAE(cfg["vae"])
        views = int(self.cell.traffic["views"])
        passes = sdxl.pass_flops(
            unet, vae, views, self.h, self.w,
            int(cfg["recipe"]["camera_batch_size"]),
            int(cfg["text_encoder"]["max_position_embeddings"]),
            int(cfg["unet"]["cross_attention_dim"]),
            int(cfg["text_encoder_2"]["projection_dim"]))
        return REF.round_flops(passes, views, cfg["recipe"],
                               self.max_step - 1)
