"""The edit driver: DGE's multi-view edit round, rounds back to back.

Traffic parameters: ``views`` (at the configuration's size, fixed poses of
the scene's orbit), ``global_step`` (the refit step the round belongs to,
which picks its noise level from ``added_noise_schedule``),
``warmup_diffusion_steps`` (the set-up's round, which runs every kind of
pass at the window's shapes in fewer DDIM steps) and ``trace_rounds``.

Set-up draws the networks' weights on the card from the seed, builds them
with ``diffusion/ip2p.build_models`` in the configuration's dtype, the
scene of the configuration named under ``scene`` and a
``systems/edit.DGESystem`` over the views, whose ``render_all_views`` probes
the caps and renders the original frames. A round does what
``DGESystem.edit_all_views`` does, up to its frames on the device: the
views rendered in ring order through the system's renderer, then
``systems/guidance.DGEGuidance`` over them with noise drawn from (seed,
round). (``edit_all_views`` itself ends by calling ``.numpy()`` on the
networks' bf16 frames, which raises.)
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.drivers import common as C
from benchmark.reference import dge as REF
from benchmark.reference import raster, sd15
from benchmark.reference.precision import exact_float32
from benchmark.yardstick import scene as S
from benchmark.yardstick import trace as TR
from benchmark.yardstick import weights as WT

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def scene_config(cfg: dict) -> dict:
    with open(os.path.join(_CONFIGS, cfg["scene"] + ".json")) as f:
        return json.load(f)


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.dev = cell.device
        self.rounds = 0
        self.kept = None

    # ---- weights and inputs, made alike for the program and the reference
    def weight_shapes(self):
        from dge_tpu_torch.models.clip_text import CLIPTextModel

        cfg = self.cell.config
        with torch.device("meta"):
            nets = {"unet": sd15.UNet(cfg["unet"]), "vae": sd15.VAE(cfg["vae"]),
                    "text_encoder": CLIPTextModel(self.text_cfg())}
        return {k: sd15.names_and_shapes(m) for k, m in nets.items()}

    def weights(self, dtype) -> Dict[str, Dict[str, torch.Tensor]]:
        """The three networks' weights from the seed, in ``dtype``."""
        shapes = self.weight_shapes()
        flat = [(f"{k}/{n}", s) for k, v in shapes.items() for n, s in v]
        drawn = WT.draw(flat, self.cell.torch_seed(6), self.dev, dtype)
        return {k: {n: drawn[f"{k}/{n}"] for n, _ in v}
                for k, v in shapes.items()}

    def text_states(self):
        """The prompt's and the negative prompt's text states [1, S, D],
        drawn from the seed and rounded to the networks' dtype."""
        cfg = self.cell.config
        gen = torch.Generator(device=self.dev).manual_seed(
            self.cell.torch_seed(7))
        s = int(cfg["text_encoder"]["max_position_embeddings"])
        d = int(cfg["unet"]["cross_attention_dim"])
        return [torch.randn(1, s, d, generator=gen, device=self.dev).to(
            self.dtype) for _ in range(2)]

    def text_cfg(self):
        from dge_tpu_torch.models.clip_text import CLIPTextConfig

        t = self.cell.config["text_encoder"]
        return CLIPTextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            num_layers=t["num_hidden_layers"],
            num_heads=t["num_attention_heads"],
            max_length=t["max_position_embeddings"],
            intermediate_size=t["intermediate_size"])

    # ---- the program ----
    def setup(self) -> None:
        from dge_tpu_torch.diffusion import ip2p as P
        from dge_tpu_torch.models.unet import UNetConfig
        from dge_tpu_torch.models.vae import VAEConfig
        from dge_tpu_torch.systems import edit as E
        from dge_tpu_torch.systems import guidance as GD

        cell, dev = self.cell, self.dev
        cfg, tr = cell.config, cell.traffic
        rc = cfg["recipe"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.scene_cfg = scene_config(cfg)
        u, v = cfg["unet"], cfg["vae"]
        models = P.build_models(
            UNetConfig(in_channels=u["in_channels"],
                       out_channels=u["out_channels"],
                       block_out_channels=tuple(u["block_out_channels"]),
                       layers_per_block=u["layers_per_block"],
                       cross_attention_dim=u["cross_attention_dim"],
                       attention_heads=u["attention_head_dim"],
                       norm_groups=u["norm_num_groups"]),
            VAEConfig(in_channels=v["in_channels"],
                      latent_channels=v["latent_channels"],
                      block_out_channels=tuple(v["block_out_channels"]),
                      layers_per_block=v["layers_per_block"],
                      norm_groups=v["norm_num_groups"],
                      scaling_factor=v["scaling_factor"]),
            self.text_cfg(), params=self.weights(self.dtype), device=dev,
            dtype=self.dtype)
        self.h, self.w = int(rc["height"]), int(rc["width"])
        n = int(tr["views"])
        self.poses = S.orbit_cameras(n, self.h, self.w)
        sc = dict(self.scene_cfg, scene_scale=cell.config.get(
            "scene_scale", 1.0))
        self.arrays = S.gt_scene(cell.seed % (1 << 63),
                                 sh_degree=int(sc["sh_degree"]),
                                 sh_rest_std=float(
                                     sc["assumed"]["sh_rest_std"]),
                                 scale=float(sc["scene_scale"]))
        scene = C.program_scene(self.arrays, int(sc["sh_degree"]), dev)
        self.pos, self.neg = self.text_states()
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
        self.system = E.DGESystem(ecfg, scene, cams, guidance=self.guidance,
                                  text_emb_pos=self.pos, text_emb_neg=self.neg,
                                  cameras_extent=S.cameras_extent(self.poses))
        self.system.render_all_views()
        step = int(tr["global_step"])
        idx = min(len(schedule) - 1,
                  step // max(ecfg.camera_update_per_step, 1))
        self.max_step = int(schedule[idx])
        warm = GD.DGEGuidance(dataclasses.replace(
            self.gcfg, diffusion_steps=int(tr["warmup_diffusion_steps"])),
            models)
        self.system.guidance = warm
        self.round(None)
        self.system.guidance = self.guidance
        TR.sync()

    def round(self, r) -> torch.Tensor:
        """One edit round with the noise of round ``r`` (None: the set-up's
        round): the edited frames [views, H, W, 3] on the device."""
        from dge_tpu_torch.parallel.mesh import stack_cameras
        from dge_tpu_torch.systems import edit as E

        system = self.system
        gen = torch.Generator(device=self.dev).manual_seed(
            self.cell.torch_seed(9) if r is None else self.cell.torch_seed(8, r))
        with record_function("bench.round"):
            centers = np.stack([system.cameras[v].campos.cpu().numpy()
                                for v in system.view_list])
            forwards = np.stack([system.cameras[v].w2c[2, :3].cpu().numpy()
                                 for v in system.view_list])
            views = [system.view_list[i]
                     for i in E._ring_order(centers, forwards)]
            with record_function("bench.render"):
                rgb = torch.stack([system._render(v) for v in views])
            cond = torch.stack([torch.from_numpy(system.origin_frames[v])
                                for v in views]).to(self.dev)
            n = rgb.shape[0]
            out = system.guidance(
                rgb, cond, self.pos.expand(n, -1, -1),
                self.neg.expand(n, -1, -1),
                stack_cameras([system.cameras[v] for v in views]), gen,
                max_step=self.max_step)
        return out

    def next_round(self) -> None:
        out = self.round(self.rounds)
        if self.kept is None:
            self.kept = out.detach().clone()
        self.rounds += 1

    def window(self, seconds: float) -> dict:
        n, elapsed, _ = TR.timed_window(self.next_round, seconds)
        self.round_s = elapsed / n
        views = int(self.cell.traffic["views"])
        finite = bool(torch.isfinite(self.kept.float()).all())
        return {"metrics": {"edit_views_per_s": views * n / elapsed},
                "attempted": n, "failed": 0 if finite else 1}

    def trace_window(self) -> TR.Trace:
        k = int(self.cell.traffic["trace_rounds"])

        def run():
            for _ in range(k):
                self.next_round()
            return k

        return TR.profile(run)

    def layer_calls(self):
        """The 2-key reuse pass over one camera batch (three CFG chunks of
        ``camera_batch_size`` frames) and one camera batch's cross-view
        state, at the round's shapes, as ``tools/profile_edit.py`` stages
        them: callables for timing a layer alone."""
        if getattr(self, "_calls", None) is None:
            self._calls = self._layer_calls()
        return self._calls

    def _layer_calls(self):
        from dge_tpu_torch.diffusion import ddim
        from dge_tpu_torch.diffusion import ip2p as P
        from dge_tpu_torch.parallel.mesh import index_cameras, stack_cameras
        from dge_tpu_torch.systems.guidance import make_cross_view_state

        models = self.guidance.models
        cbs = int(self.gcfg.camera_batch_size)
        b = int(self.cell.traffic["views"])
        gen = torch.Generator(device=self.dev).manual_seed(3)
        rgb = torch.stack([self.system._render(v)
                           for v in self.system.view_list])
        lat = P.encode_images(models, rgb, gen, chunk=cbs)
        cond_img, _, cond_zero = P.encode_cond_images(
            models, rgb, chunk=cbs).chunk(3, dim=0)
        t = 541
        noisy = ddim.add_noise(models.schedule, lat, torch.randn(
            lat.shape, generator=gen, device=self.dev).to(lat.dtype), t)
        cams = stack_cameras(self.system.cameras)
        n_b = b // cbs
        off = (np.arange(n_b) * 2 + 1) % cbs
        piv = torch.as_tensor(off + np.arange(0, b, cbs), device=self.dev)
        keys = index_cameras(cams, piv)
        emb_p = self.pos.expand(b, -1, -1)
        emb_n = self.neg.expand(b, -1, -1)

        def triple_for(idx):
            return (torch.cat([emb_p[idx], emb_n[idx], emb_n[idx]]),
                    torch.cat([cond_img[idx], cond_img[idx], cond_zero[idx]]))

        record: dict = {}
        te_p, cl_p = triple_for(piv)
        P.unet_eps(models, torch.cat([P.triple(noisy[piv]), cl_p], -1), t,
                   te_p, mode="pivot_record", pivot=record)
        sl = torch.arange(cbs, 2 * cbs, device=self.dev)
        lh, lw = lat.shape[1], lat.shape[2]

        def state():
            return make_cross_view_state(
                index_cameras(cams, sl), keys, int(off[1]), lh, lw, 2,
                self.gcfg.epipolar_threshold, self.gcfg.epipolar_mode)

        cv = state()
        te_b, cl_b = triple_for(sl)
        inp_b = torch.cat([P.triple(noisy[sl]), cl_b], -1)

        def reuse():
            return P.unet_eps(models, inp_b, t, te_b, mode="pivot_reuse",
                              cross_view=cv, pivot=record)

        return {"unet_reuse_2key": reuse, "cross_view_state": state}

    def release(self) -> None:
        del self.system, self.guidance
        self._calls = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference ----
    def reference_nets(self, mode: str = "float32"):
        cfg = self.cell.config
        w = self.weights(self.dtype)
        unet = sd15.UNet(cfg["unet"]).to(self.dev)
        vae = sd15.VAE(cfg["vae"]).to(self.dev)
        unet.load_state_dict({k: v.float() for k, v in w["unet"].items()})
        vae.load_state_dict({k: v.float() for k, v in w["vae"].items()})
        del w
        for net in (unet, vae):
            sd15.set_precision(net, mode)
        return unet.eval().requires_grad_(False), vae.eval().requires_grad_(
            False)

    def reference_round(self, unet, vae, r: int = 0) -> torch.Tensor:
        """Round ``r`` by the plain reference: its own renders, ring order,
        original frames at 8-bit levels and edit."""
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
        gen = torch.Generator(device=self.dev).manual_seed(
            self.cell.torch_seed(8, r))
        return REF.edit_round(unet, vae, rgb, cond, tp, tn, fp, pos, gen,
                              self.cell.config["recipe"], self.max_step - 1)

    @staticmethod
    def gaps(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
        d = (got.float() - ref.float()).abs()
        return {"edit_mean_gap": float(d.mean()),
                "edit_max_gap": float(d.max())}

    def check(self) -> Dict[str, dict]:
        with exact_float32():
            unet, vae = self.reference_nets()
            ref = self.reference_round(unet, vae)
        got = self.gaps(self.kept, ref)
        self.last_gaps = got
        lim = self.cell.limits
        return {k: C.check(v, lim[k]) for k, v in got.items() if k in lim}

    def round_flops(self) -> float:
        cfg = self.cell.config
        with torch.device("meta"):
            unet, vae = sd15.UNet(cfg["unet"]), sd15.VAE(cfg["vae"])
        views = int(self.cell.traffic["views"])
        passes = REF.pass_flops(
            unet, vae, views, self.h, self.w,
            int(cfg["recipe"]["camera_batch_size"]),
            int(cfg["text_encoder"]["max_position_embeddings"]),
            int(cfg["unet"]["cross_attention_dim"]))
        return REF.round_flops(passes, views, cfg["recipe"],
                               self.max_step - 1)
