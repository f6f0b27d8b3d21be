"""The segment driver: SAM 2.1 mask rounds over the working views of a local
edit, rounds back to back, through the program's own path.

Traffic parameters: ``views`` (the configuration's recipe size, fixed poses
of the scene's orbit), ``warmup_rounds`` (the set-up's rounds),
``trace_rounds``, and the box prompt drawn from the seed: its centre the
scene's target moved by up to ``box_center_jitter`` on each axis, its half
sizes in ``box_half_size``.

Set-up draws the network's weights on the card from the seed, builds the
segmentor with ``systems/segmentation.build_segmentor("sam2", ...)`` in the
configuration's dtype, the scene of the configuration named under
``scene`` and a ``systems/edit.DGESystem`` over the views with the box as
``seg_box``; ``render_all_views`` probes the caps and renders the origin
frames. A round is ``DGESystem.segment_views()`` itself: the frames
uploaded, the box projected into each view, the encoder and the decoder in
batches of the recipe's ``camera_batch_size``, the masks on the device.

The comparison holds the first round to the plain reference
``reference/sam2.py`` on the same weights (rounded to the dtype, computed in
float32), which renders its own frames (``reference/raster.py``, rounded to
8-bit levels) and projects the box itself: ``mask_logit_gap`` (mean |Δ| of
the four low-resolution logit maps over the reference's mean |logit|, views
where both sides see the box), ``mask_flip_share`` (the share of mask pixels
that differ, the program's selection applied on both sides) and
``selection_disagrees`` (the share of the views whose selection is clear in
the reference, where the program selected another mask; the limits file
gives the margins that make a selection clear, and why).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from benchmark.drivers import common as C
from benchmark.drivers import edit
from benchmark.reference import raster
from benchmark.reference import sam2 as REF
from benchmark.reference.precision import exact_float32
from benchmark.reference.sd15 import names_and_shapes, set_precision
from benchmark.yardstick import scene as S
from benchmark.yardstick import trace as TR
from benchmark.yardstick import weights as WT

_FOURIER = "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.dev = cell.device
        self.rounds = 0
        self.kept = None

    # ---- weights and inputs, made alike for the program and the reference
    def weights(self, dtype) -> Dict[str, torch.Tensor]:
        """The image path's weights from the seed, in ``dtype``, under the
        checkpoint's names."""
        with torch.device("meta"):
            shapes = names_and_shapes(REF.Sam2(self.cell.config))
        w = WT.draw(shapes, self.cell.torch_seed(6), self.dev, dtype)
        # SAM 2 draws its Fourier matrix standard normal
        fourier = w[_FOURIER]
        w[_FOURIER] = (fourier.float() * math.sqrt(fourier.shape[1])).to(dtype)
        return w

    def box(self) -> list:
        """The scene-space box (x0, y0, z0, x1, y1, z1) drawn from the seed."""
        tr = self.cell.traffic
        rng = np.random.default_rng(self.cell.rng_seed(11))
        j = float(tr["box_center_jitter"])
        centre = S.SCENE_TARGET + rng.uniform(-j, j, 3)
        half = rng.uniform(*tr["box_half_size"], 3)
        return [float(x) for x in np.concatenate([centre - half,
                                                  centre + half])]

    def model_cfg(self):
        """The configuration as the program's ``Sam2Config`` (a program
        without the segmenter raises here, at once)."""
        from dge_tpu_torch.models.sam2 import Sam2Config

        cfg = self.cell.config
        t, n, md = cfg["trunk"], cfg["neck"], cfg["mask_decoder"]
        return Sam2Config(
            image_size=cfg["image_size"], embed_dim=t["embed_dim"],
            num_heads=t["num_heads"], stages=tuple(t["stages"]),
            global_att_blocks=tuple(t["global_att_blocks"]),
            window_spec=tuple(t["window_spec"]),
            window_pos_embed_bkg_spatial_size=tuple(
                t["window_pos_embed_bkg_spatial_size"]),
            q_pool=t["q_pool"], dim_mul=t["dim_mul"], head_mul=t["head_mul"],
            mlp_ratio=t["mlp_ratio"], d_model=n["d_model"],
            fpn_top_down_levels=tuple(n["fpn_top_down_levels"]),
            scalp=n["scalp"], decoder_depth=md["transformer_depth"],
            decoder_heads=md["num_heads"], decoder_mlp_dim=md["mlp_dim"],
            attention_downsample_rate=md["attention_downsample_rate"],
            num_multimask_outputs=md["num_multimask_outputs"],
            iou_head_depth=md["iou_head_depth"],
            stability_delta=md["dynamic_multimask_stability_delta"],
            stability_thresh=md["dynamic_multimask_stability_thresh"])

    # ---- the program ----
    def setup(self) -> None:
        model_cfg = self.model_cfg()
        from dge_tpu_torch.systems import edit as E
        from dge_tpu_torch.systems import segmentation as SG

        cell, dev = self.cell, self.dev
        cfg, tr = cell.config, cell.traffic
        rc = cfg["recipe"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.segmentor = SG.build_segmentor(
            "sam2", cfg=model_cfg, device=dev, dtype=self.dtype,
            params=self.weights(self.dtype))
        self.scene_cfg = edit.scene_config(cfg)
        sc = self.scene_cfg
        self.h, self.w = int(rc["height"]), int(rc["width"])
        self.views = int(tr["views"])
        self.poses = S.orbit_cameras(self.views, self.h, self.w)
        self.arrays = S.gt_scene(
            cell.seed % (1 << 63), sh_degree=int(sc["sh_degree"]),
            sh_rest_std=float(sc["assumed"]["sh_rest_std"]),
            scale=float(cfg.get("scene_scale", 1.0)))
        scene = C.program_scene(self.arrays, int(sc["sh_degree"]), dev)
        ecfg = E.EditConfig(max_view_num=self.views,
                            camera_batch_size=int(rc["camera_batch_size"]),
                            seg_prompt="object", seg_box=self.box(),
                            tile_px=int(sc["tile_px"]))
        self.system = E.DGESystem(
            ecfg, scene, [C.program_camera(c, dev) for c in self.poses],
            segmentor=self.segmentor,
            cameras_extent=S.cameras_extent(self.poses))
        self.system.render_all_views()
        for _ in range(int(tr["warmup_rounds"])):
            self.system.segment_views()
        TR.sync()

    def next_round(self) -> None:
        with record_function("bench.round"):
            out = self.system.segment_views()
        if self.kept is None:
            self.kept = {k: getattr(out, k).detach().clone() for k in (
                "masks", "logits", "iou", "stability", "choice", "hit")}
        self.rounds += 1

    def window(self, seconds: float) -> dict:
        n, elapsed, _ = TR.timed_window(self.next_round, seconds)
        self.round_s = elapsed / n
        finite = bool(torch.isfinite(self.kept["logits"]).all())
        return {"metrics": {"edit_views_per_s": self.views * n / elapsed},
                "attempted": n, "failed": 0 if finite else 1}

    def trace_window(self) -> TR.Trace:
        k = int(self.cell.traffic["trace_rounds"])

        def run():
            for _ in range(k):
                self.next_round()
            return k

        return TR.profile(run)

    def release(self) -> None:
        del self.system, self.segmentor
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference ----
    def reference_net(self, mode: str = "float32") -> REF.Sam2:
        with torch.device("meta"):
            net = REF.Sam2(self.cell.config)
        net = net.to_empty(device=self.dev)
        net.load_state_dict({k: v.float() for k, v in self.weights(
            self.dtype).items()})
        set_precision(net, mode)
        return net.eval().requires_grad_(False)

    def reference_round(self, net: REF.Sam2) -> Dict[str, torch.Tensor]:
        """The first round by the plain reference: its own renders at 8-bit
        levels, its own box projection, one view at a time; a view the box
        misses takes the full mask."""
        sc = self.scene_cfg
        params = C.reference_params(self.arrays, self.dev)
        bg = torch.zeros(3, device=self.dev)
        box = self.box()
        out = {k: [] for k in ("logits", "iou", "stability", "choice",
                               "mask", "hit")}
        for pose in self.poses:
            img = C.quantize_u8(raster.render(
                params, C.reference_camera(pose, self.dev),
                int(sc["sh_degree"]), bg, int(sc["tile_px"])).color)
            b = REF.box_in_view(box, pose)
            r = REF.predict(net, img, b if b is not None else [0, 0, 0, 0])
            r["hit"] = torch.tensor(b is not None, device=self.dev)
            if b is None:
                r["mask"] = torch.ones_like(r["mask"])
            for k in out:
                out[k].append(r[k])
        return {k: torch.stack(v) for k, v in out.items()}

    def gaps(self, got: Dict[str, torch.Tensor],
             ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
        lim = self.cell.limits
        both = got["hit"] & ref["hit"]
        d = (got["logits"][both] - ref["logits"][both]).abs().mean()
        gap = float(d / ref["logits"][both].abs().mean().clamp(min=1e-12))
        # the reference's maps under the program's selection
        idx = torch.arange(len(got["choice"]), device=self.dev)
        chosen = ref["logits"][idx, got["choice"]]
        masks = F.interpolate(chosen[:, None], size=got["masks"].shape[1:],
                              mode="bilinear", align_corners=False)[:, 0] > 0
        masks = torch.where(ref["hit"][:, None, None], masks, True)
        flips = float((masks != (got["masks"] > 0.5)).float().mean())
        # a selection is clear where the reference's stability s lies
        # farther from the threshold than stability_margin x (1 - s), the
        # share of its area in the band around 0 that rounding can move,
        # and, falling back, its best IoU beyond iou_margin from the
        # runner-up's
        thresh = float(self.cell.config["mask_decoder"][
            "dynamic_multimask_stability_thresh"])
        s = ref["stability"]
        top2 = ref["iou"][:, 1:].topk(2, dim=-1).values
        clear = ((s - thresh).abs() > lim["stability_margin"] * (1.0 - s)
                 ) & ((ref["choice"] == 0)
                      | (top2[:, 0] - top2[:, 1] > lim["iou_margin"]))
        differ = (got["choice"] != ref["choice"]) & clear
        return {"mask_logit_gap": gap, "mask_flip_share": flips,
                "selection_disagrees": float(differ.sum()) / max(
                    int(clear.sum()), 1)}

    def check(self) -> Dict[str, dict]:
        with exact_float32():
            ref = self.reference_round(self.reference_net())
        got = self.gaps({k: v.to(self.dev) for k, v in self.kept.items()},
                        ref)
        self.last_gaps = got
        lim = self.cell.limits
        return {k: C.check(v, lim[k]) for k, v in got.items() if k in lim}

    def round_flops(self) -> float:
        with torch.device("meta"):
            net = REF.Sam2(self.cell.config)
        return REF.pass_flops(net, self.views)
