"""The render driver: novel views along an orbit, one frame in flight.

Traffic parameters: ``height`` and ``width`` of a frame, ``orbit_frames``
(the fixed poses of the orbit; a seeded start and direction), ``sh_degree``
of the colour, ``checked`` (how many frames of the window the reference
renders again, drawn from the seed among the first ``checked_among``),
``warmup_frames`` and ``trace_frames``. A frame is timed from the call
until its image is on the device, synchronised, as a viewer that waits for
each frame.

Set-up builds the seed's scene at SH degree 3 in the program and an
``ops/render.SpillFreeRenderer`` whose caps it probes spill-free over every
pose of the orbit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.drivers import common as C
from benchmark.reference import raster
from benchmark.reference.precision import Precision, exact_float32
from benchmark.yardstick import scene as S
from benchmark.yardstick import trace as TR
from benchmark.yardstick import work as WK


# a pixel is "wide" where its widest channel's gap passes this
# (5 of 255 levels)
WIDE = 0.02


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.dev = cell.device
        self.frames = 0
        self.spilled = 0

    def setup(self) -> None:
        from dge_tpu_torch.ops import render as R

        cell, dev, tr = self.cell, self.dev, self.cell.traffic
        self.h, self.w = int(tr["height"]), int(tr["width"])
        self.sh = int(cell.config["sh_degree"])
        self.tile = int(cell.config["tile_px"])
        self.arrays = C.scene_arrays(cell)
        poses = S.orbit_cameras(int(tr["orbit_frames"]), self.h, self.w)
        rng = np.random.default_rng(cell.rng_seed(5))
        start = int(rng.integers(len(poses)))
        step = 1 if rng.integers(2) else -1
        self.order = [(start + step * i) % len(poses)
                      for i in range(len(poses))]
        self.poses = poses
        self.cams = [C.program_camera(c, dev) for c in poses]
        self.bg = (torch.ones(3, device=dev)
                   if cell.config["white_background"]
                   else torch.zeros(3, device=dev))
        scene = C.program_scene(self.arrays, self.sh, dev)
        self.renderer = R.SpillFreeRenderer(scene, self.bg, tile_px=self.tile)
        for cam in self.cams:
            if self.renderer.probe(cam):
                raise RuntimeError("an orbit pose spills at the caps' "
                                   "ceilings")
        among = int(tr["checked_among"])
        self.sample = sorted(int(i) for i in rng.choice(
            among, size=int(tr["checked"]), replace=False))
        self.kept: Dict[int, torch.Tensor] = {}
        self.counting = False
        for _ in range(int(tr["warmup_frames"])):
            self.frame()
        self.frames = 0
        self.counting = True

    def pose(self, i: int) -> int:
        return self.order[i % len(self.order)]

    def frame(self) -> None:
        i = self.frames
        with record_function("bench.frame"):
            color, spill = self.renderer(self.cams[self.pose(i)])
        if self.counting and i in self.sample:
            self.kept[i] = color.detach().clone()
        self.spilled += spill > 0
        self.frames += 1

    def window(self, seconds: float) -> dict:
        before = self.spilled
        n, elapsed, each = TR.timed_window(self.frame, seconds, sync_each=True)
        self.frame_s = elapsed / n
        ms = self.frame_ms = np.asarray(each) * 1e3
        return {"metrics": {"render_fps": n / elapsed,
                            "render_ms_p95": float(np.percentile(ms, 95))},
                "attempted": n, "failed": self.spilled - before
                + sum(1 for i in self.sample if i not in self.kept)}

    def trace_window(self) -> TR.Trace:
        k = int(self.cell.traffic["trace_frames"])
        first = self.frames

        def run():
            for _ in range(k):
                self.frame()
            return k

        t = TR.profile(run)
        self.traced = [self.pose(i) for i in range(first, first + k)]
        return t

    def layer_inputs(self):
        """The program's scene and one orbit camera, for timing the render's
        layers alone."""
        return self.renderer._scene, self.cams[self.pose(0)], self.renderer

    def release(self) -> None:
        del self.renderer
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_frames(self, prec: Precision,
                         depth_levels: bool = False
                         ) -> Dict[int, torch.Tensor]:
        """The reference's render of each kept frame's pose."""
        params = C.reference_params(self.arrays, self.dev)
        out = {}
        with exact_float32():
            for i in self.kept:
                cam = C.reference_camera(self.poses[self.pose(i)], self.dev)
                out[i] = raster.render(params, cam, self.sh, self.bg,
                                       self.tile, prec, depth_levels).color
        return out

    @staticmethod
    def gaps(got: Dict[int, torch.Tensor], ref: Dict[int, torch.Tensor]
             ) -> Dict[str, float]:
        """Over the checked frames: the largest mean absolute gap of a
        frame; the largest share of a frame's pixels that are wide (a
        pixel's gap is its widest channel's); the median of that share over
        the frames; and the widest pixel gap (read, not compared). Where
        near-equal depths fall into one level of the program's depth key,
        they blend in another order than the reference's and widen patches
        of pixels in some frames; on 16 seeds the median share stayed at
        or under a fifth of a 32x32 tile's pixels (PERF.md), so it catches
        a wrong tile that every frame has."""
        d = [(got[i] - ref[i]).abs() for i in ref]
        px = [x.amax(dim=-1) for x in d]
        share = [float((p > WIDE).float().mean()) for p in px]
        return {"frame_mean_gap": max(float(x.mean()) for x in d),
                "wide_pixel_share": max(share),
                "wide_pixel_share_median": float(np.median(share)),
                "frame_max_gap": max(float(p.max()) for p in px)}

    def check(self) -> Dict[str, dict]:
        got = self.gaps(self.kept, self.reference_frames(Precision()))
        self.last_gaps = got
        lim = self.cell.limits
        return {k: C.check(v, lim[k]) for k, v in got.items() if k in lim}

    def work(self) -> dict:
        """Visited (Gaussian, pixel) pairs and visible Gaussians of the
        profiled window's frames, by the reference."""
        if getattr(self, "_work", None) is None:
            params = C.reference_params(self.arrays, self.dev)
            visits = gauss = 0
            with exact_float32():
                for p in self.traced:
                    cam = C.reference_camera(self.poses[p], self.dev)
                    pr = raster.project(params, cam, self.sh)
                    img = raster.composite(pr, self.h, self.w, self.bg,
                                           self.tile)
                    visits += img.evaluated
                    gauss += int(pr.visible.sum())
            frames = len(self.traced)
            self._work = dict(visits=visits, gaussians=gauss, frames=frames,
                              pixels=frames * self.h * self.w,
                              all_gaussians=frames * len(self.arrays["xyz"]))
        return self._work

    def frame_flops(self) -> float:
        w = self.work()
        return WK.frame_flops(w["visits"], w["all_gaussians"]) / w["frames"]
