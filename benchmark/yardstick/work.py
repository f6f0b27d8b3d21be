"""The work a rendered frame needs, from counts the plain
reference makes, and the least time the card could take for it.

Operation counts a unit of work are fixed in ``splat_ops.json`` and the
card's peaks in ``peaks.json``, both beside this file; the counts of
visited (Gaussian, pixel) pairs come from ``reference.raster`` on the
inputs the program was given, never from the program's own pair counts or
tile sizes.
"""

from __future__ import annotations

import json
import os
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name: str) -> dict:
    with open(os.path.join(_HERE, name)) as f:
        return json.load(f)


OPS = _load("splat_ops.json")
PEAKS = _load("peaks.json")


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The larger of operations at the peak rate and bytes at HBM rate."""
    return max(flops / PEAKS[dtype + "_flops"],
               nbytes / PEAKS["hbm_bytes_per_s"])


def forward_work(visits: int, gaussians: int, pixels: int) -> Dict[str, float]:
    """Compositing forward: each visible Gaussian's features read once, the
    image (colour, depth, transmittance) written once."""
    return {"flops": visits * OPS["forward_per_visit"],
            "bytes": gaussians * OPS["feature_bytes_per_gaussian"]
            + pixels * OPS["image_bytes_per_pixel"]}


def frame_flops(visits: int, gaussians: int) -> float:
    """A rendered frame: preprocess of every Gaussian and the forward."""
    return (gaussians * OPS["preprocess_forward_per_gaussian"]
            + visits * OPS["forward_per_visit"])

