"""Random network weights, drawn on the card from a seed in one call.

Every weight of the named tensors comes from one standard normal draw of
all their elements together, made with a ``torch.Generator`` on the device
and then scaled a tensor at a time: kernels of linear and convolution layers
to variance 1/fan_in (fan_in = elements / output channels), embedding tables
to variance 1/width; one-dimensional weights (norm scales) are 1 and biases
0. The values are rounded once to the type the networks are served in.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def draw(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``shapes`` (name, shape) pairs."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    for name, shape in shapes:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if len(shape) == 1:
            v.fill_(1.0 if name.endswith("weight") else 0.0)
        elif "embedding" in name:
            v.mul_(1.0 / math.sqrt(shape[-1]))
        else:
            v.mul_(1.0 / math.sqrt(n // shape[0]))
    flat = flat.to(dtype)
    res, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        res[name] = flat[off:off + n].view(shape)
        off += n
    return res
