"""dge_tpu_torch — the PyTorch/CUDA port of ``dge_tpu`` for NVIDIA Hopper.

The package keeps ``dge_tpu``'s module layout (``scene/``, ``ops/``,
``models/``, ``diffusion/``, ``systems/``, ``parallel/``, ``utils/``,
``launch.py``) so that each counterpart is easy to find; every
module's docstring names its JAX counterpart. It imports ``torch`` and never
``jax`` or ``dge_tpu``.

Entry points take ``device`` and default to ``"cuda"``. The CPU is used only
when the caller asks for it; ``device="cuda"`` without a card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and no
    card is present (nothing moves to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --cpu) to run on the CPU"
        )
    return dev
