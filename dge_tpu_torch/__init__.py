"""dge_tpu_torch — the PyTorch/CUDA port of ``dge_tpu`` for NVIDIA Hopper.

The package keeps ``dge_tpu``'s module layout (``scene/``, ``ops/``,
``models/``, ``diffusion/``, ``systems/``, ``parallel/``, ``utils/``,
``launch.py``) so that each counterpart is easy to find; every
module's docstring names its JAX counterpart. It imports ``torch`` and never
``jax`` or ``dge_tpu``.

Entry points take ``device`` and default to ``"cuda"``. The CPU is used only
when the caller asks for it; ``device="cuda"`` without a card raises.

``register`` and ``find`` are the component registry (threestudio's plain
dict, threestudio/__init__.py:1-13): ``"dge-guidance"`` and ``"dge-system"``
name ``systems.guidance.DGEGuidance`` and ``systems.edit.DGESystem``.
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


__modules__: dict = {}


def register(name: str):
    """Class decorator: register the class under the public ``name``; a
    second class under a taken name raises."""

    def decorator(cls):
        if name in __modules__ and __modules__[name] is not cls:
            raise ValueError(f"component '{name}' already registered")
        __modules__[name] = cls
        return cls

    return decorator


def find(name: str):
    """The class registered under ``name``, importing the modules that
    register on first use; an unknown name raises ``KeyError``."""
    if name not in __modules__:
        import dge_tpu_torch.systems.edit  # noqa: F401  (both register)
    if name not in __modules__:
        raise KeyError(
            f"component '{name}' not registered; known: {sorted(__modules__)}")
    return __modules__[name]
