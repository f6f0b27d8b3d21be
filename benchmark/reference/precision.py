"""Operand rounding for the reference's products.

The plain reference computes every product (matrix product, convolution,
attention) in float32 with TF32 off. Its control is the same reference with
the operands of those products rounded to a lower precision first, as the
hardware would round them: ``"tf32"`` keeps 10 mantissa bits (the tensor
cores' TF32 input format, float32 accumulation), ``"fp8"`` rounds to
float8 e4m3 with one scale a tensor (amax to 448). ``"float32"`` is the
identity. The rounding is explicit, so the control reads the same on every
device and on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("float32", "tf32", "fp8")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to TF32 (round to nearest, ties away from zero on
    the 13 dropped mantissa bits), returned as float32."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    out = rounded.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` to float8 e4m3 under one per-tensor scale (the tensor's
    largest magnitude to 448), returned in float32."""
    x = x.float()
    amax = x.abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """Where the reference rounds the operands of its products."""

    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"unknown precision {mode!r}; one of {MODES}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in float32, its value rounded; a gradient passes the
        rounding unchanged."""
        x = x.float()
        if self.mode == "float32":
            return x
        with torch.no_grad():
            r = round_tf32(x) if self.mode == "tf32" else round_fp8(x)
        return x + (r - x).detach() if x.requires_grad else r


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions while the reference
    runs (the process's settings are restored after it)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
