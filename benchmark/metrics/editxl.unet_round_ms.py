"""editxl.unet_round_ms: the SDXL UNet's passes of a round, every kind (the
program's ``unet.plain``, ``unet.pivot_record`` and ``unet.pivot_reuse``
spans of diffusion/ip2p.unet_eps: CUDA events at entry and exit), their
device intervals summed over the span window, per round
(yardstick/spans.py)."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.sum_per_unit(ctx, "unet.")


def read(ctx):
    return ctx.raw.get("editxl.unet_round_ms")
