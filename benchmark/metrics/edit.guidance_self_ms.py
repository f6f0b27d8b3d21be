"""edit.guidance_self_ms: the guidance round's own device time (the
program's ``guidance.round`` span of systems/guidance.DGEGuidance.__call__,
CUDA events at entry and exit, less the device intervals of the VAE, UNet,
cross-view state and CFG + DDIM spans inside it): the resize, noise,
gathers and concatenations between the layers, and the card's idle time
there, over the span window, per round (yardstick/spans.py)."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.self_per_unit(ctx, "guidance.round")


def read(ctx):
    return ctx.raw.get("edit.guidance_self_ms")
