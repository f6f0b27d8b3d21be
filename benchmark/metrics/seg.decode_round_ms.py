"""seg.decode_round_ms: the mask decoder of a round (the program's
``seg.decode`` spans of systems/segmentation: the box prompts, the two-way
transformer, the upscaling and heads, the stability selection, the resize
and threshold of each batch), their device intervals summed over the span
window, per round (yardstick/spans.py). A program without the span gives
nothing."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.sum_per_unit(ctx, "seg.decode")


def read(ctx):
    return ctx.raw.get("seg.decode_round_ms")
