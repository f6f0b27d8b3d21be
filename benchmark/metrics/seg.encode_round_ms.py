"""seg.encode_round_ms: the image encoder of a round (the program's
``seg.encode`` spans of systems/segmentation: the input's resize, the Hiera
trunk, the FPN neck and the high-resolution features of each batch, CUDA
events at entry and exit), their device intervals summed over the span
window, per round (yardstick/spans.py). A program without the span gives
nothing."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.sum_per_unit(ctx, "seg.encode")


def read(ctx):
    return ctx.raw.get("seg.encode_round_ms")
