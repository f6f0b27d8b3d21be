"""seg.global_attn_round_ms: the attention of the trunk's global blocks in
a round (the program's ``seg.global_attn`` spans of models/sam2: qkv, the
attention over the whole token grid and the projection, inside
``seg.encode``), their device intervals summed over the span window, per
round (yardstick/spans.py). A program without the span gives nothing."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.sum_per_unit(ctx, "seg.global_attn")


def read(ctx):
    return ctx.raw.get("seg.global_attn_round_ms")
