"""editxl.reuse_match_round_ms: the epipolar argmax of every reuse block of
a round (the program's ``attn.reuse_match`` spans of models/layers: the
float32 cosine similarity and its masked argmax over the pivot tokens, CUDA
events at entry and exit), their device intervals summed over the span
window, per round (yardstick/spans.py). A program without the span gives
nothing."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.sum_per_unit(ctx, "attn.reuse_match")


def read(ctx):
    return ctx.raw.get("editxl.reuse_match_round_ms")
