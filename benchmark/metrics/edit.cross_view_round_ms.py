"""edit.cross_view_round_ms: the cross-view states of a round (the program's
``guidance.cross_view_state`` spans of systems/guidance: each camera batch's
state and their concatenation for the batched reuse, CUDA events at entry
and exit), their device intervals summed over the span window, per round
(yardstick/spans.py)."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.sum_per_unit(ctx, "guidance.cross_view_state")


def read(ctx):
    return ctx.raw.get("edit.cross_view_round_ms")
