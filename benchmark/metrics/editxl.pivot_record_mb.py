"""editxl.pivot_record_mb: the megabytes (1e6 bytes) written to the pivot
records in a round (the program's ``pivot_record_bytes`` counters of
models/layers, every token count: each block's normed states and attention
output in each pivot pass), over the span window, per round
(yardstick/spans.py). A program without the counter gives nothing."""

from benchmark.yardstick import spans


def measure(ctx):
    b = spans.counter_per_unit(ctx, "pivot_record_bytes")
    return None if b is None else b / 1e6


def read(ctx):
    return ctx.raw.get("editxl.pivot_record_mb")
