"""render.preprocess_frame_ms: the preprocess layer (ops/projection with
ops/sh) inside a whole frame: the device interval of the program's
``render.preprocess`` span (CUDA events at its entry and exit in
ops/render.render, idle time between its kernels included), summed over a
frame, median over the span window's frames (yardstick/spans.py)."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.median_per_request(ctx, "render.preprocess")


def read(ctx):
    return ctx.raw.get("render.preprocess_frame_ms")
