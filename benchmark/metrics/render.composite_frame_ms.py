"""render.composite_frame_ms: the compositor (K1's row and combine kernels
behind ops/pairs_composite) inside a whole frame: the device interval of the
program's ``render.composite`` span (CUDA events at its entry and exit in
ops/render.rasterize, idle time between its kernels included), summed over
a frame, median over the span window's frames (yardstick/spans.py)."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.median_per_request(ctx, "render.composite")


def read(ctx):
    return ctx.raw.get("render.composite_frame_ms")
