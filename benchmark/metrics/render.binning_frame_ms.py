"""render.binning_frame_ms: the pair binning (ops/binning) inside a whole
frame: the device interval of the program's ``render.binning`` span (CUDA
events at its entry and exit in ops/render.rasterize, idle time between its
kernels included), summed over a frame, median over the span window's
frames (yardstick/spans.py)."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.median_per_request(ctx, "render.binning")


def read(ctx):
    return ctx.raw.get("render.binning_frame_ms")
