"""render.host_syncs_per_frame: the times a frame's program waits for the
card to read a device value on the host (the ``host_syncs`` counters of
dge_tpu_torch/utils/tracing.py, all sites), over the span window, per frame
(yardstick/spans.py)."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.counter_per_unit(ctx, "host_syncs")


def read(ctx):
    return ctx.raw.get("render.host_syncs_per_frame")
