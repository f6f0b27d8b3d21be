"""seg.host_syncs_per_round: the times a mask round's program waits for the
card to read a device value on the host (the ``host_syncs`` counters of
dge_tpu_torch/utils/tracing.py, all sites: ``seg.fallbacks``, the count of
boxes that missed their view), over the span window, per round
(yardstick/spans.py)."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.counter_per_unit(ctx, "host_syncs")


def read(ctx):
    return ctx.raw.get("seg.host_syncs_per_round")
