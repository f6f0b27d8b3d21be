"""edit.host_syncs_per_round: the times a round's program waits for the
card to read a device value on the host (the ``host_syncs`` counters of
dge_tpu_torch/utils/tracing.py, all sites: the renders' spill, the pivot
offsets), over the span window, per round (yardstick/spans.py). The edit
cell's own reads in benchmark/drivers/edit.py (the ring order's cameras)
are not the program's and do not count."""

from benchmark.yardstick import spans


def measure(ctx):
    return spans.counter_per_unit(ctx, "host_syncs")


def read(ctx):
    return ctx.raw.get("edit.host_syncs_per_round")
