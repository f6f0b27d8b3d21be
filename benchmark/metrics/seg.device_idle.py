"""seg.device_idle: the share of the profiled mask rounds in which no
operation ran on the card, in percent (1 - busy / window, from the
trace)."""


def read(ctx):
    t = ctx.trace
    if t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
