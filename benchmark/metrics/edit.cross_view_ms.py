"""edit.cross_view_ms: one camera batch's cross-view state
(systems/guidance.make_cross_view_state: closest keys, blend, banded
epipolar lines at four resolutions) alone, as tools/profile_edit.py stages
it: CUDA events, median of 3 calls after one."""

from benchmark.yardstick.timing import stage_ms


def measure(ctx):
    return stage_ms(ctx.driver.layer_calls()["cross_view_state"])


def read(ctx):
    return ctx.raw.get("edit.cross_view_ms")
