"""edit.unet_pass_ms: one 2-key reuse pass of the UNet (models/unet in the
configuration's dtype, one camera batch: three CFG chunks of 5 frames at
64x64 latents) alone, as tools/profile_edit.py stages it: CUDA events,
median of 3 calls after one."""

from benchmark.yardstick.timing import stage_ms


def measure(ctx):
    return stage_ms(ctx.driver.layer_calls()["unet_reuse_2key"])


def read(ctx):
    return ctx.raw.get("edit.unet_pass_ms")
