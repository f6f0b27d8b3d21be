"""editxl.mfu: an SDXL edit round's floating-point operations, as
FlopCounterMode counts them over the benchmark's plain reference networks
at the round's shapes (reference/sdxl.pass_flops, reference/dge.round_flops:
the UNet with its added embedding, the reuse's float32 similarity, the
VAE), over the round time of the measured window at the card's bfloat16
peak, in percent: the share of the whole step."""

from benchmark.yardstick import work as WK


def read(ctx):
    d = ctx.driver
    if d.dev.type != "cuda":
        return None
    return 100.0 * d.round_flops() / (d.round_s * WK.PEAKS["bfloat16_flops"])
