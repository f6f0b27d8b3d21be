"""seg.mfu: a mask round's floating-point operations, as FlopCounterMode
counts them over the benchmark's plain reference network at the round's
shapes (reference/sam2.pass_flops: the trunk, the neck, the prompt encoder
and the decoder of every view), over the round time of the measured window
at the card's bfloat16 peak, in percent: the share of the whole step."""

from benchmark.yardstick import work as WK


def read(ctx):
    d = ctx.driver
    if d.dev.type != "cuda":
        return None
    return 100.0 * d.round_flops() / (d.round_s * WK.PEAKS["bfloat16_flops"])
