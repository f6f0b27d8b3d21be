"""render.mfu: a frame's counted work (yardstick/work.frame_flops:
preprocess and the compositing forward from the reference's visited pairs)
over the frame time of the measured window at the card's float32 peak, in
percent."""

from benchmark.yardstick import work as WK


def read(ctx):
    d = ctx.driver
    if d.dev.type != "cuda":
        return None
    return 100.0 * d.frame_flops() / (d.frame_s * WK.PEAKS["float32_flops"])
