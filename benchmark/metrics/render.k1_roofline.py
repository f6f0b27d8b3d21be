"""render.k1_roofline: the compositing forward's least time on the card
over the device time of K1's row and combine kernels in the profiled
window, in percent. The least time is the larger of the operations (the
(Gaussian, pixel) pairs the plain reference visits before each pixel's
stop, times the forward's count a visit in yardstick/splat_ops.json) at the
float32 peak and the bytes (features read once, colour, depth and
transmittance written once) at HBM rate."""

from benchmark.yardstick import work as WK

# K1 (csrc/pairs_composite.cu over pair_rows_forward.cuh): the row kernel
# and the combine kernel; the render path runs no other of their forms
KERNELS = ("rows_forward_kernel", "rows_combine_kernel")


def read(ctx):
    dev_s = ctx.trace.device_s(KERNELS)
    if not dev_s:
        return None
    w = ctx.driver.work()
    f = WK.forward_work(w["visits"], w["gaussians"], w["pixels"])
    return 100.0 * WK.bound_s(f["flops"], f["bytes"]) / dev_s
