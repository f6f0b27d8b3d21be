"""render.preprocess_ms: the preprocess layer alone (ops/projection with
ops/sh at SH degree 3) for one orbit view at 1920x1080, CUDA events,
median of 10 calls."""

from benchmark.yardstick.timing import cuda_ms


def measure(ctx):
    import torch

    from dge_tpu_torch.ops import projection

    scene, cam, _ = ctx.driver.layer_inputs()

    def call():
        with torch.no_grad():
            projection.preprocess(
                scene.xyz, scene.get_scaling, scene.get_rotation,
                scene.get_opacity, scene.get_features, scene.alive, cam,
                scene.active_sh_degree, scene.max_sh_degree)

    return cuda_ms(call)


def read(ctx):
    return ctx.raw.get("render.preprocess_ms")
