"""render.binning_ms: the pair binning alone (ops/binning.bin_gaussians_pairs
at the renderer's probed caps) for one orbit view at 1920x1080, CUDA
events, median of 10 calls."""

from benchmark.yardstick.timing import cuda_ms


def measure(ctx):
    import torch

    from dge_tpu_torch.ops import binning, projection

    scene, cam, renderer = ctx.driver.layer_inputs()
    with torch.no_grad():
        prep = projection.preprocess(
            scene.xyz, scene.get_scaling, scene.get_rotation,
            scene.get_opacity, scene.get_features, scene.alive, cam,
            scene.active_sh_degree, scene.max_sh_degree)
    caps = renderer.caps
    cull = renderer.tight_cull

    def call():
        binning.bin_gaussians_pairs(
            prep.mean2d, prep.depth, prep.radius, prep.visible,
            height=cam.height, width=cam.width,
            tile_px=int(ctx.cell.config["tile_px"]), **caps,
            conic=prep.conic if cull else None,
            opacity=prep.opacity if cull else None)

    return cuda_ms(call)


def read(ctx):
    return ctx.raw.get("render.binning_ms")
