"""The view mesh and camera batching: stack per-view cameras along a
leading axis.

JAX counterpart: ``dge_tpu/parallel/mesh.py`` (``VIEW_AXIS``,
``make_view_mesh``, ``stack_cameras``, ``index_cameras``). A mesh here is a
grid of the group's ranks (``dist.Mesh``), each rank running the same code.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dge_tpu_torch.parallel import dist
from dge_tpu_torch.scene.camera_arrays import CameraArrays

VIEW_AXIS = "view"


def make_view_mesh(n: Optional[int] = None) -> dist.Mesh:
    """1-D mesh over the view (camera) axis; ``n`` defaults to the group's
    size and must equal it."""
    return dist.Mesh((n or dist.world_size(),), (VIEW_AXIS,))


def stack_cameras(cams: Sequence[CameraArrays]) -> CameraArrays:
    """Stack per-view cameras along a leading batch axis; all must share
    H and W."""
    h, w = cams[0].height, cams[0].width
    if not all(c.height == h and c.width == w for c in cams):
        raise ValueError("stack_cameras needs cameras of one size")
    return CameraArrays(
        w2c=torch.stack([c.w2c for c in cams]),
        full_proj=torch.stack([c.full_proj for c in cams]),
        campos=torch.stack([c.campos for c in cams]),
        tan_half_fovx=torch.stack([c.tan_half_fovx for c in cams]),
        tan_half_fovy=torch.stack([c.tan_half_fovy for c in cams]),
        height=h,
        width=w,
    )


def index_cameras(batch: CameraArrays, i) -> CameraArrays:
    """View ``i`` of a stacked batch; ``i`` may also be an index tensor,
    which gives a smaller stacked batch."""
    return CameraArrays(
        w2c=batch.w2c[i],
        full_proj=batch.full_proj[i],
        campos=batch.campos[i],
        tan_half_fovx=batch.tan_half_fovx[i],
        tan_half_fovy=batch.tan_half_fovy[i],
        height=batch.height,
        width=batch.width,
    )
