"""Per-Gaussian preprocessing: cull, project, covariance, color.

JAX counterpart: ``dge_tpu/ops/projection.py``; the reference is the
preprocess kernel (cuda_rasterizer/forward.cu:74-256). ``preprocess`` takes
one of two paths, by what it can see in its inputs:

- ``_preprocess_kernel``, the hand-written CUDA kernel of
  ``dge_tpu_torch/csrc/preprocess.cu`` (one thread a slot, one launch a
  call, the camera read from its device tensors), for inputs on a CUDA
  device that need no autograd graph: grad mode off, or no input requiring
  a gradient. Its ``mean2d``, ``depth``, ``conic``, ``radius`` and
  ``visible`` are the torch path's bit for bit, its ``rgb`` within 1e-6 (it
  takes the colour's two sums in the order PyTorch's reduction kernel does,
  which nothing pins: its source note);
- ``_preprocess_torch``, plain tensor ops over the padded Gaussian buffer,
  in the same f32 operation order as the JAX version, so the two agree to
  rounding: the CPU twin, and the path under autograd (the fit).

``cuda_build.launch_counts["preprocess"]`` counts the kernel's launches.

Conventions:
- ``ndc2pix(v, S) = ((v + 1) S - 1) / 2`` (auxiliary.h:40-43)
- near-cull at view z <= 0.2 (auxiliary.h in_frustum)
- EWA low-pass: += 0.3 on cov2D diagonal (forward.cu:110-111)
- radius = ceil(3 sqrt(max eigenvalue)) (forward.cu:229-232)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dge_tpu_torch.ops import cuda_build
from dge_tpu_torch.ops import sh as sh_ops

NEAR_Z = 0.2
# the camera's tensors the kernel reads, in the order it takes them
CAMERA_FIELDS = (("w2c", (4, 4)), ("full_proj", (4, 4)), ("campos", (3,)),
                 ("tan_half_fovx", ()), ("tan_half_fovy", ()))


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (padded to capacity)."""

    mean2d: torch.Tensor  # [N, 2] pixel coords
    depth: torch.Tensor  # [N] view-space z
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # [N] float pixel radius (0 for culled)
    rgb: torch.Tensor  # [N, 3]
    opacity: torch.Tensor  # [N]
    visible: torch.Tensor  # [N] bool


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion(s) to rotation matrices, [..., 4] -> [..., 3, 3]
    (build_rotation, general_utils.py:78-98)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - r * z),
            2 * (x * z + r * y),
            2 * (x * y + r * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - r * x),
            2 * (x * z - r * y),
            2 * (y * z + r * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def compute_cov3d(scale: torch.Tensor, quat: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """World-space 3D covariance Sigma = R S S^T R^T (forward.cu:118-152),
    [N, 3, 3], elementwise: Sigma[i,k] = sum_j R[i,j] R[k,j] s_j^2."""
    R = quat_to_rotmat(quat)
    s2 = (scale_modifier * scale) ** 2  # [N, 3]
    rows = []
    for i in range(3):
        cols = []
        for k in range(3):
            cols.append(
                R[..., i, 0] * R[..., k, 0] * s2[..., 0]
                + R[..., i, 1] * R[..., k, 1] * s2[..., 1]
                + R[..., i, 2] * R[..., k, 2] * s2[..., 2]
            )
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def compute_cov2d(p_view, cov3d, w2c_rot, focal_x, focal_y, tan_fovx,
                  tan_fovy) -> torch.Tensor:
    """EWA projection of 3D covariance to screen space (forward.cu:74-113).
    Returns [N, 3] upper-triangular (a, b, c) with the +0.3 low-pass."""
    tz = p_view[:, 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(p_view[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    # rows of T = J @ W with J = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
    w0, w1, w2 = w2c_rot[0], w2c_rot[1], w2c_rot[2]
    c0 = focal_x * inv_z
    c1 = -focal_x * tx * inv_z * inv_z
    d1 = focal_y * inv_z
    d2 = -focal_y * ty * inv_z * inv_z
    t0 = [c0 * w0[k] + c1 * w2[k] for k in range(3)]
    t1 = [d1 * w1[k] + d2 * w2[k] for k in range(3)]

    s = [[cov3d[:, i, j] for j in range(3)] for i in range(3)]

    def quad(u, v):
        acc = 0.0
        for i in range(3):
            si = s[i]
            acc = acc + u[i] * (si[0] * v[0] + si[1] * v[1] + si[2] * v[2])
        return acc

    a = quad(t0, t0) + 0.3
    b = quad(t0, t1)
    c = quad(t1, t1) + 0.3
    return torch.stack([a, b, c], dim=-1)


def ndc2pix(v: torch.Tensor, size) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def preprocess(
    xyz: torch.Tensor,
    scale: torch.Tensor,
    quat: torch.Tensor,
    opacity: torch.Tensor,
    sh: torch.Tensor,
    alive: torch.Tensor,
    cam,
    active_sh_degree: int,
    max_sh_degree: int,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """Full per-Gaussian forward preprocess (forward.cu:156-256). All inputs
    are *activated* parameters; ``cam`` is a CameraArrays on their device.
    The CUDA kernel where the inputs lie on a CUDA device and no autograd
    graph is needed, the torch path otherwise (the module's docstring)."""
    args = (xyz, scale, quat, opacity, sh, alive, cam, active_sh_degree,
            max_sh_degree, scale_modifier, override_color)
    if xyz.device.type == "cuda" and not needs_graph(
            xyz, scale, quat, opacity, sh, override_color,
            *(getattr(cam, name) for name, _ in CAMERA_FIELDS)):
        return _preprocess_kernel(*args)
    return _preprocess_torch(*args)


def needs_graph(*inputs) -> bool:
    """Whether autograd would record a graph through ``inputs``: grad mode
    is on and one of them (a tensor) requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)


def _preprocess_kernel(xyz, scale, quat, opacity, sh, alive, cam,
                       active_sh_degree: int, max_sh_degree: int,
                       scale_modifier: float = 1.0,
                       override_color=None) -> Preprocessed:
    """``preprocess`` on the card: one launch of ``csrc/preprocess.cu``'s
    kernel on the current stream, no host read and no upload. Raises, before
    any launch, on arguments the kernel does not take. ``override_color``
    takes the colour's place, as on the torch path; ``opacity`` comes back
    reshaped, as there."""
    n = xyz.shape[0]
    dev = xyz.device
    f32 = torch.float32
    checks = [("xyz", xyz, f32, (n, 3)), ("scale", scale, f32, (n, 3)),
              ("quat", quat, f32, (n, 4)), ("alive", alive, torch.bool, (n,))]
    camera = []
    for name, shape in CAMERA_FIELDS:
        # the camera's tensors may be views of other arrays: made contiguous
        # here (no copy where they are)
        t = getattr(cam, name)
        camera.append(t.contiguous() if isinstance(t, torch.Tensor) else t)
        checks.append((f"cam.{name}", camera[-1], f32, shape))
    if override_color is None:
        if not 0 <= max_sh_degree <= 3:
            raise ValueError(f"preprocess: SH degree {max_sh_degree} (the "
                             "kernel evaluates degrees 0-3)")
        k = (max_sh_degree + 1) ** 2
        if sh.dim() != 3 or sh.shape[1] < k:
            raise ValueError(f"preprocess: sh must be [{n}, >= {k}, 3], got "
                             f"{tuple(sh.shape)}")
        checks.append(("sh", sh, f32, (n, sh.shape[1], 3)))
    if cuda_build.check_tensors("preprocess", checks):
        raise ValueError(f"preprocess: the kernel runs on a CUDA device, "
                         f"not {dev}")
    mean2d = torch.empty(n, 2, dtype=f32, device=dev)
    depth = torch.empty(n, dtype=f32, device=dev)
    conic = torch.empty(n, 3, dtype=f32, device=dev)
    radius = torch.empty(n, dtype=f32, device=dev)
    visible = torch.empty(n, dtype=torch.bool, device=dev)
    if override_color is None:
        rgb = torch.empty(n, 3, dtype=f32, device=dev)
        sh_in, rgb_out, stride = sh, rgb, sh.shape[1]
    else:
        rgb = override_color.float()
        sh_in = rgb_out = None
        stride = 0
    cuda_build.launch(
        "preprocess_forward", "preprocess", dev, xyz, scale, quat, sh_in,
        alive, *camera, n, int(cam.width), int(cam.height), stride,
        int(max_sh_degree), int(active_sh_degree), float(scale_modifier),
        mean2d, depth, conic, radius, rgb_out, visible)
    return Preprocessed(mean2d=mean2d, depth=depth, conic=conic,
                        radius=radius, rgb=rgb, opacity=opacity.reshape(n),
                        visible=visible)


def _preprocess_torch(
    xyz: torch.Tensor,
    scale: torch.Tensor,
    quat: torch.Tensor,
    opacity: torch.Tensor,
    sh: torch.Tensor,
    alive: torch.Tensor,
    cam,
    active_sh_degree: int,
    max_sh_degree: int,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """``preprocess`` in plain tensor ops, differentiable by autograd."""
    n = xyz.shape[0]
    xyz = xyz.float()

    # expanded row-sum form, not matmuls: exact f32 on every device and the
    # same operation order as the JAX version
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    w = cam.w2c
    pv0 = x * w[0, 0] + y * w[0, 1] + z * w[0, 2] + w[0, 3]
    pv1 = x * w[1, 0] + y * w[1, 1] + z * w[1, 2] + w[1, 3]
    depth = x * w[2, 0] + y * w[2, 1] + z * w[2, 2] + w[2, 3]
    in_front = depth > NEAR_Z

    fp = cam.full_proj
    ph0 = x * fp[0, 0] + y * fp[0, 1] + z * fp[0, 2] + fp[0, 3]
    ph1 = x * fp[1, 0] + y * fp[1, 1] + z * fp[1, 2] + fp[1, 3]
    ph3 = x * fp[3, 0] + y * fp[3, 1] + z * fp[3, 2] + fp[3, 3]
    p_w = 1.0 / (ph3 + 1e-7)

    cov3d = compute_cov3d(scale, quat, scale_modifier)
    # guard z for culled points to keep math finite
    safe_view = torch.stack(
        [pv0, pv1, torch.where(in_front, depth, torch.ones_like(depth))],
        dim=-1,
    )
    cov2d = compute_cov2d(
        safe_view,
        cov3d,
        cam.w2c[:3, :3],
        cam.focal_x,
        cam.focal_y,
        cam.tan_half_fovx,
        cam.tan_half_fovy,
    )
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    det_ok = det > 0.0
    one = torch.ones_like(det)
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, one),
                          torch.zeros_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=1e-12)))

    mean2d = torch.stack(
        [ndc2pix(ph0 * p_w, cam.width), ndc2pix(ph1 * p_w, cam.height)],
        dim=-1,
    )
    on_screen = (
        (mean2d[:, 0] + radius > 0)
        & (mean2d[:, 0] - radius < cam.width)
        & (mean2d[:, 1] + radius > 0)
        & (mean2d[:, 1] - radius < cam.height)
    )
    visible = alive & in_front & det_ok & on_screen

    if override_color is not None:
        rgb = override_color.float()
    else:
        dirs = xyz - cam.campos[None, :]
        dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
                       + 1e-12)
        rgb, _ = sh_ops.eval_sh_color(sh, dirs, active_sh_degree, max_sh_degree)

    radius = torch.where(visible, radius, torch.zeros_like(radius))
    return Preprocessed(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        radius=radius,
        rgb=rgb,
        opacity=opacity.reshape(n),
        visible=visible,
    )
