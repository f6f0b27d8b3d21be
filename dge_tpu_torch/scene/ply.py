"""3DGS PLY I/O, byte-compatible with the reference layout.

JAX counterpart: ``dge_tpu/scene/ply.py`` (numpy only; kept as a copy so
that this package imports nothing of ``dge_tpu``).

The reference writes binary-little-endian PLY with per-vertex float32
attributes ``x y z nx ny nz f_dc_0..2 f_rest_0..3(K-1)-1 opacity scale_0..2
rot_0..3`` (gaussian_model.py:396-445). ``f_rest`` is flattened
channel-major: the in-memory layout is ``[N, K-1, 3]`` but the file stores
``[N, 3, K-1]`` flattened (save_ply transposes at gaussian_model.py:414-430,
load_ply transposes back at :485-512).

Implemented with numpy structured arrays — no external plyfile dependency.
"""

from __future__ import annotations

import io
import os
from typing import Dict

import numpy as np

_PLY_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "short": "<i2",
    "int16": "<i2",
    "ushort": "<u2",
    "uint16": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read all properties of the first 'vertex' element of a PLY file.

    Supports binary_little_endian and ascii formats (scalar properties only,
    which covers every 3DGS PLY)."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in PLY header")
            header_lines.append(line.decode("ascii", errors="replace").strip())
            if header_lines[-1] == "end_header":
                break
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)])
        for ln in header_lines:
            parts = ln.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    raise ValueError(f"{path}: list properties not supported")
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))
        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            dtype = np.dtype(props)
            if fmt == "binary_little_endian":
                data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
            else:
                rows = [f.readline().split() for _ in range(count)]
                data = np.zeros(count, dtype=dtype)
                for i, row in enumerate(rows):
                    data[i] = tuple(
                        np.dtype(d).type(float(v)) for v, (_, d) in zip(row, props)
                    )
            if name == "vertex":
                for pname, _ in props:
                    out[pname] = np.ascontiguousarray(data[pname])
                return out
        raise ValueError(f"{path}: no 'vertex' element found")


def write_ply(path: str, props: Dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian PLY with float32 scalar vertex properties,
    in the given dict order (insertion-ordered)."""
    names = list(props)
    n = len(props[names[0]])
    dtype = np.dtype([(k, "<f4") for k in names])
    data = np.zeros(n, dtype=dtype)
    for k in names:
        v = np.asarray(props[k], dtype=np.float32).reshape(n)
        data[k] = v
    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n".encode())
    for k in names:
        header.write(f"property float {k}\n".encode())
    header.write(b"end_header\n")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.getvalue())
        f.write(data.tobytes())


def load_gaussian_ply(path: str) -> Dict[str, np.ndarray]:
    """Load a 3DGS PLY into raw (pre-activation) parameter arrays.

    Returns dict with xyz[N,3], features_dc[N,1,3], features_rest[N,K-1,3],
    opacity[N,1] (raw logit — sigmoid applied by the activation, matching
    load_ply at gaussian_model.py:455-551), scaling[N,3] (log), rotation[N,4]
    (unnormalized wxyz quat), and the inferred max_sh_degree.
    """
    p = read_ply(path)
    n = len(p["x"])
    xyz = np.stack([p["x"], p["y"], p["z"]], axis=1).astype(np.float32)
    f_dc = np.stack([p["f_dc_0"], p["f_dc_1"], p["f_dc_2"]], axis=1).astype(np.float32)
    rest_names = sorted(
        (k for k in p if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    max_sh_degree = int(((len(rest_names) + 3) / 3) ** 0.5 - 1)
    if rest_names:
        rest = np.stack([p[k] for k in rest_names], axis=1).astype(np.float32)
        # file layout channel-major [N, 3, K-1] -> memory layout [N, K-1, 3]
        rest = rest.reshape(n, 3, (max_sh_degree + 1) ** 2 - 1).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, 0, 3), dtype=np.float32)
    scale_names = sorted(
        (k for k in p if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1])
    )
    rot_names = sorted(
        (k for k in p if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1])
    )
    return {
        "xyz": xyz,
        "features_dc": f_dc.reshape(n, 1, 3),
        "features_rest": np.ascontiguousarray(rest),
        "opacity": p["opacity"].astype(np.float32).reshape(n, 1),
        "scaling": np.stack([p[k] for k in scale_names], axis=1).astype(np.float32),
        "rotation": np.stack([p[k] for k in rot_names], axis=1).astype(np.float32),
        "max_sh_degree": max_sh_degree,
    }


def save_gaussian_ply(
    path: str,
    xyz: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    opacity: np.ndarray,
    scaling: np.ndarray,
    rotation: np.ndarray,
) -> None:
    """Save raw parameter arrays in the reference's exact attribute order
    (construct_list_of_attributes, gaussian_model.py:396-408)."""
    n = xyz.shape[0]
    props: Dict[str, np.ndarray] = {}
    for i, k in enumerate(("x", "y", "z")):
        props[k] = xyz[:, i]
    for k in ("nx", "ny", "nz"):
        props[k] = np.zeros(n, dtype=np.float32)
    f_dc = features_dc.reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_dc.shape[1]):
        props[f"f_dc_{i}"] = f_dc[:, i]
    f_rest = features_rest.reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_rest.shape[1]):
        props[f"f_rest_{i}"] = f_rest[:, i]
    props["opacity"] = opacity.reshape(n)
    for i in range(scaling.shape[1]):
        props[f"scale_{i}"] = scaling[:, i]
    for i in range(rotation.shape[1]):
        props[f"rot_{i}"] = rotation[:, i]
    write_ply(path, props)
