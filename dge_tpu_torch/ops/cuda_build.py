"""The hand-written CUDA kernels' host side: build, load, check, launch,
count.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library ``build/lib<name>_<hash>.so`` at the repository root, keyed by a hash
of the source bytes and of the headers (``csrc/*.cuh``) it may include, with
ptxas's register and spill report beside it
(``*.ptxas.txt``). ``build_all`` compiles several sources at once, one nvcc
process each.

- ``ENTRIES`` declares every C entry once: its library and the kinds of its
  arguments. Every entry takes the current stream last and returns a
  ``cudaError`` as an ``int`` (0: launched).
- ``load(library)`` builds the library at first use, loads it with ctypes
  and sets its entries' signatures from ``ENTRIES``, once.
- ``check_tensors`` is the wrappers' shared check of the tensors they hand
  a kernel: dtype, contiguity, shape and one device. The checks that belong
  to one kernel (its tile and chunk limits, its row layout) stay in its
  wrapper.
- ``launch(entry, counter, device, *args)`` launches one entry on the
  device's current stream and counts it in ``launch_counts[counter]``, the
  tracing registry's group of kernel launches.

A new kernel is one entry in ``ENTRIES`` and one ``launch`` call in its
wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import numbers
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import torch

from dge_tpu_torch.utils import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("pairs_composite", "pairs_backward", "pairs_logdot",
           "list_stream", "binning", "preprocess", "reuse_match")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_library(name: str) -> str:
    """Compile csrc/<name>.cu into build/ unless a library built from the
    same source bytes is already there; returns its path."""
    src = source_path(name)
    sha = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as fh:
            sha.update(fh.read())
    digest = sha.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    with open(lib_path + ".ptxas.txt", "w") as fh:
        fh.write(res.stderr)
    return lib_path


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Build every named source, all nvcc processes started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build_library, names)))


# The C entries of csrc/*.cu: (library, kinds of the arguments before the
# stream), one letter an argument: p a device pointer (a tensor, or None for
# NULL), i an int, f a float. Spaces only group the letters for reading.
ENTRIES = {name: (library, kinds.replace(" ", ""))
           for name, library, kinds in (
    ("pairs_rows_forward", "pairs_composite", "pi pppp iiiii pp"),
    ("pairs_rows_combine", "pairs_composite", "ppp i ppp iiii pp"),
    ("logdot_rows_forward", "pairs_logdot", "pi pppp iiiii pp"),
    ("logdot_rows_combine", "pairs_logdot", "ppp i ppp iiii pp"),
    ("pairs_row_totals", "pairs_backward", "pi pppp i pp iiii p"),
    ("pairs_rows_suffix", "pairs_backward", "pppp iii p"),
    ("pairs_pass2", "pairs_backward", "pi pppp i pppp iiii p"),
    ("pairs_fold", "pairs_backward", "pi p ii p iiii ppp"),
    ("list_stream", "list_stream", "pp i ppp iii pp"),
    ("binning_rects", "binning", "ppppp iiiii ppp"),
    ("binning_emit", "binning", "ppppppp iiiiiiiiii ppp"),
    ("binning_ranges", "binning", "p iiiii p iiii pppppp"),
    ("preprocess_forward", "preprocess", "pppppppppp iiiiii f pppppp"),
    ("reuse_match", "reuse_match", "pppp iiii f p"),
)}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
_KINDS = {"p": "a tensor or None", "i": "an integer (not a bool) in int32's "
          "range", "f": "a float"}
_libs: Dict[str, ctypes.CDLL] = {}

# kernel launches since the last reset, one per launch: pairs_composite and
# pairs_composite_combine are K1's row and combine kernels, pairs_logdot and
# pairs_logdot_combine those of its log-space arm K5 (tools/proto_logdot.py);
# pairs_pass1, pairs_suffix, pairs_pass2 and pairs_fold are the backward
# kernels of ops/pairs_backward.py; list_stream is the layout kernel of the
# per-tile-list path (ops/tiles_composite.py), and tiles_composite counts
# that path's wrapper each time it has launched K1's two kernels over a list
# stream; binning_rects, binning_emit and binning_ranges are the pair
# binning's kernels (ops/binning.py); preprocess is the preprocess kernel
# (ops/projection.py); reuse_match is the pivot reuse's epipolar argmax
# (models/layers.py)
launch_counts = tracing.group("launch_counts", dict.fromkeys(
    ("pairs_composite", "pairs_composite_combine", "pairs_pass1",
     "pairs_suffix", "pairs_pass2", "pairs_fold", "list_stream",
     "tiles_composite", "pairs_logdot", "pairs_logdot_combine",
     "binning_rects", "binning_emit", "binning_ranges", "preprocess",
     "reuse_match"), 0))


def reset_launch_counts() -> None:
    tracing.reset("launch_counts")


def count(counter: str, times: int = 1) -> None:
    """``times`` more in ``launch_counts[counter]``: the only place it
    changes. A CUDA graph's replay adds what its capture took back out
    (``ops/render.py``), since a capture launches nothing on the device."""
    launch_counts[counter] += times


def load(library: str) -> ctypes.CDLL:
    """The library built from ``csrc/<library>.cu``, built and loaded at
    the first call, its entries' signatures set from ``ENTRIES``."""
    lib = _libs.get(library)
    if lib is None:
        lib = ctypes.CDLL(build_library(library))
        for name, (owner, kinds) in ENTRIES.items():
            if owner == library:
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPES[k] for k in kinds] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        _libs[library] = lib
    return lib


def check_tensors(owner: str, entries) -> bool:
    """Check what a wrapper hands its kernels: each entry ``(what, tensor,
    dtype, shape)`` must be a contiguous ``dtype`` tensor of ``shape`` (any
    shape where it is None) on the first tensor's device; an entry whose
    tensor is None is skipped. Raises ``ValueError`` naming ``owner`` and
    ``what``; returns True when the tensors are on the CPU (the wrapper's
    plain version runs) and False when they are on a CUDA device."""
    dev = None
    for what, t, dtype, shape in entries:
        if t is None:
            continue
        if dev is None and isinstance(t, torch.Tensor):
            dev = t.device
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or \
                not t.is_contiguous() or t.device != dev or (
                    shape is not None and tuple(t.shape) != shape):
            got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            of = "" if shape is None else f" of shape {shape}"
            raise ValueError(f"{owner}: {what} must be a contiguous {dtype} "
                             f"tensor{of} on {dev}, got {got}")
    if dev is not None and dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{owner}: tensors on {dev}; the kernels run on a "
                         "CUDA device")
    return dev is None or dev.type == "cpu"


def launch(entry: str, counter: str, device, *args) -> None:
    """Launch the C entry ``entry`` with ``args`` (in ``ENTRIES``' kinds: a
    tensor passes its data pointer, None a NULL one) on ``device``'s current
    stream, then count it in ``launch_counts[counter]``. Raises
    ``TypeError``, before the call, on an argument of another kind, and
    ``RuntimeError`` when the entry returns an error (nothing counted)."""
    library, kinds = ENTRIES[entry]
    if len(args) != len(kinds):
        raise TypeError(f"{entry} takes {len(kinds)} arguments before the "
                        f"stream, got {len(args)}")
    values = []
    append = values.append
    for kind, a in zip(kinds, args):
        if kind == "p":
            if a is None or isinstance(a, torch.Tensor):
                append(None if a is None else a.data_ptr())
                continue
        elif kind == "i":
            if type(a) is not int and isinstance(a, numbers.Integral) \
                    and not isinstance(a, bool):
                a = int(a)  # a NumPy integer
            if type(a) is int and -2 ** 31 <= a < 2 ** 31:
                append(a)
                continue
        elif type(a) is float:
            append(a)
            continue
        raise TypeError(f"{entry}: argument {len(values)} must be "
                        f"{_KINDS[kind]}, got {type(a).__name__} {a!r:.60}")
    fn = getattr(load(library), entry)
    # the guard and the stream by index, the stream as its raw handle: on
    # an H100's host (torch 2.11) torch.cuda.current_stream(device) took
    # ~6 us a call (it parses the device and builds a Stream), the raw
    # handle 0.3 us, and the guard 2.1 us by index against 4.8 by device
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    with torch.cuda.device(index):
        err = fn(*values, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    count(counter)
