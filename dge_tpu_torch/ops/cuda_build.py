"""Build the hand-written CUDA sources of ``dge_tpu_torch/csrc`` with nvcc.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library ``build/lib<name>_<hash>.so`` at the repository root, keyed by a hash
of the source bytes and of the headers (``csrc/*.cuh``) it may include, with
ptxas's register and spill report beside it
(``*.ptxas.txt``). Wrappers load their library with ctypes at first use;
``build_all`` compiles several sources at once, one nvcc process each.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("pairs_composite", "pairs_backward", "pairs_logdot",
           "list_stream", "binning", "preprocess")


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
