"""The benchmark imports nothing of JAX or of the JAX package, and its plain
reference nothing of the program."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _modules(code: str) -> list:
    """``sys.modules`` of a fresh interpreter after ``code`` ran."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return json.loads(out.stdout.strip().splitlines()[-1])


def _benchmark_modules() -> list:
    names = []
    for sub in ("", "drivers", "reference", "yardstick"):
        d = os.path.join(ROOT, "benchmark", sub)
        for f in sorted(os.listdir(d)):
            if f.endswith(".py") and f != "__init__.py":
                names.append(".".join(
                    p for p in ("benchmark", sub, f[:-3]) if p))
    return names


@pytest.mark.parametrize("name, expected", [
    ("dge_tpu", True), ("dge_tpu.ops.render", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("dge_tpu_torch", False), ("dge_tpu_torch.ops", False),
    ("jaxtyping", False), ("flaxen", False)])
def test_forbidden_compares_whole_top_level_names(name, expected):
    assert (guard.forbidden([name]) == [name]) is expected


def test_every_benchmark_module_and_reader_loads_no_jax():
    readers = os.path.join(ROOT, "benchmark", "metrics")
    code = ("import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n"
                      for m in _benchmark_modules())
            + "from benchmark import harness\n"
            + "".join(f"harness.load_reader({f[:-3]!r})\n"
                      for f in sorted(os.listdir(readers))
                      if f.endswith(".py")))
    loaded = _modules(code)
    assert guard.forbidden(loaded) == []


def test_the_program_loads_no_jax():
    loaded = _modules(
        "import dge_tpu_torch.systems.edit, "
        "dge_tpu_torch.ops.render, dge_tpu_torch.diffusion.ip2p")
    assert guard.forbidden(loaded) == []


def test_the_reference_loads_nothing_of_the_program():
    code = "".join(f"import {m}\n" for m in _benchmark_modules()
                   if m.startswith(("benchmark.reference",
                                    "benchmark.yardstick")))
    loaded = _modules(code)
    assert guard.forbidden(loaded, guard.REFERENCE_FORBIDDEN) == []


def test_run_refuses_with_jax_loaded(tmp_path):
    """The command line exits with an error and prints no result when a
    forbidden module is loaded."""
    stub = tmp_path / "jax"
    stub.mkdir()
    (stub / "__init__.py").write_text("")
    code = ("import sys; sys.argv = ['run.py', '--workload', "
            "'render.blender1080', '--seed', '1', '--seconds', '1'];"
            "import jax; import runpy;"
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=f"{tmp_path}:{ROOT}"))
    assert res.returncode != 0
    assert "jax" in res.stderr and res.stdout.strip() == ""
