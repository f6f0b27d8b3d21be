"""The data-driven core of the benchmark: one cell, one run.

Everything that belongs to one cell is found by name:

- ``BENCHMARK.json`` (the repository root): the cell's configuration and
  traffic names, and its end-to-end and per-layer metrics;
- ``benchmark/configs/<config>.json``: the configuration (the ``file`` that
  ``BENCHMARK.json`` names for it);
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters, whose
  ``driver`` names the general generator in ``benchmark/drivers/`` that
  reads them;
- ``benchmark/limits/<cell>.json``: the limit of each number that the
  comparison with the plain reference checks;
- ``benchmark/metrics/<metric>.py``: one reader a per-layer metric.

A run: set-up (timed as ``setup_s``), the measured window, with ``--trace
1`` a profiled window and the readers' device timings, the peak memory, the
import guard, the program's state released, then the comparison with the
plain reference. ``run_cell`` does all of it for a device it is given; the
command line (``run.py``) first checks for the cards.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import guard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    # the checkout the cell's files were found in
    root: str = ROOT

    def rng_seed(self, *stream: int) -> List[int]:
        """A numpy seed sequence entropy for one stream of this run."""
        return [self.seed % (1 << 63)] + [int(s) for s in stream]

    def torch_seed(self, *stream: int) -> int:
        import numpy as np

        return int(np.random.SeedSequence(self.rng_seed(*stream))
                   .generate_state(1, dtype=np.uint64)[0] >> 1)


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, seed: int, seconds: float, trace: bool,
              device, root: str = ROOT, overrides: Optional[dict] = None
              ) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"[bench] unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    bench = os.path.join(root, "benchmark")
    traffic = load_json(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(bench, "limits", workload + ".json"))
    # a test's smaller sizes: configuration and traffic keys replaced
    config.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    return Cell(
        name=workload, config=config, traffic=traffic, limits=limits,
        seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=torch.device(device), chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"]
                    if metric_applies(m, workload)],
        per_layer=[m for m in spec["per_layer"]
                   if metric_applies(m, workload)],
        root=root)


def load_reader(name: str, root: str = ROOT):
    """The reader module of per-layer metric ``name``
    (``benchmark/metrics/<name>.py``)."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(cell: Cell):
    mod = importlib.import_module("benchmark.drivers." + cell.traffic["driver"])
    return mod.Driver(cell)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class Context:
    """What a per-layer reader sees: the cell, the driver (its program
    objects while ``measure`` runs, its reference and counts while ``read``
    runs), the profiled window's trace and the raw numbers ``measure``
    returned."""

    def __init__(self, cell: Cell, driver, trace):
        self.cell = cell
        self.driver = driver
        self.trace = trace
        self.raw: Dict[str, object] = {}


def run_cell(cell: Cell, t_start: Optional[float] = None,
             log: Callable[[str], None] = lambda m: None) -> dict:
    """One run of ``cell`` → the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = cell.device
    driver = load_driver(cell)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    window = driver.window(cell.seconds)
    log(f"window: {window}")
    for name in ("step_ms", "frame_ms"):
        ms = getattr(driver, name, None)
        if ms is not None and len(ms) > 4:
            q = [float(x) for x in np.percentile(ms, [5, 25, 50, 75, 95])]
            log(f"{name} p5/25/50/75/95: {q}")
    metrics: Dict[str, dict] = {}
    trace = None
    readers = {}
    ctx = None
    if cell.trace:
        trace = driver.trace_window()
        ctx = Context(cell, driver, trace)
        for m in cell.per_layer:
            readers[m["name"]] = load_reader(m["name"], cell.root)
            measure = getattr(readers[m["name"]], "measure", None)
            if measure is not None and dev.type == "cuda":
                ctx.raw[m["name"]] = measure(ctx)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    guard.check("after the window")
    driver.release()
    checks = driver.check()
    if cell.trace:
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] and math.isfinite(c["value"])
                  for c in checks.values())
    out = {
        "correct": bool(correct and window["failed"] == 0),
        "attempted": int(window["attempted"]),
        "failed": int(window["failed"]),
        "metrics": metrics,
        "device": _device(cell, peak, trace),
    }
    if trace is not None:
        out["breakdown"] = trace.breakdown()
    out["checks"] = checks
    return out


def _device(cell: Cell, peak: int, trace) -> dict:
    if cell.device.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": cell.chips}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1}
    d["memory_peak_bytes"] = int(peak)
    if trace is not None:
        d["busy_s"] = trace.busy_s
        d["window_s"] = trace.window_s
    return d


def check_line(checks: Dict[str, dict]) -> List[str]:
    """The lines that name each compared number beside its limit."""
    return [f"[bench] check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


def set_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache the program may use, at fixed paths
    inside the checkout (``build/`` is where the port's nvcc libraries go
    already)."""
    base = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        path = os.path.join(base, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    # a library that would load JAX by itself must not
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def print_result(out: dict) -> None:
    for line in check_line(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
