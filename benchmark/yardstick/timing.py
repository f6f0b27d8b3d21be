"""Device timing and the card's description.

``cuda_ms`` is the CUDA-event timer of ``chip_smoke.py`` (median of
``reps`` calls after ``warmup``), ``stage_ms`` the stage timing of
``dge_tpu_torch/tools/profile_edit.py`` (one warm-up call, then the median
of ``iters`` calls, each between two events), both copied so that the
yardstick stays fixed while the program changes.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable

import torch


def cuda_ms(fn: Callable, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms over ``reps`` calls (CUDA events,
    after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stage_ms(fn: Callable, iters: int = 3) -> float:
    """profile_edit's stage time: one warm-up call, then the median of
    ``iters`` calls, each timed by CUDA events."""
    return cuda_ms(fn, reps=iters, warmup=1)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or a note
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"
