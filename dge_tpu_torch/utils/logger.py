"""Metrics logging: JSONL scalars + optional TensorBoard.

JAX counterpart: ``dge_tpu/utils/logger.py``. A JSONL file per trial is the
dependency-free record; TensorBoard (when the package is importable) writes
event files next to it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, trial_dir: str, name: str = "metrics",
                 tensorboard: bool = False):
        os.makedirs(trial_dir, exist_ok=True)
        self.path = os.path.join(trial_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(trial_dir, "tb"))
            except Exception:  # tensorboard not importable: JSONL only
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {
            "step": int(step),
            "wall": round(time.time() - self._t0, 3),
            **{k: float(v) for k, v in scalars.items()},
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
