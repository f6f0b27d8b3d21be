"""Step-schedulable scalars.

JAX counterpart: ``dge_tpu/utils/misc.py`` (``C``; its mask morphology has
no caller on the ported paths). Reference analog: threestudio/utils/misc.py
(C() schedules :87-108).
"""

from __future__ import annotations

from typing import List, Union


def C(value: Union[float, int, List], step: int) -> float:
    """Step-schedulable scalar: numbers pass through; a list
    [start_step, start_value, end_value, end_step] linearly interpolates
    (misc.py:87-108 semantics)."""
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, (list, tuple)):
        if len(value) != 4:
            raise ValueError(f"schedule spec must have 4 entries, got {value}")
        start_step, start_value, end_value, end_step = value
        if isinstance(end_step, int):
            t = max(min((step - start_step) / max(end_step - start_step, 1),
                        1.0), 0.0)
            return float(start_value + (end_value - start_value) * t)
        raise ValueError(f"bad schedule spec {value}")
    raise TypeError(f"cannot schedule {type(value)}")
