"""Step-schedulable scalars and image mask morphology.

JAX counterpart: ``dge_tpu/utils/misc.py``. Reference analog:
threestudio/utils/misc.py (C() schedules :87-108, mask dilate/erode
:15-32). The mask helpers work on numpy masks on the host (scipy).
"""

from __future__ import annotations

from typing import List, Union

import numpy as np


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


_SQUARE = np.ones((3, 3), bool)


def dilate_mask(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """Binary dilation with a full 3x3 structuring element (cv2 semantics,
    the reference's dilate_mask); the result keeps the mask's dtype."""
    from scipy import ndimage

    return ndimage.binary_dilation(mask > 0.5, structure=_SQUARE,
                                   iterations=iterations).astype(mask.dtype)


def erode_mask(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """Binary erosion with a full 3x3 structuring element."""
    from scipy import ndimage

    return ndimage.binary_erosion(mask > 0.5, structure=_SQUARE,
                                  iterations=iterations).astype(mask.dtype)


def fill_closed_areas(mask: np.ndarray) -> np.ndarray:
    """Fill the holes of a binary mask (misc.py fill semantics)."""
    from scipy import ndimage

    return ndimage.binary_fill_holes(mask > 0.5).astype(mask.dtype)
