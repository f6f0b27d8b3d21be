"""The import guard: the benchmark measures the PyTorch/CUDA port alone.

A module counts as forbidden when its top-level name (the part before the
first dot) is, as a whole name, one of ``FORBIDDEN``: ``dge_tpu_torch`` is
not ``dge_tpu``. The plain reference must also stay clear of the program:
``REFERENCE_FORBIDDEN`` adds the port's own package.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "dge_tpu")
REFERENCE_FORBIDDEN = FORBIDDEN + ("dge_tpu_torch",)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str], banned=FORBIDDEN) -> List[str]:
    """The names among ``names`` whose top-level name is banned."""
    bad = set(banned)
    return sorted(n for n in names if top_level(n) in bad)


def loaded_forbidden(banned=FORBIDDEN) -> List[str]:
    """Forbidden modules in this process's ``sys.modules``."""
    return forbidden(list(sys.modules), banned)


def check(where: str) -> None:
    """Exit with code 3, naming what was found on standard error, if a
    forbidden module is loaded."""
    bad = loaded_forbidden()
    if bad:
        print(f"[bench] forbidden modules loaded {where}: {', '.join(bad)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
