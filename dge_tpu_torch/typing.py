"""Shape-annotated typing re-exports.

JAX counterpart: ``dge_tpu/typing.py`` (reference analog
threestudio/utils/typing.py). ``Float``, ``Int``, ``Bool``, ``Num`` and
``Shaped`` are jaxtyping's array annotations where ``jaxtyping`` is
installed (it annotates torch tensors as well) and ``None`` where it is not,
so a module must not subscript them at import time: write such annotations
as strings, under ``from __future__ import annotations``.
"""

from typing import (  # noqa: F401
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Literal,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Union,
)

try:
    from jaxtyping import Bool, Float, Int, Num, Shaped  # noqa: F401
except ImportError:
    Bool = Float = Int = Num = Shaped = None
