"""The check that nothing of JAX or of the JAX package is loaded.

Names compare by their top-level part (before the first dot), whole:
mozjpeg_tpu_torch is not mozjpeg_tpu.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "mozjpeg_tpu")


def forbidden(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among module names, sorted."""
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))


def forbidden_loaded() -> List[str]:
    return forbidden(list(sys.modules))
