"""The check that nothing of JAX, nor the JAX package, was loaded.

Module names compare by their top-level part (before the first dot), whole:
``annonet_tpu_torch`` begins with ``annonet_tpu`` and is allowed."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "annonet_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
