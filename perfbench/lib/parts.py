"""The set-up's parts, timed by the host's clock for standard error."""

from __future__ import annotations

import time
from typing import Dict


def mark(parts: Dict[str, float], name: str, t: float) -> float:
    """Record the seconds since ``t`` under ``name``; return the time now."""
    now = time.perf_counter()
    parts[name] = now - t
    return now
