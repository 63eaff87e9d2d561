"""The program's own spans in the traced run (``annonet_tpu_torch``'s
``utils/profiling.py``), for the per-layer readers.

Two readings of a span, each a step's worth over the window's steps:

  * ``device_ms``: the recorder's device seconds of timed spans, from the
    CUDA events the program records at each span's two boundaries on its
    stream (``span_stats()``). The recorder is on only while a profiler
    session records, so in the traced run its totals should cover the
    traced window alone; that is checked, not assumed: every span read,
    and ``train_step``, must have been left, and timed on the device, once
    for each of the window's steps.
  * ``idle_ms``: the device's idle time while the host was inside a span,
    from the device trace: the gaps between the traced window's busy
    intervals (``Trace``'s union of kernels, copies and memsets) that
    overlap the span's ``record_function`` intervals, which must number
    one for each of the window's steps.

Both return None, never a guess, when the counts disagree or the program
has no such spans (a program without ``span_stats``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

STEP_SPAN = "train_step"


def _stats() -> Optional[Dict[str, Dict]]:
    try:
        from annonet_tpu_torch.utils.profiling import span_stats
    except ImportError:
        return None
    return span_stats()


def device_ms(run, names: Iterable[str]) -> Optional[float]:
    """Device ms a step in the timed spans ``names`` together."""
    calls = run.window["calls"]
    stats = _stats()
    if not calls or stats is None:
        return None
    names = tuple(names)
    for name in (STEP_SPAN,) + names:
        entry = stats.get(name)
        if entry is None or entry["count"] != calls or entry.get("device_count") != calls:
            return None
    return 1e3 * sum(stats[name]["device_s"] for name in names) / calls


def _idle_before(t: np.ndarray, g0: np.ndarray, g1: np.ndarray,
                 cum: np.ndarray) -> np.ndarray:
    """Idle seconds before each time in ``t``: the gaps [g0, g1) (sorted,
    disjoint; ``cum`` their cumulative lengths, starting at 0)."""
    i = np.searchsorted(g0, t, side="right")  # gaps that start at or before t
    j = np.maximum(i - 1, 0)
    part = np.where(i > 0, np.minimum(t, g1[j]) - g0[j], 0.0)
    return cum[j] + part


def idle_ms(run, name: str) -> Optional[float]:
    """Device idle ms a step while the host was inside span ``name``."""
    t, calls = run.trace, run.window["calls"]
    if t is None or not calls or not t.device:
        return None
    mine = np.array([n == name for n in t._host_name], dtype=bool)
    if int(mine.sum()) != calls:
        return None
    starts = t._host_start[mine]
    ends = starts + t._host_dur[mine]
    busy = t._union
    g0 = np.array([b for _a, b in busy[:-1]], dtype=float)
    g1 = np.array([a for a, _b in busy[1:]], dtype=float)
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    if not len(g0):
        return 0.0
    cum = np.concatenate([[0.0], np.cumsum(g1 - g0)])
    idle = _idle_before(ends, g0, g1, cum) - _idle_before(starts, g0, g1, cum)
    return 1e3 * float(idle.sum()) / calls
