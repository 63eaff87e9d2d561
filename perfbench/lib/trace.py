"""The traced run's device trace: a ``torch.profiler`` Chrome trace of the
traced window, reduced to what the per-layer readers and the result's
``breakdown`` need.

The busy share is a frozen copy of ``chip_smoke.py``'s ``busy_share``: the
union of the kernels', copies' and memsets' intervals. Idle gaps are
labelled by the innermost host operation that spans the gap's middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
_LABELLED_GAPS = 400
_NAME_CHARS = 160


class Trace:
    """The device's and the host's intervals of one traced window."""

    def __init__(self, events: List[Dict], window_s: float):
        self.window_s = window_s
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.device = [(e["cat"], e.get("name", "?"), float(e["ts"]) * 1e-6,
                        float(e.get("dur", 0.0)) * 1e-6) for e in dev]
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        self._host_name = [e.get("name", "?") for e in host]
        self._host_start = np.array([float(e["ts"]) * 1e-6 for e in host])
        self._host_dur = np.array([float(e.get("dur", 0.0)) * 1e-6 for e in host])
        self._union = self._busy_intervals()

    def _busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((t, t + d) for _c, _n, t, d in self.device)
        union: List[List[float]] = []
        for a, b in spans:
            if union and a <= union[-1][1]:
                union[-1][1] = max(union[-1][1], b)
            else:
                union.append([a, b])
        return [(a, b) for a, b in union]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union)

    def count(self, cat: str) -> int:
        return sum(1 for c, *_ in self.device if c == cat)

    def device_ops(self, top: int = 10) -> List[List]:
        by_name: Dict[str, float] = defaultdict(float)
        for _c, n, _t, d in self.device:
            by_name[n[:_NAME_CHARS]] += d
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds between device work, summed by the innermost host
        operation over each gap's middle (the longest gaps; "host idle"
        where none)."""
        gaps = sorted(((b0 - a1, (a1 + b0) / 2) for (_a0, a1), (b0, _b1)
                       in zip(self._union, self._union[1:]) if b0 > a1), reverse=True)
        by_label: Dict[str, float] = defaultdict(float)
        ends = self._host_start + self._host_dur
        for length, mid in gaps[:_LABELLED_GAPS]:
            over = np.nonzero((self._host_start <= mid) & (ends >= mid))[0]
            label = ("host idle" if not len(over)
                     else self._host_name[over[np.argmin(self._host_dur[over])]])
            by_label[label[:_NAME_CHARS]] += length
        return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def traced(device, box: Dict):
    """Trace the block on ``device``; ``box["trace"]`` is the Trace after it."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    box["trace"] = Trace(events, window_s)
