"""``--profile``: a torch.profiler trace around a block of work; ``span``:
the named ranges of the training step, and the recorder that times them.

``profiler_trace`` is the counterpart of ``annonet_tpu/utils/profiling.py``,
which wraps ``jax.profiler.trace``. Here it is ``torch.profiler.profile``
with CPU activity, plus CUDA activity (CUPTI: every kernel and copy on the
card, the hand-written kernels launched through ctypes included) when the
work runs on a CUDA device, written as one Chrome trace file (open it in
chrome://tracing or Perfetto).

``span(name)`` is the one way the port names a range of its work:

* while no profiler session records and the recorder is off, it costs one
  check of the profiler's flag and opens nothing;
* while a ``torch.profiler`` session records, it opens a
  ``record_function`` range of that name, on the trace's clock;
* a ``timed`` span, while the recorder is on, also takes the host's
  ``perf_counter_ns`` and, on a CUDA device, a CUDA event on the device's
  current stream at each of its two boundaries. The recorder keeps, per
  name, the count, the host seconds and the device seconds.

The recorder is on while a profiler session records, and always when
``ANNONET_TPU_STEP_TIMING=1`` (read when this module is imported and by
``reset_span_stats``). It never synchronizes: a pair of events is resolved
into device seconds once its end event has completed, checked in the order
the pairs ended whenever an outermost timed span closes and by
``span_stats``. Timed spans are opened by one thread (the training loop's);
untimed ones by any.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

#: the trace file's name inside the trace directory
TRACE_FILE = "annonet_infer.pt.trace.json"
#: "1" turns the recorder on without a profiler
STEP_TIMING_ENV = "ANNONET_TPU_STEP_TIMING"


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str], device=None,
                   file_name: str = TRACE_FILE) -> Iterator[None]:
    """Trace the block into ``trace_dir/file_name`` (a no-op when
    ``trace_dir`` is None or empty); CUDA activity is recorded when
    ``device`` is a CUDA device. The file is written when the block ends
    without an exception."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, file_name))


class _Pair:
    """One timed span: its host start, its device and events (None on the
    CPU), its enclosing timed span, and its inner spans' device seconds."""

    __slots__ = ("name", "t0", "device", "start", "end", "parent", "inner")

    def __init__(self, name, device, start, parent):
        self.name, self.t0, self.device = name, 0, device
        self.start, self.end, self.parent, self.inner = start, None, parent, {}


class _Recorder:
    """The timed spans' totals by name: [count, host ns, device seconds,
    device count, newest], where newest is the latest span of the name
    whose device time is known: {"index": its place among them,
    "device_s", "inner": its inner timed spans' device seconds by name}."""

    def __init__(self):
        self.by_env = os.environ.get(STEP_TIMING_ENV) == "1"
        self.totals: Dict[str, list] = {}
        self.open: list = []  # the timed spans entered and not yet left
        self.pending: collections.deque = collections.deque()  # pairs, by end
        self.free: Dict[torch.device, list] = {}  # resolved pairs' events, for reuse

    def _event(self, device) -> torch.cuda.Event:
        free = self.free.get(device)
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def enter(self, name: str, device) -> _Pair:
        cuda = device is not None and device.type == "cuda"
        pair = _Pair(name, device, self._event(device) if cuda else None,
                     self.open[-1] if self.open else None)
        self.open.append(pair)
        pair.t0 = time.perf_counter_ns()
        return pair

    def leave(self, pair: _Pair) -> None:
        host_ns = time.perf_counter_ns() - pair.t0
        if pair.start is not None:
            pair.end = self._event(pair.device)
            self.pending.append(pair)
        self.open.pop()
        entry = self.totals.setdefault(pair.name, [0, 0, 0.0, 0, None])
        entry[0] += 1
        entry[1] += host_ns
        if not self.open:
            self.resolve()

    def resolve(self) -> None:
        """Device seconds of the pairs whose end has completed, oldest
        first; stops at the first that has not (the stream runs them in
        order)."""
        while self.pending and self.pending[0].end.query():
            pair = self.pending.popleft()
            seconds = pair.start.elapsed_time(pair.end) * 1e-3
            self.free.setdefault(pair.device, []).extend((pair.start, pair.end))
            entry = self.totals[pair.name]
            entry[2] += seconds
            entry[4] = {"index": entry[3], "device_s": seconds, "inner": pair.inner}
            entry[3] += 1
            if pair.parent is not None:
                inner = pair.parent.inner
                inner[pair.name] = inner.get(pair.name, 0.0) + seconds

    def stats(self) -> Dict[str, Dict]:
        self.resolve()
        return {name: {"count": e[0], "host_s": e[1] * 1e-9, "device_s": e[2],
                       "device_count": e[3], "newest": e[4]}
                for name, e in self.totals.items()}

    def reset(self) -> None:
        self.by_env = os.environ.get(STEP_TIMING_ENV) == "1"
        self.totals.clear()
        self.pending.clear()
        self.free.clear()


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "range", "timed", "device", "pair")

    def __init__(self, name, recording, timed, device):
        self.name = name
        self.range = record_function(name) if recording else None
        self.timed, self.device, self.pair = timed, device, None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.timed:
            self.pair = _RECORDER.enter(self.name, self.device)
        return self

    def __exit__(self, *exc):
        if self.pair is not None:
            _RECORDER.leave(self.pair)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str, timed: bool = False, device=None):
    """A named range of work (a context manager): a ``record_function``
    range while a profiler session records; if ``timed``, also host and
    device time in the recorder while it is on (device time when
    ``device`` is a CUDA device, on its current stream)."""
    recording = _autograd_profiler._is_profiler_enabled
    if not recording and not (timed and _RECORDER.by_env):
        return _NO_SPAN
    return _Span(name, recording, timed, device)


def span_stats() -> Dict[str, Dict]:
    """The timed spans since the last reset, by name: ``count`` (spans
    left), ``host_s``, ``device_s`` over the ``device_count`` of them whose
    device time is known, and ``newest``, the latest of those ({"index",
    "device_s", "inner": the device seconds of the timed spans inside it,
    by name}; None while there is none)."""
    return _RECORDER.stats()


def reset_span_stats() -> None:
    """Forget every timed span (and read ``ANNONET_TPU_STEP_TIMING`` anew)."""
    _RECORDER.reset()
