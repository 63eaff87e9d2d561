"""``--profile``: a torch.profiler trace around a block of work.

The counterpart of ``annonet_tpu/utils/profiling.py``, which wraps
``jax.profiler.trace``. Here it is ``torch.profiler.profile`` with CPU
activity, plus CUDA activity (CUPTI: every kernel and copy on the card,
the hand-written kernels launched through ctypes included) when the work
runs on a CUDA device, written as one Chrome trace file (open it in
chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

#: the trace file's name inside the trace directory
TRACE_FILE = "annonet_infer.pt.trace.json"


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
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, file_name))
