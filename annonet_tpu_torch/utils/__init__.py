"""Process and profiling helpers of the CLIs (the JAX package's
``annonet_tpu/utils/system.py`` and ``profiling.py``, in their torch
forms)."""

from annonet_tpu_torch.utils.profiling import TRACE_FILE, profiler_trace
from annonet_tpu_torch.utils.system import set_low_priority

__all__ = ["TRACE_FILE", "profiler_trace", "set_low_priority"]
