"""Process-level politeness.

The reference lowers its own priority so long runs don't starve the
workstation (set_low_priority, annonet.cpp:178-187 — implemented there for
Windows only, called from both mains). Here the POSIX side is covered too.
The port's own copy of ``annonet_tpu/utils/system.py``.
"""

from __future__ import annotations

import os
import sys


def set_low_priority() -> None:
    """Drop process priority; silently a no-op where unsupported."""
    try:
        if hasattr(os, "nice"):
            os.nice(10)
        elif sys.platform == "win32":  # pragma: no cover
            import ctypes

            BELOW_NORMAL_PRIORITY_CLASS = 0x4000
            handle = ctypes.windll.kernel32.GetCurrentProcess()
            ctypes.windll.kernel32.SetPriorityClass(
                handle, BELOW_NORMAL_PRIORITY_CLASS
            )
    except OSError:  # pragma: no cover
        pass
