"""Parallelism on torch: the device mesh that tile-parallel inference
splits its tile batch over, and the multi-process bootstrap of
``annonet_infer --coordinator`` (the counterpart of annonet_tpu/parallel;
data-parallel training is not ported yet, ROADMAP.md queue 1 item 6)."""

from annonet_tpu_torch.parallel.mesh import (
    ensure_virtual_devices,
    initialize_distributed,
    make_mesh,
)

__all__ = ["ensure_virtual_devices", "initialize_distributed", "make_mesh"]
