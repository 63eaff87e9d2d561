"""Parallelism on torch: the device mesh that tile-parallel inference
splits its tile batch over and data-parallel training its minibatch
(``parallel/train.py``), and the multi-process bootstrap of
``--coordinator`` (the counterpart of annonet_tpu/parallel)."""

from annonet_tpu_torch.parallel.mesh import (
    ensure_virtual_devices,
    initialize_distributed,
    make_mesh,
)

__all__ = ["ensure_virtual_devices", "initialize_distributed", "make_mesh"]
