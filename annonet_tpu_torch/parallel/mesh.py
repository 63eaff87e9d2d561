"""Device meshes and the multi-process bootstrap (the counterpart of
``annonet_tpu/parallel/mesh.py``).

A mesh here is the ordered tuple of ``torch.device``s that
``TiledInferer(mesh=...)`` splits its tile batch over, in tile order:
``cuda:0 .. cuda:n-1``. JAX's virtual CPU devices become *virtual
shards*: ``ensure_virtual_devices(n)`` gives ``n`` shards on one device,
so the split, the per-shard forwards and the gather run where there is
only one device (the CPU in the tests, one card). ``make_cli_mesh``
(cli/common.py) takes that path only under ANNONET_TPU_VIRTUAL_MESH=1;
without it ``--mesh N`` beyond the visible devices fails.

Multi-process inference (``--coordinator``) exchanges only small host
arrays (the final confusion matrices, timings and calibration maxima),
so its process group is gloo's, over TCP, on any machine. Multi-process
training (``annonet_train --coordinator``, parallel/train.py) gathers
its BN moments, int8 scales and gradients over the same gloo group,
through host copies; each process's ``process_mesh`` is its local part
of the global mesh.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

VIRTUAL_MESH_ENV = "ANNONET_TPU_VIRTUAL_MESH"


def _visible_devices(device: Optional[torch.device] = None) -> Tuple[torch.device, ...]:
    """Every CUDA device, or the CPU alone when the port runs on the CPU
    (``resolve_device``'s choice: ANNONET_TPU_TORCH_DEVICE=cpu)."""
    from annonet_tpu_torch.cli.common import resolve_device

    device = resolve_device() if device is None else torch.device(device)
    if device.type == "cpu":
        return (device,)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def make_mesh(n_devices: Optional[int] = None) -> Tuple[torch.device, ...]:
    """The first ``n_devices`` visible devices (all of them by default),
    in order: the shards of a tile batch go to them in tile order. More
    devices than exist raise ValueError, as JAX's ``make_mesh`` does."""
    devices = _visible_devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available"
        )
    return devices[:n_devices]


def ensure_virtual_devices(n_devices: int, device=None) -> Tuple[torch.device, ...]:
    """A mesh of ``n_devices`` virtual shards on one device (``device``,
    default the one ``resolve_device`` picks): the tile batch is split,
    forwarded shard by shard and gathered exactly as on ``n_devices``
    cards. The counterpart of JAX's virtual CPU devices, for testing the
    sharded path on a machine with one device."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if device is None:
        from annonet_tpu_torch.cli.common import resolve_device

        device = resolve_device()
    return (torch.device(device),) * n_devices


def local_virtual_devices(n_devices: int, num_processes: int) -> int:
    """A process's virtual shards of an ``n_devices`` mesh over
    ``num_processes`` processes (JAX's ``local_virtual_devices``,
    cli/train.py:413-424): max(1, n_devices // num_processes)."""
    return max(1, n_devices // num_processes)


def process_mesh(n_devices: int, device=None) -> Tuple[torch.device, ...]:
    """This process's local part of a global ``n_devices`` mesh (the
    process group must be initialised): under ANNONET_TPU_VIRTUAL_MESH=1,
    ``local_virtual_devices`` virtual shards of ``device``; otherwise its
    visible devices (``device`` alone where it is the only one; processes
    that share a host should each see their own cards through
    CUDA_VISIBLE_DEVICES). Raises ValueError
    unless ``n_devices`` equals the global device count (every process's
    local devices), as the JAX CLI's multi-process mesh does."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if os.environ.get(VIRTUAL_MESH_ENV) == "1":
        local = local_virtual_devices(n_devices, world)
        devices = ensure_virtual_devices(local, device)
    else:
        devices = _visible_devices(device)
        local = len(devices)
        if local == 1 and device is not None:
            devices = (torch.device(device),)
    if n_devices != world * local:
        raise ValueError(
            f"--mesh {n_devices} must equal the global device count "
            f"({world * local}: {world} processes x {local} local devices) when "
            "training multi-process (--coordinator): every device of every "
            "process joins the mesh"
        )
    return devices


def _timeout_env(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer number of seconds") from None
    if value <= 0:
        raise ValueError(f"{name}={raw!r} must be a positive integer")
    return value


def initialize_distributed(
    coordinator: str,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Multi-process bootstrap for ``annonet_infer --coordinator``: a gloo
    process group over TCP. ``coordinator`` is process 0's ``host:port``
    (every process passes the same address, with --num-processes and
    --process-id), or ``"auto"``: the rendezvous variables ``torchrun``
    sets (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).

    ANNONET_TPU_HEARTBEAT_TIMEOUT (seconds, default 100, as in the JAX
    package) is the group's timeout: the rendezvous, and every collective
    that waits on a silent peer, fail after it. A peer that dies fails
    the survivor's next collective at once ("Connection closed by peer";
    cli/common.py's ``exit_on_peer_failure``). Returns (rank, world size);
    the caller destroys the group (``torch.distributed.destroy_process_group``).
    """
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=_timeout_env("ANNONET_TPU_HEARTBEAT_TIMEOUT", 100))
    if coordinator == "auto":
        dist.init_process_group("gloo", init_method="env://", timeout=timeout)
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "--coordinator host:port requires --num-processes and "
                "--process-id (or use --coordinator auto under torchrun, "
                "which sets the rendezvous variables)"
            )
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id, timeout=timeout,
        )
    return dist.get_rank(), dist.get_world_size()
