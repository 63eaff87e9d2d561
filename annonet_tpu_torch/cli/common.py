"""Shared CLI helpers: the reference-parity parser, class-specific value
parsing, the in-order buffer of the reader threads (copies of
annonet_tpu/cli/_parser.py and cli/common.py, whose package imports pull
in JAX), device selection, the bounded device probe, ``--mesh`` and the
multi-process peer-failure exit."""

from __future__ import annotations

import argparse
import os
import sys
import threading
from typing import List, Sequence

#: ``cpu`` runs the port on the CPU (the counterpart of the JAX package's
#: ANNONET_TPU_PLATFORM=cpu); unset, the CLIs require a CUDA device.
DEVICE_ENV = "ANNONET_TPU_TORCH_DEVICE"


class ReferenceParser(argparse.ArgumentParser):
    """cxxopts-style parse errors: the message, a blank line and the full
    help text on stderr, exit 2 (annonet_infer_main.cpp:335-340)."""

    def error(self, message: str):  # noqa: D102 — argparse override
        print(message, file=sys.stderr)
        print(file=sys.stderr)
        self.print_help(sys.stderr)
        raise SystemExit(2)


def parse_class_specific_value(string_from_command_line: str):
    """Parse one "index:value" item (annonet_infer_main.cpp:36-46)."""
    colon_pos = string_from_command_line.find(":")
    if colon_pos < 1 or colon_pos >= len(string_from_command_line) - 1:
        raise ValueError(
            "The gains must be supplied in the format index:gain (e.g., 1:-0.5)"
        )
    return (
        int(string_from_command_line[:colon_pos]),
        float(string_from_command_line[colon_pos + 1 :]),
    )


def parse_class_specific_values(
    strings_from_command_line: Sequence[str],
    class_count: int,
    require_non_negative: bool = False,
) -> List[float]:
    """Expand repeated "index:value" flags into a dense per-class vector
    (annonet_infer_main.cpp:49-63); detection levels must be >= 0."""
    values = [0.0] * class_count
    for item in strings_from_command_line:
        index, value = parse_class_specific_value(item)
        if index >= class_count:
            raise ValueError(
                f"Can't define class-specific value for index {index} "
                f"when there are only {class_count} classes"
            )
        if require_non_negative and value < 0.0:
            raise ValueError(
                f"Class-specific value for index {index} must be "
                f"non-negative (got {value:g})"
            )
        values[index] = value
    return values


class IndexOrderedResults:
    """Reorder (index, item) pairs from a queue into 0,1,2,... order.

    Reader threads complete out of order; inference must still process
    images in find_image_files order (the reference's sequential loop,
    annonet_infer_main.cpp:440-494) so result ordering and the
    "excluding the first image" timing are deterministic. The buffer is
    bounded only if the PRODUCERS bound their read-ahead (cli/infer.py's
    read_ahead semaphore): without that, one slow in-order item would let
    the other readers race ahead and this buffer would absorb them all.
    """

    def __init__(self, results_queue):
        self._queue = results_queue
        self._pending = {}
        self._next = 0

    def next(self):
        while self._next not in self._pending:
            index, item = self._queue.get()
            self._pending[index] = item
        item = self._pending.pop(self._next)
        self._next += 1
        return item


def resolve_device(device_index=None):
    """The torch device a CLI runs on: ``cuda:<device_index or 0>``, or
    the CPU when ANNONET_TPU_TORCH_DEVICE=cpu asks for it. Without a CUDA
    device and without that request, raises: the port never falls back to
    the CPU on its own."""
    import torch

    requested = os.environ.get(DEVICE_ENV, "")
    if requested == "cpu":
        return torch.device("cpu")
    if requested not in ("", "cuda"):
        raise ValueError(f"{DEVICE_ENV}={requested!r}: expected 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: annonet_tpu_torch runs on an "
            f"NVIDIA GPU (set {DEVICE_ENV}=cpu to run on the CPU instead)"
        )
    index = 0 if device_index is None else int(device_index)
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise ValueError(
            f"device index {index} out of range; {count} CUDA device(s) available"
        )
    return torch.device("cuda", index)


def device_probe(device, timeout_s=None, on_timeout=None, _op=None) -> None:
    """Bounded first device operation: fail fast, with a message to act
    on, when the device's runtime is unreachable or wedged, instead of
    hanging in the first request or image (annonet_tpu/cli/common.py's
    device_probe on one process).

    One tiny operation and its copy back to the host run on a daemon
    thread, bounded by ``timeout_s`` (default ANNONET_TPU_DEVICE_PROBE_TIMEOUT
    or 120 s; 0 disables the probe). ``on_timeout="exit"`` (the default,
    or ANNONET_TPU_DEVICE_PROBE_ON_TIMEOUT) prints the message and leaves
    with ``os._exit(1)``: the abandoned thread is stuck in the CUDA runtime,
    and finalising the interpreter under it is not safe. ``"raise"``
    raises RuntimeError instead. An error of the operation itself raises
    RuntimeError. ``_op`` is a test seam."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("ANNONET_TPU_DEVICE_PROBE_TIMEOUT", "120"))
    if on_timeout is None:
        on_timeout = os.environ.get("ANNONET_TPU_DEVICE_PROBE_ON_TIMEOUT", "exit")
    if timeout_s <= 0:
        return
    if _op is None:
        import torch  # imported here, on this thread: imports do not hang

        def _op():
            value = float(torch.full((8, 8), 3.0, device=device).sum().cpu())
            if value != 192.0:
                raise RuntimeError(f"device computed {value}, expected 192.0")

    result = {}

    def run():
        try:
            _op()
            result["ok"] = True
        except Exception as e:  # noqa: BLE001 — raised on the calling thread
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True, name="annonet-device-probe")
    thread.start()
    thread.join(timeout_s)
    if thread.is_alive():
        message = (
            f"device probe did not complete within {timeout_s:g} s: the "
            "accelerator runtime is unreachable or wedged (context creation "
            "or the first host<->device transfer stalled). Triage: check "
            "that the card and its runtime are healthy (nvidia-smi), look for "
            "leftover processes holding the device, or retry once it "
            "recovers. ANNONET_TPU_DEVICE_PROBE_TIMEOUT adjusts this "
            "timeout (0 disables the probe)."
        )
        if on_timeout == "raise":
            raise RuntimeError(message)
        print(message, flush=True)
        sys.stderr.flush()
        os._exit(1)
    if "error" in result:
        raise RuntimeError(f"device probe failed: {result['error']}") from result["error"]


def make_cli_mesh(n_devices: int, device=None, multiprocess: bool = False):
    """--mesh N -> the mesh ``TiledInferer(mesh=...)`` splits its tiles
    over and ``DataParallelTrainer`` its minibatch: the first N CUDA
    devices (parallel/mesh.py's ``make_mesh``). Behind
    ANNONET_TPU_VIRTUAL_MESH=1, N virtual shards on ``device`` (the one
    ``resolve_device`` picks), for testing the sharded path on one device;
    an explicit opt-in, so a production --mesh run never lands on fewer
    devices than it asked for. Runs after ``device_probe``, as in the JAX
    CLIs; torch needs no flag set before its first device use, so the JAX
    package's ``prepare_mesh_flags`` has no counterpart.

    ``multiprocess``: the caller already ran ``initialize_distributed``
    (--coordinator); N must then equal the GLOBAL device count (every
    process's local devices), and the mesh returned is this process's
    local part of it (``parallel/mesh.py process_mesh``)."""
    from annonet_tpu_torch.parallel.mesh import (
        VIRTUAL_MESH_ENV,
        ensure_virtual_devices,
        make_mesh,
        process_mesh,
    )

    if multiprocess:
        return process_mesh(n_devices, device)
    if os.environ.get(VIRTUAL_MESH_ENV) == "1":
        return ensure_virtual_devices(n_devices, device)
    return make_mesh(n_devices)


# Substrings that identify a failed PEER (a rank that died, stalled, or
# became unreachable) in the errors torch's gloo process group raises into
# this process. Measured with torch 2.13 on the CPU, two ranks over
# tcp://127.0.0.1: killing a rank (SIGKILL), before or during the
# survivor's all_gather or broadcast, raises "[.../gloo/transport/tcp/
# pair.cc:553] Connection closed by peer [127.0.0.1]:<port>. This is
# typically caused by a remote worker crashing." at once; stopping it
# (SIGSTOP) raises "[.../unbound_buffer.cc:129] Timed out waiting 5000ms
# for send operation to complete" (":78" ... "for recv operation to
# complete") after the group's timeout (ANNONET_TPU_HEARTBEAT_TIMEOUT), and
# the next collective "Application timeout caused pair closure". In
# training, where the survivor is inside a collective or about to read one
# when the peer dies, gloo raises "[.../pair.cc:537] Read error
# [127.0.0.1]:<port>: Connection reset by peer" (measured the same way,
# annonet_train --coordinator, a rank SIGKILLed mid-training).
#
# As in the JAX package, no generic transport string is a marker ("reset
# by peer", "connection refused", a bare "timed out"): a rank-LOCAL error
# that merely contains one (a network-filesystem read, a misconfigured
# coordinator address timing out at the rendezvous: "The client socket has
# timed out after 4000ms while trying to connect", measured) must take the
# rank-local path, not be reported as a dead peer.
_PEER_FAILURE_MARKERS = (
    "connection closed by peer",            # pair.cc: the peer's process died
    "] read error [",                       # pair.cc: its connection reset mid-read
    "for send operation to complete",       # unbound_buffer.cc: the peer is silent
    "for recv operation to complete",
    "application timeout caused pair closure",
)


def peer_failure_diagnosis(exc) -> "str | None":
    """Classify an exception as a multi-process PEER failure; returns the
    diagnosis line to act on, or None for unrelated errors."""
    text = str(exc).lower()
    if not any(marker in text for marker in _PEER_FAILURE_MARKERS):
        return None
    return (
        "multi-host peer failure detected: a peer process died, was "
        "preempted, or became unreachable (collective error above). This "
        "rank is exiting now; restart the job on EVERY host (batch "
        "inference simply reruns)."
    )


#: The ONE exit code for classified multi-process peer failures, in every
#: CLI and handler, as in the JAX package (docs/RUNBOOK.md): distinct from
#: the setup (1) and run-loop (2) codes, so an orchestrator keys "restart
#: every process" off one value.
PEER_FAILURE_EXIT_CODE = 3


def exit_on_peer_failure(exc, multihost: bool) -> None:
    """When a collective raised because a PEER failed: print the error and
    the diagnosis (flushed) and leave at once with PEER_FAILURE_EXIT_CODE,
    through ``os._exit``: interpreter exit could block on the process
    group's threads, which wait on the dead peer. No-op when ``multihost``
    is false or the error is not a peer failure."""
    if not multihost:
        return
    diagnosis = peer_failure_diagnosis(exc)
    if diagnosis is None:
        return
    print(exc, flush=True)
    print(diagnosis, flush=True)
    sys.stderr.flush()
    os._exit(PEER_FAILURE_EXIT_CODE)
