"""annonet_serve on the port: a persistent inference server on one device.

The JAX package's ``annonet_tpu/cli/serve.py`` on the port's
``TiledInferer`` and its hand-written kernels. The server loads the
self-describing artifact once, keeps one long-lived inferer (its plan
constants, and on the int8 path its frozen int8 net) and serves
inference over plain HTTP (standard library only). The protocol is the
JAX server's, byte for byte, so ``annonet_tpu_torch/client.py``,
``annonet_tpu/client.py`` and ``native/annonet_client.{h,cpp}`` work
against either server:

  GET  /healthz          -> JSON: model metadata, classes, ready state
                            (503 with status "stalled" or "rss-exceeded")
  GET  /stats            -> JSON: request/batch counters + request-latency
                            percentiles over a bounded recent window
  GET  /metrics          -> the same in Prometheus exposition format
  GET  /model            -> JSON: the served artifact's identity
  GET  /calibration      -> the serving int8 calibration as
                            --save-calibration npz bytes (409 when not int8
                            or nothing frozen yet)
  POST /infer            -> body: an encoded image (PNG/JPEG/...), or raw
                            uint8 pixels with an ``X-Image-Shape: h,w,c``
                            header; response: the label map as
                            ``format=png`` (default; the CLI's result PNG),
                            ``format=labels`` (uint16 little-endian,
                            ``X-Label-Shape: h,w``) or ``format=counts``
                            (JSON); ``gain=<class>:<value>`` and
                            ``detection=<class>:<value>`` override the
                            server's -g/-d for one request
  POST /reload           -> hot-swap to the artifact on disk
                            (?recalibrate=1 drops a stale --calibration
                            file); SIGHUP and --watch-model do the same.
                            A same-architecture artifact swaps its weights
                            into the serving inferer (update_params); any
                            other is loaded and warmed beside the old
                            model, which serves until the swap; on any
                            failure the old model keeps serving (409)

One device runs one request's forward at a time: the device section is
serialised by a lock, and decoding, the blob veto, resizing and encoding
run in the request threads. With ``--max-batch M`` a dispatcher thread
groups up to M concurrent same-shape requests (same gains and detection
levels, same model) into one ``infer_arrays_batch`` call.

The device is ``cuda:<--device or 0>``, or the CPU when
ANNONET_TPU_TORCH_DEVICE=cpu asks for it (``cli/common.py::resolve_device``):
without a card and without that request the server prints the error and
exits 1. At startup it probes the device (``device_probe``) and builds and
loads the kernel library before it binds its port, so no request pays the
build. ``compiled_programs`` in /stats, /metrics and /model counts the plans
whose constants the inferer holds (the JAX server counts compiled XLA
programs); ``--no-compilation-cache`` is accepted and does nothing (the
port compiles no programs at run time). ``--mesh N`` builds the inferer
on a mesh of N devices (``cli/common.py::make_cli_mesh``: the first N
cards, or N virtual shards of the one device under
ANNONET_TPU_VIRTUAL_MESH=1), so each request's tile batch is split over
them; ``/reload`` rebuilds on the same mesh. The HTTP protocol is the same
with or without it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import threading
import time
from typing import Optional

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="annonet_serve",
        description="Serve a trained annonet model over HTTP",
    )
    p.add_argument("--model", default="annonet.dnn",
                   help="Model artifact path (default: annonet.dnn)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8096,
                   help="TCP port (0 = ephemeral; the bound port is printed)")
    p.add_argument("-g", "--gain", action="append", default=[],
                   help="Server-default class-specific gain, e.g. 1:-0.5")
    p.add_argument("-d", "--detection", action="append", default=[],
                   help="Server-default class-specific detection level")
    p.add_argument("-w", "--tile-max-width", type=int, default=None,
                   help="Max tile width (default: 1024, the reference's "
                        "CUDA default)")
    p.add_argument("--tile-max-height", type=int, default=None,
                   help="Max tile height (default: 1024, like -w)")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="int8 = the int8 net (calibrated on the first "
                        "inferred image, or loaded with --calibration)")
    p.add_argument("--calibration-images", type=int, default=1)
    p.add_argument("--reference-blend-semantics", action="store_true",
                   help="Compat mode: gains/detection levels meet the "
                        "UNNORMALIZED ramp-sum blend inside tile-overlap "
                        "bands, matching the reference "
                        "(annonet_infer.cpp:146-161,176-185,205-211); "
                        "for serving with gains/levels tuned on a "
                        "reference deployment")
    p.add_argument("--calibration", default=None, metavar="PATH",
                   help="Persisted int8 calibration (annonet_infer "
                        "--save-calibration): skips runtime calibration, "
                        "every request runs int8 reproducibly")
    p.add_argument("--device", type=int, default=None,
                   help="CUDA device index")
    p.add_argument("--warmup", action="append", default=[], metavar="HxW",
                   help="Run the model once on a mid-gray image of this size "
                        "at startup (repeatable, e.g. --warmup 2048x2048): "
                        "the plan's constants are made, and with "
                        "--calibration the int8 net is frozen, before the "
                        "first request")
    p.add_argument("--watch-model", type=float, default=0.0, metavar="SEC",
                   help="Poll the --model path every SEC seconds and "
                        "auto-reload when its mtime changes (the same code "
                        "path as POST /reload; failures keep the old model "
                        "and are retried on the next change). 0 = off "
                        "(default)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="Tile-parallel inference: each request's tile "
                        "batch is split over N CUDA devices")
    p.add_argument("--device-stall-seconds", type=float, default=300.0,
                   metavar="SEC",
                   help="Report status 'stalled' (healthz -> 503, "
                        "annonet_device_stalled=1) when an in-flight "
                        "device op has run longer than SEC (default 300; "
                        "floor 1). The first request of each input shape "
                        "gets 900 s extra allowance")
    p.add_argument("--max-rss-mb", type=float, default=0.0, metavar="MB",
                   help="Report status 'rss-exceeded' (healthz -> 503) "
                        "once the server's host RSS passes MB, so an "
                        "orchestrator rotates the replica out and "
                        "restarts it; 0 = off (default). In-flight "
                        "requests still complete")
    p.add_argument("--max-batch", type=int, default=1, metavar="M",
                   help="Dynamic request batching: group up to M "
                        "concurrent same-size /infer requests (same "
                        "gains/detection) into ONE device batch "
                        "(infer_arrays_batch). 1 = off")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="With --max-batch > 1: how long the dispatcher "
                        "waits for more requests to join a batch before "
                        "running a partial one (latency floor under "
                        "light load)")
    p.add_argument("--no-compilation-cache", action="store_true",
                   help="Accepted for flag parity; the port keeps no "
                        "compilation cache")
    p.add_argument("--plan-autotune", action="store_true",
                   help="Measured tile-plan selection: on the first image "
                        "of each canvas size (ideally at --warmup), time "
                        "the default tile plan and its denser "
                        "neighbouring grids on the device and serve with "
                        "the fastest")
    return p


def _process_rss_mb() -> float:
    """This process's VmRSS in MB (0.0 where /proc is unavailable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class _ModelState:
    """One loaded model: everything POST /reload swaps atomically — the
    deserialized artifact, its parsed classes and server defaults, and
    the inferer that runs it."""


def _load_state(args, device, mesh=None, reload_count: int = 0,
                ignore_calibration: bool = False,
                reuse_from: "_ModelState" = None) -> _ModelState:
    import os

    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.classes import parse_anno_classes
    from annonet_tpu_torch.cli.common import parse_class_specific_values
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.infer.tiling import TilingParameters, default_tile_max
    from annonet_tpu_torch.models.segnet import required_input_dimension

    st = _ModelState()
    (st.params, st.config, st.anno_classes_json,
     st.downscaling_factor) = serialization.load_model(args.model)
    st.anno_classes = parse_anno_classes(st.anno_classes_json)
    st.default_gains = parse_class_specific_values(args.gain, len(st.anno_classes))
    st.default_detection = parse_class_specific_values(
        args.detection, len(st.anno_classes), require_non_negative=True)
    min_dim = required_input_dimension(st.config)
    if args.tile_max_width is None:
        args.tile_max_width = default_tile_max()
    if args.tile_max_height is None:
        args.tile_max_height = default_tile_max()
    if args.tile_max_width < min_dim or args.tile_max_height < min_dim:
        raise RuntimeError(f"Tile size must be at least {min_dim}")
    st.required_input_dimension = min_dim
    calibration = None
    if getattr(args, "calibration", None):
        if args.quantize != "int8":
            raise RuntimeError("--calibration requires --quantize int8")
        if not ignore_calibration:
            # fingerprint-checked against THIS model's weights: a retrained
            # artifact with a stale calibration file fails here (the old
            # model keeps serving) unless POST /reload?recalibrate=1
            calibration = serialization.load_calibration(
                args.calibration, st.config, st.params)
    # the fast path of a reload: a same-architecture artifact without a
    # pinned calibration swaps its weights into the serving inferer
    # (update_params keeps the plan constants); the caller applies the
    # swap under the device lock, and until then the inferer serves the
    # old weights
    st.fast_swap = (
        reuse_from is not None
        and getattr(reuse_from, "inferer", None) is not None
        and reuse_from.config == st.config
        and calibration is None
    )
    if st.fast_swap:
        st.inferer = reuse_from.inferer
    else:
        st.inferer = TiledInferer(
            st.params, st.config,
            TilingParameters(
                max_tile_width=args.tile_max_width,
                max_tile_height=args.tile_max_height,
                overlap_x=min_dim, overlap_y=min_dim,
            ),
            device=device if mesh is None else None, mesh=mesh,
            quantize=None if args.quantize == "none" else args.quantize,
            calibration_images=args.calibration_images,
            calibration=calibration,
            reference_blend_semantics=getattr(args, "reference_blend_semantics", False),
            plan_autotune=getattr(args, "plan_autotune", False),
        )
    st.quantize = args.quantize
    st.model_path = args.model
    try:
        st.model_mtime = os.path.getmtime(args.model)
    except OSError:
        st.model_mtime = None
    st.loaded_at = time.time()
    st.reload_count = reload_count
    return st


class _ModelService:
    """The shared model state behind the HTTP handlers."""

    def __init__(self, args, device=None):
        from annonet_tpu_torch.cli.common import make_cli_mesh, resolve_device

        if device is None:
            device = resolve_device(args.device)
        self._args = args
        self.device = device
        # --mesh: every inferer of this service, reloads included, splits
        # its tile batches over the same devices
        self.mesh = make_cli_mesh(args.mesh, device) if getattr(args, "mesh", None) else None
        self.state = _load_state(args, device, self.mesh)
        # one device runs one forward at a time; decode/encode stay parallel
        self.device_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.requests_served = 0
        self.batches_dispatched = 0
        # stall signalling: while a thread is inside a device section this
        # holds (start time, allowance). A wedged device op cannot be
        # cancelled, so healthz says so (503, "stalled") once it outlasts
        # its allowance. The first section of each input shape gets extra
        # grace: it makes the plan's constants (and under --plan-autotune
        # times every candidate), which must not read as a wedge.
        self._device_busy_since = None
        self._seen_canvases: set = set()
        self.device_stall_seconds = max(
            1.0, float(getattr(args, "device_stall_seconds", 300.0) or 300.0))
        self.compile_grace_seconds = 900.0
        # bounded per-request latency samples (seconds) for GET /stats
        from collections import deque

        self._latencies = deque(maxlen=2048)
        # the stages of the last /infer request that got a 200, in ms
        # (read body, decode, downscale, batch wait, device section, veto,
        # resize, encode): read in-process; no route reports them
        self.last_request_stages = None
        self.max_batch = max(1, getattr(args, "max_batch", 1))
        self.max_rss_mb = float(getattr(args, "max_rss_mb", 0.0) or 0.0)
        self.batch_window = max(0.0, getattr(args, "batch_window_ms", 5.0)) / 1000.0
        self._batch_queue = None
        if self.max_batch > 1:
            import queue as _queue

            self._batch_queue = _queue.Queue()
            self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
            self._dispatcher.start()

    # -- the live model (swapped by reload) ------------------------------
    # In-process users read these off the service and see the current
    # state; request handlers snapshot `svc.state` once so that a reload
    # in the middle of a request cannot mix two models.

    @property
    def inferer(self):
        return self.state.inferer

    @property
    def config(self):
        return self.state.config

    @property
    def params(self):
        return self.state.params

    @property
    def anno_classes(self):
        return self.state.anno_classes

    def reload(self, recalibrate: bool = False) -> dict:
        """Hot-swap to the artifact currently on disk (POST /reload).

        A same-architecture artifact without a pinned calibration swaps
        its weights into the serving inferer under the device lock
        (``fast_swap``). Any other is loaded into a new inferer and warmed
        at the --warmup sizes outside the device lock, so live requests
        keep running on the old model meanwhile; then the state swaps.
        On any failure (missing or corrupt artifact, a class count that
        -g/-d do not fit, a stale --calibration fingerprint) the old model
        keeps serving and the error propagates. ``recalibrate=True``
        drops the --calibration file for this load: the int8 net
        calibrates on the first real images again."""
        with self._reload_lock:
            new = _load_state(
                self._args, self.device, self.mesh,
                reload_count=self.state.reload_count + 1,
                ignore_calibration=recalibrate,
                reuse_from=self.state,
            )
            warmed = []
            if new.fast_swap:
                with self._device_section():
                    new.inferer.update_params(new.params)
                    self.state = new
            else:
                for spec in getattr(self._args, "warmup", []) or []:
                    h, w = _parse_warmup_spec(spec)
                    _warmup_one(self, new, h, w)
                    warmed.append(f"{h}x{w}")
                with self.device_lock:
                    self.state = new
                    # the new inferer makes its plan constants again
                    self._seen_canvases = set()
        return {
            "status": "reloaded",
            "model": new.model_path,
            "model_mtime": new.model_mtime,
            "reload_count": new.reload_count,
            "class_count": len(new.anno_classes),
            "quantize": new.quantize,
            "recalibrate": bool(recalibrate),
            "fast_swap": bool(new.fast_swap),
            "warmed": warmed,
        }

    def start_model_watch(self, interval: float) -> threading.Event:
        """--watch-model: poll the artifact's mtime every ``interval``
        seconds and reload on a change; returns the stop Event. A failed
        reload keeps the old model and is retried only when the file
        changes again."""
        import os

        stop = threading.Event()

        def loop():
            last = self.state.model_mtime
            while not stop.wait(interval):
                try:
                    mtime = os.path.getmtime(self.state.model_path)
                except OSError:
                    continue
                if last is not None and mtime == last:
                    continue
                last = mtime
                try:
                    info = self.reload()
                    print(f"reloaded (watch): {json.dumps(info)}", flush=True)
                except Exception as e:  # noqa: BLE001 — the watch keeps running
                    print(f"reload failed (watch), old model kept: {e}", flush=True)

        threading.Thread(target=loop, daemon=True, name="annonet-model-watch").start()
        return stop

    # -- image pipeline (the batch CLI's per-image flow) -----------------

    def decode(self, body: bytes, state: "_ModelState" = None):
        """Encoded image bytes -> (H, W, C) uint8 in the model's channel
        layout (PIL's conversions, as the JAX server and data.sample)."""
        import numpy as np
        from PIL import Image

        grayscale = (state.config if state is not None else self.config).grayscale
        with Image.open(io.BytesIO(body)) as im:
            im = im.convert("L" if grayscale else "RGB")
            arr = np.asarray(im, dtype="uint8")
        if grayscale:
            arr = arr[..., None]
        return arr

    def decode_raw(self, body: bytes, shape_header: str, state: "_ModelState" = None):
        """Raw uint8 pixels + ``X-Image-Shape: h,w,c`` -> (H, W, C) uint8
        in the model's channel layout, with :meth:`decode`'s conversions: a
        3-channel body into a grayscale model goes through PIL's ITU-R
        601-2 ``convert("L")``, a 1-channel body into an RGB model is
        replicated (PIL's L->RGB)."""
        import numpy as np
        from PIL import Image

        try:
            h, w, c = (int(v) for v in shape_header.split(","))
        except ValueError:
            raise ValueError(f"bad X-Image-Shape {shape_header!r} (expected h,w,c)") from None
        if h < 1 or w < 1 or c not in (1, 3):
            raise ValueError(
                f"bad X-Image-Shape {shape_header!r} (h, w >= 1; c must be 1 or 3)")
        if len(body) != h * w * c:
            raise ValueError(
                f"raw body is {len(body)} bytes, expected {h}*{w}*{c} = {h * w * c}")
        arr = np.frombuffer(body, dtype=np.uint8).reshape(h, w, c)
        grayscale = (state.config if state is not None else self.config).grayscale
        want = 1 if grayscale else 3
        if c != want:
            mode = "L" if c == 1 else "RGB"
            im = Image.fromarray(arr if c == 3 else arr[..., 0], mode=mode)
            arr = np.asarray(im.convert("L" if grayscale else "RGB"), dtype=np.uint8)
            if grayscale:
                arr = arr[..., None]
        return arr

    @contextlib.contextmanager
    def _device_section(self, key=None):
        """device_lock plus the stall bookkeeping: every lock-held device
        op goes through here so that healthz can report a wedged device.
        ``key`` identifies the input geometry; its first section gets
        ``compile_grace_seconds`` more. ``key=None`` (a weight swap) gets
        the plain allowance."""
        with self.device_lock:
            allowance = self.device_stall_seconds
            if key is not None and key not in self._seen_canvases:
                allowance += self.compile_grace_seconds
            self._device_busy_since = (time.monotonic(), allowance)
            try:
                yield
                if key is not None:
                    self._seen_canvases.add(key)
            finally:
                self._device_busy_since = None

    def device_busy_seconds(self):
        """Seconds the current device section has been running (None when
        idle). Read once: the field may clear concurrently."""
        entry = self._device_busy_since
        return None if entry is None else max(0.0, time.monotonic() - entry[0])

    def device_stalled(self) -> bool:
        entry = self._device_busy_since
        if entry is None:
            return False
        t0, allowance = entry
        return time.monotonic() - t0 > allowance

    def _device_pass(self, image, gains, detection_levels, inferer):
        """One image through the device (no batching): (labels, seeds)."""
        with_detection = any(d != 0.0 for d in detection_levels)
        with self._device_section(key=("single", image.shape)):
            if with_detection:
                return inferer.infer_arrays(
                    image, gains=gains, detection_levels=detection_levels)
            labels, _ = inferer.infer_arrays(image, gains=gains)
            return labels, None

    def _dispatch_loop(self):
        """Group queued requests by (shape, gains, detection, model) and run
        each group as one batched device call; a partial group runs after
        batch_window. Results land on each pending request's event."""
        import queue as _queue

        import numpy as np

        while True:
            first = self._batch_queue.get()
            if first is None:
                return
            group = [first]
            deadline = time.monotonic() + self.batch_window
            while len(group) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._batch_queue.get(timeout=timeout)
                except _queue.Empty:
                    break
                if nxt is None:
                    return
                group.append(nxt)
            by_key = {}
            for p in group:
                # id(state) in the key: requests on either side of a reload
                # run on their own model
                key = (p["image"].shape, tuple(p["gains"]), tuple(p["detection"]),
                       id(p["state"]))
                by_key.setdefault(key, []).append(p)
            for (_shape, gains, detection, _sid), ps in by_key.items():
                try:
                    with_detection = any(d != 0.0 for d in detection)
                    batch = np.stack([p["image"] for p in ps])
                    t0 = time.monotonic()
                    with self._device_section(key=("batch", batch.shape)):
                        labels, seeds = ps[0]["state"].inferer.infer_arrays_batch(
                            batch, gains=list(gains),
                            detection_levels=list(detection) if with_detection else None,
                        )
                    device_seconds = time.monotonic() - t0
                    with self._stats_lock:
                        self.batches_dispatched += 1
                    for i, p in enumerate(ps):
                        p["labels"] = labels[i]
                        p["seeds"] = None if seeds is None else seeds[i]
                        p["device_seconds"] = device_seconds
                except Exception as e:  # noqa: BLE001 — raised in each request's thread
                    for p in ps:
                        p["error"] = e
                finally:
                    for p in ps:
                        p["event"].set()

    def infer(self, image, gains, detection_levels, state: "_ModelState" = None,
              stages: dict = None):
        """One image's whole flow: downscale -> tiled forward (batched with
        concurrent same-shape requests under --max-batch) -> blob veto ->
        labels resized to the original size (annonet_infer.cpp's flow).
        ``state`` pins the request to one loaded model across a reload;
        ``stages``, when given, receives each step's seconds."""
        from annonet_tpu_torch.data.sample import resize_image_bilinear, resize_label_image
        from annonet_tpu_torch.infer.core import detection_veto

        st = state if state is not None else self.state
        stages = {} if stages is None else stages
        t_start = t = time.monotonic()

        def lap(name):
            nonlocal t
            now = time.monotonic()
            stages[name] = now - t
            t = now

        orig_h, orig_w = image.shape[:2]
        if st.downscaling_factor != 1.0:
            h = max(1, int(round(orig_h / st.downscaling_factor)))
            w = max(1, int(round(orig_w / st.downscaling_factor)))
            image = resize_image_bilinear(image, w, h)
        lap("downscale")
        if self._batch_queue is not None:
            pending = {
                "image": image, "gains": list(gains),
                "detection": list(detection_levels),
                "state": st,
                "event": threading.Event(),
                "labels": None, "seeds": None, "error": None, "device_seconds": None,
            }
            self._batch_queue.put(pending)
            pending["event"].wait()
            if pending["error"] is not None:
                raise pending["error"]
            labels, seeds = pending["labels"], pending["seeds"]
            lap("batch wait")
            stages["batch wait"] -= pending["device_seconds"]
            stages["device section"] = pending["device_seconds"]
        else:
            labels, seeds = self._device_pass(image, gains, detection_levels, st.inferer)
            lap("device section")
        if seeds is not None:
            labels = detection_veto(labels, seeds)
        lap("detection veto")
        if labels.shape != (orig_h, orig_w):
            labels = resize_label_image(labels, orig_w, orig_h)
        lap("resize")
        with self._stats_lock:
            self.requests_served += 1
            self._latencies.append(time.monotonic() - t_start)
        return labels

    def encode_png(self, labels, state: "_ModelState" = None) -> bytes:
        from PIL import Image

        from annonet_tpu_torch.data.codec import index_label_image_to_rgba_label_image

        rgba = index_label_image_to_rgba_label_image(
            labels, state.anno_classes if state is not None else self.anno_classes)
        buf = io.BytesIO()
        Image.fromarray(rgba, mode="RGBA").save(buf, format="PNG")
        return buf.getvalue()

    def stats(self) -> dict:
        """Request/batch counters and request-latency percentiles over a
        bounded window of recent requests (the infer flow: downscale,
        device pass with any batching wait, blob veto, resize; not
        decode/encode, which run in the request threads)."""
        with self._stats_lock:
            lat = sorted(self._latencies)
            served = self.requests_served
            batches = self.batches_dispatched

        def pct(p):
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 2)

        return {
            "requests_served": served,
            "batches_dispatched": batches,
            "latency_window": len(lat),
            "latency_ms": {
                "mean": round(sum(lat) / len(lat) * 1e3, 2) if lat else None,
                "p50": pct(0.50),
                "p90": pct(0.90),
                "p99": pct(0.99),
                "max": round(lat[-1] * 1e3, 2) if lat else None,
            },
            "compiled_programs": self.inferer.compiled_programs,
            "rss_mb": round(_process_rss_mb(), 1),
        }

    def metrics_text(self) -> str:
        """GET /metrics: the /stats content in Prometheus exposition format
        (text/plain; version=0.0.4), under the JAX server's metric names.
        The windowed latency percentiles are gauges over the recent
        window, not cumulative summary quantiles."""
        s = self.stats()
        st = self.state
        lines = [
            "# HELP annonet_requests_served_total Inference requests "
            "served since process start.",
            "# TYPE annonet_requests_served_total counter",
            f"annonet_requests_served_total {s['requests_served']}",
            "# HELP annonet_batches_dispatched_total Device batches "
            "dispatched (dynamic batching groups requests).",
            "# TYPE annonet_batches_dispatched_total counter",
            f"annonet_batches_dispatched_total {s['batches_dispatched']}",
            "# HELP annonet_model_reloads_total Successful hot model "
            "reloads (POST /reload or SIGHUP).",
            "# TYPE annonet_model_reloads_total counter",
            f"annonet_model_reloads_total {st.reload_count}",
            "# HELP annonet_compiled_programs Tile plans whose constants "
            "the current model's inferer holds.",
            "# TYPE annonet_compiled_programs gauge",
            f"annonet_compiled_programs {s['compiled_programs']}",
            "# HELP annonet_latency_window Request-latency samples in the "
            "bounded recent window.",
            "# TYPE annonet_latency_window gauge",
            f"annonet_latency_window {s['latency_window']}",
            "# HELP annonet_device_busy_seconds Age of the in-flight "
            "device section (0 when idle).",
            "# TYPE annonet_device_busy_seconds gauge",
            f"annonet_device_busy_seconds {self.device_busy_seconds() or 0.0:.3f}",
            "# HELP annonet_device_stalled 1 when the in-flight device op "
            "exceeded --device-stall-seconds (healthz serves 503).",
            "# TYPE annonet_device_stalled gauge",
            f"annonet_device_stalled {int(self.device_stalled())}",
            "# HELP annonet_process_rss_mb Server host RSS.",
            "# TYPE annonet_process_rss_mb gauge",
            f"annonet_process_rss_mb {s['rss_mb']}",
            "# HELP annonet_rss_exceeded 1 when RSS passed --max-rss-mb "
            "(healthz serves 503 so the replica is rotated out).",
            "# TYPE annonet_rss_exceeded gauge",
            f"annonet_rss_exceeded {int(self.rss_exceeded())}",
        ]
        lat = s["latency_ms"]
        if lat["p50"] is not None:
            lines += [
                "# HELP annonet_request_latency_seconds Request latency "
                "over the recent window (downscale + device pass incl. "
                "batching wait + veto + upscale).",
                "# TYPE annonet_request_latency_seconds gauge",
            ]
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                lines.append(
                    f'annonet_request_latency_seconds{{quantile="{q}"}} {lat[key] / 1e3:.6f}')
            lines += [
                "# HELP annonet_request_latency_seconds_max Max request "
                "latency over the recent window.",
                "# TYPE annonet_request_latency_seconds_max gauge",
                f"annonet_request_latency_seconds_max {lat['max'] / 1e3:.6f}",
                "# HELP annonet_request_latency_seconds_mean Mean request "
                "latency over the recent window.",
                "# TYPE annonet_request_latency_seconds_mean gauge",
                f"annonet_request_latency_seconds_mean {lat['mean'] / 1e3:.6f}",
            ]
        return "\n".join(lines) + "\n"

    def rss_exceeded(self) -> bool:
        """--max-rss-mb: true once host RSS passes the limit."""
        return bool(self.max_rss_mb > 0.0 and _process_rss_mb() > self.max_rss_mb)

    def healthz(self) -> dict:
        st = self.state
        busy = self.device_busy_seconds()
        stalled = self.device_stalled()
        # "stalled" / "rss-exceeded" (served as 503): take this replica out
        # of rotation until it recovers or restarts
        status = "ok"
        if self.rss_exceeded():
            status = "rss-exceeded"
        if stalled:
            status = "stalled"
        return {
            "status": status,
            "device_busy_seconds": busy,
            "model": st.model_path,
            "model_mtime": st.model_mtime,
            "reload_count": st.reload_count,
            "downscaling_factor": st.downscaling_factor,
            "required_input_dimension": st.required_input_dimension,
            "quantize": st.quantize,
            "requests_served": self.requests_served,
            "max_batch": self.max_batch,
            "batches_dispatched": self.batches_dispatched,
            "classes": [
                {"label": c.classlabel, "color_rgba": list(map(int, c.rgba_label))}
                for c in st.anno_classes
            ],
        }

    def calibration_npz(self) -> bytes:
        """GET /calibration: the serving int8 calibration as
        ``--save-calibration`` npz bytes, for restarting every replica
        with ``--calibration``. Raises RuntimeError (HTTP 409) when the
        server is not int8 or nothing has frozen yet."""
        from annonet_tpu_torch import serialization

        st = self.state
        if st.quantize != "int8":
            raise RuntimeError("not an int8 server (start with --quantize int8)")
        exported = st.inferer.export_calibration()
        if exported is None:
            raise RuntimeError(
                "no int8 calibration frozen yet — serve at least "
                "--calibration-images real images first")
        return serialization.calibration_npz_bytes(exported, st.config, st.params)

    def model_info(self) -> dict:
        """GET /model: the currently served artifact's identity."""
        st = self.state
        return {
            "model": st.model_path,
            "model_mtime": st.model_mtime,
            "loaded_at": st.loaded_at,
            "reload_count": st.reload_count,
            "quantize": st.quantize,
            "downscaling_factor": st.downscaling_factor,
            "required_input_dimension": st.required_input_dimension,
            "class_count": len(st.anno_classes),
            "classes": [c.classlabel for c in st.anno_classes],
            "compiled_programs": st.inferer.compiled_programs,
        }


def _parse_query_values(state, query, key, *, require_non_negative=False):
    from annonet_tpu_torch.cli.common import parse_class_specific_values

    items = query.get(key)
    if not items:
        return None
    return parse_class_specific_values(
        items, len(state.anno_classes), require_non_negative=require_non_negative)


def make_server(args, service: Optional[_ModelService] = None):
    """Build (server, service); separate from main so that tests can bind
    an ephemeral port and drive requests in-process."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    svc = service if service is not None else _ModelService(args)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # a client that announces more Content-Length than it sends must
        # not hold a handler thread forever
        timeout = 120
        max_body_bytes = 256 * 1024 * 1024

        def log_message(self, fmt, *log_args):  # quiet by default
            pass

        def _send(self, code, content_type, body: bytes, extra=None):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, obj):
            self._send(code, "application/json", json.dumps(obj).encode("utf-8"))

        def do_GET(self):
            self._drain_body()  # a GET carrying a body must not desync
            path = urlparse(self.path).path
            if path in ("/healthz", "/"):
                payload = svc.healthz()
                self._send_json(503 if payload["status"] != "ok" else 200, payload)
            elif path == "/stats":
                self._send_json(200, svc.stats())
            elif path == "/metrics":
                self._send(200, "text/plain; version=0.0.4; charset=utf-8",
                           svc.metrics_text().encode("utf-8"))
            elif path == "/model":
                self._send_json(200, svc.model_info())
            elif path == "/calibration":
                try:
                    body = svc.calibration_npz()
                except RuntimeError as e:
                    # the two client-state conditions (not int8, nothing frozen)
                    self._send_json(409, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — reported as a 500
                    self._send_json(500, {"error": str(e)})
                else:
                    self._send(200, "application/octet-stream", body, extra={
                        "Content-Disposition":
                            'attachment; filename="annonet_calibration.npz"',
                    })
            else:
                self._send_json(404, {"error": "not found"})

        def _drain_body(self):
            # consume any request body so that a keep-alive connection
            # stays in sync for routes that read none; a body over the cap
            # closes the connection instead
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = 0
            if length > self.max_body_bytes:
                self.close_connection = True
                return
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 20))
                if not chunk:
                    break
                length -= len(chunk)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/reload":
                self._drain_body()
                query = parse_qs(url.query)
                recal = query.get("recalibrate", ["0"])[0] in ("1", "true")
                try:
                    self._send_json(200, svc.reload(recalibrate=recal))
                except Exception as e:  # noqa: BLE001 — the old model keeps serving
                    self._send_json(409, {"error": str(e)})
                return
            if url.path != "/infer":
                self._drain_body()
                self._send_json(404, {"error": "not found"})
                return
            st = svc.state  # one model per request, even across a reload
            stages = {}
            t = time.monotonic()
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0:
                    raise ValueError("empty request body")
                if length > self.max_body_bytes:
                    raise ValueError(f"request body exceeds {self.max_body_bytes} bytes")
                body = self.rfile.read(length)
                if len(body) < length:
                    raise ValueError("truncated request body")
                stages["read body"] = time.monotonic() - t
                query = parse_qs(url.query)
                gains = _parse_query_values(st, query, "gain")
                if gains is None:
                    gains = st.default_gains
                detection = _parse_query_values(
                    st, query, "detection", require_non_negative=True)
                if detection is None:
                    detection = st.default_detection
                fmt = query.get("format", ["png"])[0]
                if fmt not in ("png", "labels", "counts"):
                    raise ValueError(f"unknown format: {fmt}")
                raw_shape = self.headers.get("X-Image-Shape")
                t = time.monotonic()
                if raw_shape is not None:
                    image = svc.decode_raw(body, raw_shape, state=st)
                else:
                    image = svc.decode(body, state=st)
                stages["decode"] = time.monotonic() - t
            except Exception as e:  # noqa: BLE001 — bad input -> 400 with the message
                self._send_json(400, {"error": str(e)})
                return
            try:
                import numpy as np

                t0 = time.monotonic()
                labels = svc.infer(image, gains, detection, state=st, stages=stages)
                elapsed_ms = (time.monotonic() - t0) * 1000.0
                timing = {"X-Inference-Ms": f"{elapsed_ms:.1f}"}
                t = time.monotonic()
                if fmt == "png":
                    self._send(200, "image/png", svc.encode_png(labels, state=st), timing)
                elif fmt == "labels":
                    # uint16 little-endian on the wire, whatever the labels' dtype
                    raw = np.ascontiguousarray(labels.astype("<u2")).tobytes()
                    timing["X-Label-Shape"] = f"{labels.shape[0]},{labels.shape[1]}"
                    self._send(200, "application/octet-stream", raw, timing)
                else:  # counts
                    counts = np.bincount(labels.ravel(), minlength=len(st.anno_classes))
                    self._send_json(200, {
                        "counts": {
                            c.classlabel: int(n) for c, n in zip(st.anno_classes, counts)
                        },
                        "inference_ms": elapsed_ms,
                    })
                stages["encode and send"] = time.monotonic() - t
                svc.last_request_stages = {k: v * 1e3 for k, v in stages.items()}
            except Exception as e:  # noqa: BLE001 — inference failure -> 500
                self._send_json(500, {"error": str(e)})

    server = ThreadingHTTPServer((args.host, args.port), Handler)
    server.daemon_threads = True
    return server, svc


def _parse_warmup_spec(spec: str):
    try:
        h, w = (int(v) for v in spec.lower().split("x"))
        if h < 1 or w < 1:
            raise ValueError
    except ValueError:
        raise RuntimeError(
            f"bad --warmup size {spec!r} (expected HxW, e.g. 2048x2048)") from None
    return h, w


def _warmup_one(service: _ModelService, state: _ModelState, h: int, w: int) -> None:
    """Run STATE's inferer once on a mid-gray image of one canvas size:
    its plan constants (every candidate's under --plan-autotune), and with
    a calibration file its int8 net, are made before the first request.
    Used at startup and for a reload's warm-up before the swap.

    Drives STATE's inferer directly, not through service.infer: a
    reload's warm-up must not hold the device lock (live requests on the
    old model keep running; the two inferers share nothing and queue
    their work on the same device), and warm-up runs must not count as
    served requests or enter the latency window."""
    import numpy as np

    print(f"Warming up {h}x{w}...", flush=True)
    t0 = time.monotonic()
    image = np.full((h, w, 1 if state.config.grayscale else 3), 127, np.uint8)
    if state.downscaling_factor != 1.0:
        # requests downscale before the device pass: warm the canvas that
        # real requests of h x w reach
        from annonet_tpu_torch.data.sample import resize_image_bilinear

        dh = max(1, int(round(h / state.downscaling_factor)))
        dw = max(1, int(round(w / state.downscaling_factor)))
        image = resize_image_bilinear(image, dw, dh)
    inferer = state.inferer
    with_detection = any(d != 0.0 for d in state.default_detection)
    kwargs = {"detection_levels": state.default_detection} if with_detection else {}
    if (state.quantize == "int8" and not inferer._calib_frozen
            and inferer._preloaded_calib is None):
        # the flat gray image must not set the int8 activation scales (it
        # would clip every real request): warm the float net and leave
        # the calibration to the first real images
        print(
            "  note: no --calibration given — warm-up runs the float net "
            "only; int8 calibrates on the first real image(s). Persist "
            "scales with annonet_infer --save-calibration for a full "
            "warm-up.",
            flush=True,
        )
        with inferer.pause_calibration():
            inferer.infer_arrays(image, gains=state.default_gains, **kwargs)
    else:
        inferer.infer_arrays(image, gains=state.default_gains, **kwargs)
    print(f"  compiled + ran in {time.monotonic() - t0:.1f} s", flush=True)
    from annonet_tpu_torch.infer.tiling import bucket_dim

    key = (bucket_dim(image.shape[0], 128), bucket_dim(image.shape[1], 128))
    report = inferer.autotune_reports.get(key)
    if report:
        chosen = report[0][0]
        print(
            f"  plan autotune {key[0]}x{key[1]}: chose "
            f"{chosen.tile_height}x{chosen.tile_width}x{chosen.tile_count} of "
            + ", ".join(
                f"{p.tile_height}x{p.tile_width}x{p.tile_count}"
                + (f"={r:.0f}Mpx/s" if r else "")
                for p, r in report
            ),
            flush=True,
        )


def _warmup(service: _ModelService, sizes) -> None:
    for spec in sizes:
        h, w = _parse_warmup_spec(spec)
        _warmup_one(service, service.state, h, w)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        from annonet_tpu_torch.cli.common import device_probe, resolve_device

        device = resolve_device(args.device)
        device_probe(device)
        if device.type == "cuda":
            # build and load the kernel library now, so that a cold build
            # never lands inside a request's device section
            from annonet_tpu_torch.ops import _build

            _build.lib()
        service = _ModelService(args, device=device)
    except Exception as e:  # noqa: BLE001 — setup errors: the message and exit 1
        print(str(e))
        return 1
    if args.warmup:
        try:
            _warmup(service, args.warmup)
        except Exception as e:  # noqa: BLE001
            print(str(e))
            return 1
    server, _ = make_server(args, service)
    host, port = server.server_address[:2]

    # Graceful SIGTERM: stop accepting, finish in-flight requests, exit 0.
    # shutdown() blocks until serve_forever returns, so it runs off the
    # signal handler's thread (which is serve_forever's). Installed before
    # the "listening on" line, so a supervisor that reacts to that line
    # cannot signal before the handler is in place.
    import signal

    def _term(_signum, _frame):
        print("shutting down (SIGTERM)", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    def _hup(_signum, _frame):
        # "pick up the new model": POST /reload's code path, off the
        # signal thread
        def _do():
            try:
                info = service.reload()
                print(f"reloaded (SIGHUP): {json.dumps(info)}", flush=True)
            except Exception as e:  # noqa: BLE001 — the old model keeps serving
                print(f"reload failed (SIGHUP), old model kept: {e}", flush=True)

        threading.Thread(target=_do, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
        if hasattr(signal, "SIGHUP"):
            signal.signal(signal.SIGHUP, _hup)
    except (ValueError, OSError):  # not the main thread
        pass
    watch_stop = None
    if args.watch_model and args.watch_model > 0:
        watch_stop = service.start_model_watch(args.watch_model)
    print(f"annonet_serve: listening on http://{host}:{port} "
          f"(model={args.model}, quantize={args.quantize})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        if watch_stop is not None:
            watch_stop.set()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
