"""Python client for ``annonet_serve``: the JAX package's
``annonet_tpu/client.py``, copied so that callers of the port's server
(and ``chip_smoke.py``) need nothing of the JAX package.

It speaks the server's HTTP protocol with the standard library and numpy
only, so it imports neither torch nor jax and works against either
package's server (``python -m annonet_tpu_torch.cli.serve`` or
``annonet_tpu.cli.serve``). Every call returns what
``annonet_infer(net, image, gains, detection_levels)`` would
(annonet_infer.h:34-42): the per-pixel class indices. ndarray pixels
travel over the server's zero-codec raw path (``X-Image-Shape`` header),
so no image codec runs on either side.

Example::

    from annonet_tpu_torch.client import ServeClient

    client = ServeClient(port=8096)
    labels = client.infer(image)                 # [H, W] uint16
    counts = client.class_counts(image)          # {"clean": 12345, ...}

Thread safety: every call opens its own connection, so one client may be
shared across threads.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["ServeClient", "ServeError"]

ClassValues = Union[Mapping[int, float], Sequence[float]]


class ServeError(RuntimeError):
    """A failed request. ``status`` is the HTTP status code (None for
    transport errors); the message carries the server's JSON ``error``
    text when one was returned, and ``payload`` the parsed JSON body
    (when the body was a JSON object)."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status
        self.payload: Optional[dict] = None


def _class_value_params(name: str, values: Optional[ClassValues]):
    """Encode gains/detection levels as repeated ``name=<class>:<value>``
    query items — the CLI's -g/-d syntax (annonet_infer_main.cpp:36-63).

    Accepts a mapping {class_index: value} or a per-class sequence.
    NOTE: like the CLI flags, any explicit value replaces the SERVER'S
    defaults with a zero-filled vector plus the given entries — pass
    nothing (None) to use the server's -g/-d defaults.
    """
    if values is None:
        return []
    if isinstance(values, Mapping):
        items = sorted((int(k), float(v)) for k, v in values.items())
    else:
        items = list(enumerate(float(v) for v in values))
    out = [(name, f"{idx}:{val:.17g}") for idx, val in items]
    # a fully-zero explicit spec still must override the server default:
    # send at least one entry
    return out or [(name, "0:0")]


class ServeClient:
    """HTTP client for one ``annonet_serve`` endpoint."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8096,
        timeout: float = 120.0,
    ):
        self._base = f"http://{host}:{port}"
        self._timeout = float(timeout)

    # ------------------------------------------------------------ plumbing

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[bytes, Dict[str, str]]:
        req = urllib.request.Request(
            self._base + path, data=body, method=method
        )
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                return resp.read(), {
                    k.lower(): v for k, v in resp.headers.items()
                }
        except urllib.error.HTTPError as e:
            raw = e.read()
            payload = None
            try:
                payload = json.loads(raw.decode("utf-8"))
                message = payload["error"]
            except Exception:  # noqa: BLE001 — non-JSON / non-error body
                message = raw.decode("utf-8", "replace") or str(e)
            err = ServeError(
                f"annonet_serve returned {e.code}: {message}", status=e.code
            )
            err.payload = payload if isinstance(payload, dict) else None
            raise err from None
        except OSError as e:
            raise ServeError(f"cannot reach {self._base}: {e}") from e

    def _get_json(self, path: str) -> dict:
        body, _ = self._request("GET", path)
        return json.loads(body.decode("utf-8"))

    # ------------------------------------------------------------- queries

    def healthz(self) -> dict:
        """GET /healthz: model metadata (classes, downscaling factor,
        required input dimension) plus ``status``.

        A server whose in-flight device op exceeded --device-stall-seconds
        serves the SAME payload with HTTP 503 and status "stalled" (the
        load-balancer signal); this method returns that payload instead of
        raising, so callers always read ``payload["status"]``. Transport
        failures and non-JSON errors still raise :class:`ServeError`."""
        try:
            return self._get_json("/healthz")
        except ServeError as e:
            if e.status == 503 and e.payload is not None:
                return e.payload
            raise

    def stats(self) -> dict:
        """GET /stats: request/batch counters + latency percentiles."""
        return self._get_json("/stats")

    def model_info(self) -> dict:
        """GET /model: the served artifact's identity (path, mtime,
        reload count, classes)."""
        return self._get_json("/model")

    def calibration(self) -> bytes:
        """GET /calibration: the int8 activation calibration the server
        is currently serving with, as ``--save-calibration`` npz bytes.

        Write them to a file and pass it as ``annonet_serve
        --calibration`` / ``annonet_infer --calibration`` to freeze the
        exact same int8 net on every replica — the export half of the
        reproducible-deployment loop when the server calibrated itself
        on live traffic. Raises :class:`ServeError` (HTTP 409) when the
        server is not int8 or nothing has been calibrated yet."""
        body, _ = self._request("GET", "/calibration")
        return body

    def reload(self, recalibrate: bool = False) -> dict:
        """POST /reload: hot-swap to the artifact currently on disk.

        The server keeps serving the old model until the new one has
        loaded and warmed; failures leave the old model serving and
        raise :class:`ServeError` (HTTP 409). ``recalibrate=True`` drops
        a stale pinned int8 calibration instead of failing on its
        fingerprint."""
        path = "/reload" + ("?recalibrate=1" if recalibrate else "")
        body, _ = self._request("POST", path, body=b"")
        return json.loads(body.decode("utf-8"))

    # ----------------------------------------------------------- inference

    def _infer_query(
        self,
        fmt: str,
        gains: Optional[ClassValues],
        detection_levels: Optional[ClassValues],
    ) -> str:
        from urllib.parse import urlencode

        params = [("format", fmt)]
        params += _class_value_params("gain", gains)
        params += _class_value_params("detection", detection_levels)
        return "/infer?" + urlencode(params)

    def _post_infer(
        self,
        image_or_bytes: Union[np.ndarray, bytes],
        fmt: str,
        gains: Optional[ClassValues],
        detection_levels: Optional[ClassValues],
    ) -> Tuple[bytes, Dict[str, str]]:
        path = self._infer_query(fmt, gains, detection_levels)
        if isinstance(image_or_bytes, (bytes, bytearray, memoryview)):
            # encoded path: PNG/JPEG bytes, decoded server-side
            return self._request(
                "POST", path, body=bytes(image_or_bytes),
                headers={"Content-Type": "application/octet-stream"},
            )
        image = np.asarray(image_or_bytes)
        if image.ndim == 2:
            image = image[:, :, None]
        if image.ndim != 3 or image.shape[2] not in (1, 3):
            raise ValueError(
                f"expected [H, W] or [H, W, 1|3] uint8 pixels, got shape "
                f"{image.shape}"
            )
        if image.dtype != np.uint8:
            raise ValueError(f"expected uint8 pixels, got {image.dtype}")
        h, w, c = image.shape
        return self._request(
            "POST", path, body=np.ascontiguousarray(image).tobytes(),
            headers={
                "Content-Type": "application/octet-stream",
                "X-Image-Shape": f"{h},{w},{c}",
            },
        )

    def infer(
        self,
        image: Union[np.ndarray, bytes],
        gains: Optional[ClassValues] = None,
        detection_levels: Optional[ClassValues] = None,
    ) -> np.ndarray:
        """Per-pixel class indices at the image's original size.

        ``image``: an ``[H, W(, C)]`` uint8 ndarray (sent zero-codec), or
        encoded PNG/JPEG bytes. ``gains`` / ``detection_levels``: per-class
        values ({index: value} or a full sequence), the CLI's -g/-d
        semantics — detection levels trigger the blob-veto pass exactly as
        in annonet_infer.cpp:187-238. Returns ``[H, W]`` uint16.
        """
        body, headers = self._post_infer(
            image, "labels", gains, detection_levels
        )
        shape = headers.get("x-label-shape", "")
        try:
            h, w = (int(v) for v in shape.split(","))
        except ValueError:
            raise ServeError(
                f"bad X-Label-Shape header: {shape!r}"
            ) from None
        labels = np.frombuffer(body, dtype="<u2")
        if labels.size != h * w:
            raise ServeError(
                f"label payload is {labels.size} px, header says {h}x{w}"
            )
        return labels.reshape(h, w).astype(np.uint16)

    def infer_png(
        self,
        image: Union[np.ndarray, bytes],
        gains: Optional[ClassValues] = None,
        detection_levels: Optional[ClassValues] = None,
    ) -> bytes:
        """The RGBA class-color mask as PNG bytes — byte-compatible with
        the batch CLI's ``<image>_result.png`` writer
        (annonet_infer_main.cpp:413-415)."""
        body, _ = self._post_infer(image, "png", gains, detection_levels)
        return body

    def class_counts(
        self,
        image: Union[np.ndarray, bytes],
        gains: Optional[ClassValues] = None,
        detection_levels: Optional[ClassValues] = None,
    ) -> Dict[str, int]:
        """Per-class pixel counts, keyed by class label."""
        body, _ = self._post_infer(image, "counts", gains, detection_levels)
        return json.loads(body.decode("utf-8"))["counts"]
