"""Loader for the repository's native host module (``native/*.cpp``).

The port's own ctypes loader for the C++ sources at the repository root
(``native/annonet_native.cpp`` and ``native/annonet_image_io.cpp``, shared
with the JAX package as source files, not as a Python module). On first use
it compiles them with g++ into ``annonet_tpu_torch/_build/native_<hash>/``
(git-ignored; the name carries a hash of the sources), without the image
codecs when libpng or libjpeg is missing, and binds the four entry points
the port calls. Every caller keeps a pure-numpy (or PIL) fallback, so a
missing compiler costs speed, not function; ``ANNONET_TPU_NO_NATIVE=1``
forces the fallbacks, as it does for the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "native")
_SOURCE = os.path.join(_NATIVE_DIR, "annonet_native.cpp")
_IMAGE_IO_SOURCE = os.path.join(_NATIVE_DIR, "annonet_image_io.cpp")
BUILD_ROOT = os.path.join(_PACKAGE_DIR, "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    if not os.path.isfile(_SOURCE):
        return None
    sources = [_SOURCE] + ([_IMAGE_IO_SOURCE] if os.path.isfile(_IMAGE_IO_SOURCE) else [])
    digest = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    build_dir = os.path.join(BUILD_ROOT, f"native_{digest.hexdigest()[:16]}")
    so_path = os.path.join(build_dir, "libannonet_native.so")
    if not os.path.isfile(so_path):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so_path}.build.{os.getpid()}"
        base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp]
        attempts = [base + [_SOURCE]]  # without image I/O
        if len(sources) == 2:
            attempts.insert(0, base + sources + ["-lpng", "-ljpeg"])
        for cmd in attempts:
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            except (subprocess.SubprocessError, OSError):
                continue
            os.replace(tmp, so_path)
            break
        else:
            print("annonet_tpu_torch: native build failed; using Python fallbacks",
                  file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None

    lib.annonet_label_connected_blobs.restype = ctypes.c_int32
    lib.annonet_label_connected_blobs.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.annonet_resize_bilinear_u8.restype = None
    lib.annonet_resize_bilinear_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ]
    if hasattr(lib, "annonet_decode_image"):
        lib.annonet_decode_image.restype = ctypes.c_int32
        lib.annonet_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.annonet_free_buffer.restype = None
        lib.annonet_free_buffer.argtypes = [ctypes.c_void_p]
        lib.annonet_encode_png_rgba.restype = ctypes.c_int32
        lib.annonet_encode_png_rgba.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable or disabled."""
    global _lib, _load_failed
    if os.environ.get("ANNONET_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None and not _load_failed:
            _lib = _build_and_load()
            _load_failed = _lib is None
    return _lib


def label_connected_blobs_native(
    labels: np.ndarray, zero_is_background: bool, ignore_is_background: bool
) -> Optional[Tuple[np.ndarray, int]]:
    """8-connected blob labelling of a uint16 label map; None when the
    native module is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, dtype=np.uint16)
    h, w = labels.shape
    out = np.empty((h, w), dtype=np.int32)
    count = lib.annonet_label_connected_blobs(
        labels.ctypes.data, h, w, int(zero_is_background),
        int(ignore_is_background), out.ctypes.data,
    )
    return out, int(count)


def resize_bilinear_native(
    image: np.ndarray, target_w: int, target_h: int
) -> Optional[np.ndarray]:
    """Bilinear uint8 resize of (H, W) or (H, W, C); None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    image = np.ascontiguousarray(image, dtype=np.uint8)
    squeeze = image.ndim == 2
    if squeeze:
        image = image[..., None]
    h, w, ch = image.shape
    out = np.empty((target_h, target_w, ch), dtype=np.uint8)
    lib.annonet_resize_bilinear_u8(
        image.ctypes.data, h, w, ch, out.ctypes.data, target_h, target_w
    )
    return out[..., 0] if squeeze else out


def decode_image_native(path: str, channels: int) -> Optional[np.ndarray]:
    """PNG/JPEG decode to (H, W, channels) uint8; None when the image-I/O
    part is unavailable. Raises FileNotFoundError for a missing file and
    OSError when decoding fails."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "annonet_decode_image"):
        return None
    data = ctypes.c_void_p()
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    rc = lib.annonet_decode_image(
        path.encode("utf-8"), channels,
        ctypes.byref(data), ctypes.byref(h), ctypes.byref(w),
    )
    if rc == 1:
        raise FileNotFoundError(f"cannot open image file: {path}")
    if rc != 0:
        raise OSError(f"cannot decode image file (code {rc}): {path}")
    try:
        n = h.value * w.value * channels
        buf = (ctypes.c_uint8 * n).from_address(data.value)
        arr = np.frombuffer(buf, dtype=np.uint8).reshape(
            h.value, w.value, channels
        ).copy()
    finally:
        lib.annonet_free_buffer(data)
    return arr


def encode_png_rgba_native(path: str, rgba: np.ndarray) -> bool:
    """RGBA PNG encode; False when unavailable. Raises on failure."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "annonet_encode_png_rgba"):
        return False
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError("expected (H, W, 4) RGBA data")
    rc = lib.annonet_encode_png_rgba(
        path.encode("utf-8"), rgba.ctypes.data, rgba.shape[0], rgba.shape[1]
    )
    if rc != 0:
        raise OSError(f"cannot write PNG (code {rc}): {path}")
    return True
