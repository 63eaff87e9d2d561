"""Sample reading: image + RGBA mask -> downscaled input + uint16 labels.

A copy of the parts of annonet_tpu/data/sample.py that annonet_infer uses
(that package's data layer imports JAX). Decoding and encoding go through
annonet_tpu_torch.native (libpng/libjpeg) where it builds, else through PIL.

Reference behavior reproduced from:
  * annonet.cpp:131-176 (read_sample: original-size recording,
    1/downscaling_factor bilinear resize, mask size validation against the
    ORIGINAL size, nearest-neighbor mask resize, errors-as-data)
  * annonet.h:49-58 (sample_type)

The reference's compile-time DLIB_DNN_PIMPL_WRAPPER_GRAYSCALE_INPUT knob
(appveyor.yml:6-23) is a runtime ``grayscale`` flag here. Input images are
kept channel-last uint8 with an explicit channel axis: (H, W, 1) or (H, W, 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from annonet_tpu_torch.data.codec import decode_rgba_label_image, labeled_points_by_class
from annonet_tpu_torch.data.dataset import ImageFilenames


@dataclasses.dataclass
class Sample:
    """A loaded (and possibly downscaled) image with optional ground truth.

    Mirrors sample_type (annonet.h:49-58). ``error`` carries failures as data
    instead of exceptions, exactly like the reference (annonet.cpp:171-173);
    consumers decide when to throw.
    """

    original_width: int = 0
    original_height: int = 0
    image_filenames: ImageFilenames = dataclasses.field(
        default_factory=lambda: ImageFilenames("")
    )
    input_image: Optional[np.ndarray] = None  # (H, W, C) uint8
    label_image: Optional[np.ndarray] = None  # (H, W) uint16
    labeled_points_by_class: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict
    )
    error: str = ""


def _scaled_dim(dim: int, scale: float) -> int:
    """New dimension after scaling, rounded like dlib::resize_image(scale)."""
    return max(1, int(round(dim * scale)))


def resize_image_bilinear(image: np.ndarray, target_w: int, target_h: int) -> np.ndarray:
    """Bilinear resize of a (H, W, C) or (H, W) uint8/float image on the host.

    Half-pixel-center sampling with edge clamping (the standard convention;
    replaces dlib::resize_image + interpolate_bilinear, annonet.cpp:153).
    Pure NumPy (or the native module) so results are identical across
    platforms.
    """
    src_h, src_w = image.shape[:2]
    if (src_h, src_w) == (target_h, target_w):
        return image.copy()

    if image.dtype == np.uint8:
        from annonet_tpu_torch.native import resize_bilinear_native

        native = resize_bilinear_native(image, target_w, target_h)
        if native is not None:
            return native

    in_dtype = image.dtype
    img = image.astype(np.float32)
    squeeze = False
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True

    scale_y = src_h / target_h
    scale_x = src_w / target_w
    # half-pixel centers
    ys = (np.arange(target_h, dtype=np.float64) + 0.5) * scale_y - 0.5
    xs = (np.arange(target_w, dtype=np.float64) + 0.5) * scale_x - 0.5
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    wy = (ys - y0).astype(np.float32)
    wx = (xs - x0).astype(np.float32)
    y0c = np.clip(y0, 0, src_h - 1)
    y1c = np.clip(y0 + 1, 0, src_h - 1)
    x0c = np.clip(x0, 0, src_w - 1)
    x1c = np.clip(x0 + 1, 0, src_w - 1)

    top = img[y0c][:, x0c] * (1 - wx)[None, :, None] + img[y0c][:, x1c] * wx[None, :, None]
    bot = img[y1c][:, x0c] * (1 - wx)[None, :, None] + img[y1c][:, x1c] * wx[None, :, None]
    out = top * (1 - wy)[:, None, None] + bot * wy[:, None, None]

    if squeeze:
        out = out[..., 0]
    if np.issubdtype(in_dtype, np.integer):
        info = np.iinfo(in_dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(in_dtype)


def nearest_indices(src_size: int, dst_size: int) -> np.ndarray:
    """Nearest-neighbor source indices for a 1-D resize (half-pixel centers)."""
    idx = np.floor(
        (np.arange(dst_size, dtype=np.float64) + 0.5) * (src_size / dst_size)
    ).astype(np.int64)
    return np.clip(idx, 0, src_size - 1)


def resize_label_image(
    label_image: np.ndarray, target_w: int, target_h: int
) -> np.ndarray:
    """Nearest-neighbor resize of a label (or RGBA-mask) image.

    Replaces resize_label_image (annonet.cpp:131-141). Works for (H, W) index
    labels and (H, W, 4) RGBA masks alike.
    """
    src_h, src_w = label_image.shape[:2]
    if (src_h, src_w) == (target_h, target_w):
        return label_image.copy()
    yi = nearest_indices(src_h, target_h)
    xi = nearest_indices(src_w, target_w)
    return label_image[np.ix_(yi, xi)]


def load_image(path: str, grayscale: bool) -> np.ndarray:
    """Load an image file as (H, W, 1) or (H, W, 3) uint8.

    Decoding runs in the native C++ module (libpng/libjpeg, GIL released;
    replaces dlib::load_image at annonet.cpp:150) with a PIL fallback. The
    grayscale conversion uses PIL's exact ITU-R 601-2 fixed-point math in
    both paths.
    """
    arr = _decode_with_fallback(path, 1 if grayscale else 3)
    if arr is None:
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("L" if grayscale else "RGB")
            arr = np.asarray(im, dtype=np.uint8)
        if grayscale:
            arr = arr[..., None]
    return arr


def _decode_with_fallback(path: str, channels: int):
    """Native decode, falling back to PIL on *decode* errors (not missing
    files): libpng/libjpeg reject some slightly malformed files that PIL
    still reads, and the native module must not make loading stricter than
    the pure-Python path."""
    from annonet_tpu_torch.native import decode_image_native

    try:
        return decode_image_native(path, channels)
    except FileNotFoundError:
        raise
    except OSError:
        return None


def load_rgba(path: str) -> np.ndarray:
    """Load a mask file as (H, W, 4) uint8 RGBA (native decode, PIL fallback)."""
    arr = _decode_with_fallback(path, 4)
    if arr is not None:
        return arr
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGBA")
        return np.asarray(im, dtype=np.uint8)


def save_png_rgba(path: str, rgba: np.ndarray) -> None:
    """Write (H, W, 4) RGBA uint8 as PNG (native encode, PIL fallback).

    Replaces dlib::save_png (annonet_infer_main.cpp:415)."""
    from annonet_tpu_torch.native import encode_png_rgba_native

    if encode_png_rgba_native(path, rgba):
        return
    from PIL import Image

    Image.fromarray(np.asarray(rgba, dtype=np.uint8), mode="RGBA").save(path)


def read_sample(
    image_filenames: ImageFilenames,
    anno_classes,
    require_ground_truth: bool,
    downscaling_factor: float,
    grayscale: bool = False,
) -> Sample:
    """Load an image (+ optional mask), downscale, validate, decode.

    Parity with read_sample (annonet.cpp:143-176):
      * original W/H recorded before downscaling
      * the input image is bilinearly resized by 1/downscaling_factor
      * the mask must match the ORIGINAL image size ("Label image size
        mismatch", annonet.cpp:158-160)
      * the mask is nearest-neighbor resized to the downscaled input size,
        then decoded RGBA -> uint16 indices
      * any exception is captured into sample.error, not raised
    """
    sample = Sample(image_filenames=image_filenames)
    try:
        sample.input_image = load_image(image_filenames.image_filename, grayscale)
        sample.original_height, sample.original_width = sample.input_image.shape[:2]
        if downscaling_factor != 1.0:
            new_w = _scaled_dim(sample.original_width, 1.0 / downscaling_factor)
            new_h = _scaled_dim(sample.original_height, 1.0 / downscaling_factor)
            sample.input_image = resize_image_bilinear(
                sample.input_image, new_w, new_h
            )

        if image_filenames.label_filename:
            rgba_label_image = load_rgba(image_filenames.label_filename)
            if (
                rgba_label_image.shape[0] != sample.original_height
                or rgba_label_image.shape[1] != sample.original_width
            ):
                sample.error = "Label image size mismatch"
            else:
                h, w = sample.input_image.shape[:2]
                rgba_label_image = resize_label_image(rgba_label_image, w, h)
                sample.label_image = decode_rgba_label_image(
                    rgba_label_image, anno_classes
                )
                sample.labeled_points_by_class = labeled_points_by_class(
                    sample.label_image
                )
        elif require_ground_truth:
            sample.error = "No ground truth available"
    except Exception as e:  # noqa: BLE001 — parity: errors are data
        sample.error = str(e)

    return sample
