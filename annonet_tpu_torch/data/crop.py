"""Random-crop sampling for training: class-then-point uniform crops.

Reference behavior reproduced from:
  * annonet_train.h:85-105 (random_rect_containing_point)
  * annonet_train_main.cpp:35-41 (make_cropping_rect_around_defect)
  * annonet_train_main.cpp:110-232 (randomly_crop_image:
    class-then-point sampling, chip extraction, outpaint + ignore outside,
    further-downscaling path)

The port's copy of ``annonet_tpu/data/crop.py`` (numpy only). The host
does only the gather — pick a class, pick a labeled point, slice a
fixed-size crop out of the cached full image (replicate-padding the image,
ignore-padding the labels at borders). Everything per-pixel and
floating-point (loss weighting, flips, brightness, noise, color offset,
uint8 normalization) runs batched on the device inside the train step
(annonet_tpu_torch.ops.augment), so the host->device transfer stays at
1 byte/pixel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from annonet_tpu_torch.classes import IGNORE_LABEL
from annonet_tpu_torch.data.sample import (
    Sample,
    resize_image_bilinear,
    resize_label_image,
)


def centered_rect(cx: int, cy: int, width: int, height: int) -> Tuple[int, int, int, int]:
    """(left, top, right, bottom) INCLUSIVE rect of the given size centered
    at (cx, cy) — dlib::centered_rect semantics (left = cx - width/2 with
    C-style truncating division)."""
    left = cx - width // 2
    top = cy - height // 2
    return (left, top, left + width - 1, top + height - 1)


def random_rect_containing_point(
    rng: np.random.Generator,
    point_xy: Tuple[int, int],
    result_width: int,
    result_height: int,
) -> Tuple[int, int, int, int]:
    """A uniformly random result_width x result_height rect containing point.

    Exact math of random_rect_containing_point (annonet_train.h:85-105):
    the rect center is drawn uniformly from the set of centers whose
    centered_rect contains the point.
    """
    x, y = int(point_xy[0]), int(point_xy[1])
    min_center_x = x - (result_width - 1) // 2
    max_center_x = x + result_width // 2
    min_center_y = y - (result_height - 1) // 2
    max_center_y = y + result_height // 2
    center_x = min_center_x + int(rng.integers(0, max_center_x - min_center_x + 1))
    center_y = min_center_y + int(rng.integers(0, max_center_y - min_center_y + 1))
    rect = centered_rect(center_x, center_y, result_width, result_height)
    assert rect[0] <= x <= rect[2] and rect[1] <= y <= rect[3]
    return rect


def extract_crop(
    input_image: np.ndarray,  # (H, W, C) uint8
    label_image: np.ndarray,  # (H, W) uint16
    rect_ltrb: Tuple[int, int, int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract a crop at ``rect_ltrb`` (inclusive, may extend outside).

    Outside the image: the input crop is replicate-padded (the combined
    effect of extract_image_chip + outpaint at annonet_train_main.cpp:160-177
    when the chip is unscaled) and the label crop is filled with
    IGNORE_LABEL (set_to_unknown_outside, annonet_train_main.cpp:149-158).
    One clamped-index gather instead of chip warp + 9-region loops.
    """
    h, w = label_image.shape
    left, top, right, bottom = rect_ltrb

    if input_image.dtype == np.uint8 and label_image.dtype == np.uint16:
        from annonet_tpu_torch.native import extract_crop_native

        native = extract_crop_native(
            input_image, label_image, top, left,
            bottom - top + 1, right - left + 1,
        )
        if native is not None:
            return native

    ys = np.arange(top, bottom + 1)
    xs = np.arange(left, right + 1)
    ys_c = np.clip(ys, 0, h - 1)
    xs_c = np.clip(xs, 0, w - 1)

    image_crop = input_image[np.ix_(ys_c, xs_c)]
    label_crop = label_image[np.ix_(ys_c, xs_c)].copy()

    outside_y = (ys < 0) | (ys >= h)
    outside_x = (xs < 0) | (xs >= w)
    if outside_y.any():
        label_crop[outside_y, :] = IGNORE_LABEL
    if outside_x.any():
        label_crop[:, outside_x] = IGNORE_LABEL
    return image_crop, label_crop


@dataclasses.dataclass
class CropOptions:
    """Runtime knobs of randomly_crop_image (annonet_train_main.cpp:110-232).

    The augmentation fields are consumed on the device
    (annonet_tpu_torch.ops.augment); they live here because this is the struct the
    CLI builds from its flags.
    """

    dim: int = 64  # actual_input_dimension (crop side)
    further_downscaling_factor: float = 1.0
    class_weight: float = 0.5
    image_weight: float = 0.5
    allow_flip_left_right: bool = False
    allow_flip_upside_down: bool = False
    multiplicative_brightness_change_probability: float = 0.0
    multiplicative_brightness_change_sigma: float = 0.1
    noise_level_stddev: float = 0.0
    allow_random_color_offset: bool = False


def sample_crop_rect(
    sample: Sample,
    options: CropOptions,
    rng: np.random.Generator,
) -> Tuple[int, int, int, int]:
    """Draw one crop DECISION (the rect only, no pixel work).

    Sampling parity with randomly_crop_image (annonet_train_main.cpp:110-232):
      1. pick a random CLASS present in the image (uniform over classes)
      2. pick a random labeled POINT of that class (uniform over its points)
      3. pick a random dim*fdf rect containing that point
    Factored out so the pipeline's batched native extraction consumes the
    exact same random stream as the per-crop path.
    """
    classes = sorted(sample.labeled_points_by_class.keys())
    if not classes:
        raise ValueError("randomly_crop_sample requires labeled points")
    class_index = classes[int(rng.integers(0, len(classes)))]
    points = sample.labeled_points_by_class[class_index]
    point = points[int(rng.integers(0, len(points)))]

    dim_before = int(round(options.dim * options.further_downscaling_factor))
    return random_rect_containing_point(
        rng, (point[0], point[1]), dim_before, dim_before
    )


def randomly_crop_sample(
    sample: Sample,
    options: CropOptions,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """One random training crop: (image uint8 [dim,dim,C], labels uint16 [dim,dim]).

    sample_crop_rect's decision, then:
      4. extract (replicate-pad image / ignore-pad labels)
      5. if further_downscaling_factor > 1: bilinear-resize the image crop and
         NN-resize the label crop down to dim x dim
    """
    rect = sample_crop_rect(sample, options, rng)
    image_crop, label_crop = extract_crop(sample.input_image, sample.label_image, rect)

    if options.further_downscaling_factor > 1.0:
        image_crop = resize_image_bilinear(image_crop, options.dim, options.dim)
        label_crop = resize_label_image(label_crop, options.dim, options.dim)

    return image_crop, label_crop
