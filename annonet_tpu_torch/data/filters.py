"""Sample-level label filters applied after loading, before cropping (the
port's copy of ``annonet_tpu/data/filters.py``).

Reference behavior reproduced from:
  * ignore_classes_to_ignore (annonet_train_main.cpp:422-432): --ignore-class
    N re-labels all points of class N to IGNORE and drops them from
    labeled_points_by_class
  * ignore_large_nonzero_regions (annonet_train_main.cpp:434-502):
    re-labels as IGNORE any connected non-background blob whose point count /
    width / height exceeds a multiple of the receptive-field size; blob 0
    (background) is always kept
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np

from annonet_tpu_torch.classes import IGNORE_LABEL
from annonet_tpu_torch.data.codec import labeled_points_by_class
from annonet_tpu_torch.data.sample import Sample
from annonet_tpu_torch.ops.blobs import label_connected_blobs


def ignore_classes(sample: Sample, classes_to_ignore: Iterable[int]) -> None:
    """Re-label all points of the given classes to IGNORE, in place."""
    if sample.label_image is None:
        return
    for class_to_ignore in classes_to_ignore:
        points = sample.labeled_points_by_class.pop(int(class_to_ignore), None)
        if points is not None:
            sample.label_image[points[:, 1], points[:, 0]] = IGNORE_LABEL


def ignore_large_nonzero_regions(
    sample: Sample,
    receptive_field_side: int,
    by_area: float = math.inf,
    by_width: float = math.inf,
    by_height: float = math.inf,
) -> None:
    """Ignore oversized non-background blobs, in place.

    Thresholds are multiples of the receptive field
    (annonet_train_main.cpp:439-445): a blob is ignored when its labeled
    point count exceeds by_area * rf^2, or its bounding-box width/height
    exceeds by_width * rf / by_height * rf. Background (blob 0) always stays.
    """
    if sample.label_image is None or not sample.labeled_points_by_class:
        return
    classes = sample.labeled_points_by_class
    if len(classes) == 1 and 0 in classes:
        return  # background only (annonet_train_main.cpp:439-441)

    rf = receptive_field_side
    max_points = by_area * rf * rf
    max_width = by_width * rf
    max_height = by_height * rf
    h, w = sample.label_image.shape
    if max_points >= h * w and max_width >= w and max_height >= h:
        return  # would keep everything (annonet_train_main.cpp:446-448)

    blobs, _count = label_connected_blobs(
        sample.label_image, zero_is_background=True, ignore_is_background=True
    )

    for class_index in list(classes.keys()):
        points = classes[class_index]
        blob_ids = blobs[points[:, 1], points[:, 0]]
        drop = np.zeros(len(points), dtype=bool)
        for blob in np.unique(blob_ids):
            if blob == 0:
                continue  # background blob is always kept
            in_blob = blob_ids == blob
            blob_pts = points[in_blob]
            count = int(in_blob.sum())
            width = int(blob_pts[:, 0].max() - blob_pts[:, 0].min() + 1)
            height = int(blob_pts[:, 1].max() - blob_pts[:, 1].min() + 1)
            if count > max_points or width > max_width or height > max_height:
                drop |= in_blob
        if drop.any():
            dropped = points[drop]
            sample.label_image[dropped[:, 1], dropped[:, 0]] = IGNORE_LABEL

    # rebuild the point index from the modified label image
    sample.labeled_points_by_class = labeled_points_by_class(sample.label_image)
