"""Per-pixel loss weighting: class/image balance interpolation (the port
of ``annonet_tpu/ops/weighting.py``; the reference's set_weights,
annonet_train.h:20-83).

  * per-crop class histogram over non-ignored pixels
  * per-class weight ``count ** -class_weight`` (the reference's
    (average_count / count) ** class_weight without the constant factor,
    which the normalisation cancels)
  * normalised so the total weight equals
    ``total_count * (nr*nc / total_count) ** image_weight``
  * ignored pixels get weight 0

``set_weights`` is numpy, one crop (a copy of the JAX package's);
``batched_label_weights`` does a whole [N,H,W] batch on the labels'
device.
"""

from __future__ import annotations

import numpy as np
import torch

from annonet_tpu_torch.classes import IGNORE_LABEL


def set_weights(
    unweighted_label_image: np.ndarray,
    class_weight: float,
    image_weight: float,
) -> np.ndarray:
    """The float32 weight image of one uint16 label crop."""
    labels = np.asarray(unweighted_label_image)
    nr, nc = labels.shape
    valid = labels != IGNORE_LABEL
    vals = labels[valid].astype(np.int64)
    total_count = vals.size

    out = np.zeros((nr, nc), dtype=np.float32)
    if total_count == 0:
        return out

    counts = np.bincount(vals)
    present = counts > 0
    unnormalized = np.zeros(counts.shape, dtype=np.float64)
    unnormalized[present] = counts[present].astype(np.float64) ** (-class_weight)
    total_unnormalized = float((counts * unnormalized).sum())

    target_total = total_count * (nr * nc / total_count) ** image_weight
    label_weights = unnormalized * (target_total / total_unnormalized)

    out[valid] = label_weights[vals].astype(np.float32)
    return out


def batched_label_weights(
    labels: torch.Tensor,
    class_weight: float,
    image_weight: float,
    class_count: int,
) -> torch.Tensor:
    """Batched ``set_weights``: [N,H,W] integer labels -> [N,H,W] float32,
    f32 arithmetic. Labels equal to IGNORE_LABEL count nothing and get
    weight 0."""
    n, h, w = labels.shape
    # labels >= class_count count nowhere and weigh 0, as in the JAX one-hot
    valid = (labels != IGNORE_LABEL) & (labels < class_count)
    safe = torch.where(valid, labels, 0).to(torch.int64).reshape(n, h * w)

    # [N, K] histogram of the valid pixels
    counts = torch.zeros((n, class_count), dtype=torch.float32, device=labels.device)
    counts.scatter_add_(1, safe, valid.reshape(n, h * w).to(torch.float32))
    total = counts.sum(dim=-1, keepdim=True)  # [N, 1]

    present = counts > 0
    # counts ** -cw on an absent class would be inf: guard before the power
    unnormalized = torch.where(
        present, torch.clamp(counts, min=1.0) ** (-class_weight), 0.0
    )
    total_unnormalized = (counts * unnormalized).sum(dim=-1, keepdim=True)

    pixels = float(h * w)
    safe_total = torch.clamp(total, min=1.0)
    target_total = total * (pixels / safe_total) ** image_weight
    scale = torch.where(
        total_unnormalized > 0, target_total / total_unnormalized, 0.0
    )
    label_weights = unnormalized * scale  # [N, K]

    per_pixel = torch.gather(label_weights, 1, safe).reshape(n, h, w)
    return torch.where(valid, per_pixel, 0.0)
