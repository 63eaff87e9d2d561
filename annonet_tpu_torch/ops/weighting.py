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
device. On CPU tensors it runs ``batched_label_weights_plain``, eager f32
operations. On CUDA tensors it runs the hand-written op of
``csrc/label_weights.cu`` (two launches: the counts and the [N, K] weight
table, then every pixel's weight), or raises: nothing falls back from a
CUDA tensor to the plain version. The op's labels are int32 and
contiguous, at most ``_MAX_CLASSES`` classes; a negative label weighs 0
there (the plain version's scatter fails on it).

The op counts in integers and computes the table with the plain version's
f32 roundings on the card (its source note lists them), so its weights
are the plain version's bit for bit below 2^24 pixels a crop and 128
classes, as PyTorch 2.11 computes them (the op follows that version's
pow and reduction kernels; a torch upgrade has to pass the card's
bit-equality tests again). From 128 classes torch's CUDA sum of the K products runs in an
order the op does not follow: each weight is then within (2K + 2) * 2**-24
of the plain version's, relatively (two orders of a sum of K positive
terms, then a quotient and a product).

Counters: ``batched_label_weights.calls`` (calls on the card),
``batched_label_weights.launches`` (kernel launches, 2 a call).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from annonet_tpu_torch.classes import IGNORE_LABEL
from annonet_tpu_torch.ops import _build

# csrc/label_weights.cu kMaxClasses: the shared memory of a block's bins
# and weights
_MAX_CLASSES = 8192
# per (device, stream): the op's int32 workspace for C = the largest N * K
# so far, zeroed and left with its ticket and counts zero by each call: the
# ticket (16 bytes), then C counts, then C f32 table entries (apart, so that
# no call's table lands where a later call counts). A stream's launches run
# in order, so they share it.
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


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


def batched_label_weights_plain(
    labels: torch.Tensor,
    class_weight: float,
    image_weight: float,
    class_count: int,
) -> torch.Tensor:
    """Batched ``set_weights`` in eager operations: [N,H,W] integer labels
    -> [N,H,W] float32, f32 arithmetic. Labels equal to IGNORE_LABEL count
    nothing and get weight 0."""
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


def _workspace(labels: torch.Tensor, cells: int):
    """The pointers of the ticket, the counts and the table in the
    workspace of ``labels``' device and current stream (at least ``cells``
    counts and table entries), and the stream."""
    index = labels.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    work = _SCRATCH.get((index, stream))
    if work is None or work.numel() < 4 + 2 * cells:
        work = torch.zeros(4 + 2 * cells, dtype=torch.int32, device=labels.device)
        _SCRATCH[(index, stream)] = work
    capacity = (work.numel() - 4) // 2
    base = work.data_ptr()
    return base, base + 16, base + 16 + 4 * capacity, stream


def _check(labels: torch.Tensor, class_count: int) -> None:
    if labels.dim() != 3:
        raise ValueError(f"batched_label_weights: expected labels [N,H,W], got "
                         f"{tuple(labels.shape)}")
    if labels.device.type not in ("cpu", "cuda"):
        raise ValueError(f"batched_label_weights: unsupported device {labels.device}")
    if labels.device.type == "cuda":
        if labels.dtype != torch.int32 or not labels.is_contiguous():
            raise ValueError("batched_label_weights: labels on the card must be contiguous "
                             f"int32, got {labels.dtype} with strides {labels.stride()}")
        if not 1 <= class_count <= _MAX_CLASSES:
            raise ValueError(f"batched_label_weights: {class_count} classes; the op takes "
                             f"1 to {_MAX_CLASSES}")


def batched_label_weights(
    labels: torch.Tensor,
    class_weight: float,
    image_weight: float,
    class_count: int,
) -> torch.Tensor:
    """Batched ``set_weights``: [N,H,W] integer labels -> [N,H,W] float32
    on the labels' device, f32 arithmetic; the plain version on the CPU,
    the op on the card."""
    _check(labels, class_count)
    if labels.device.type == "cpu":
        return batched_label_weights_plain(labels, class_weight, image_weight, class_count)
    n, h, w = labels.shape
    out = torch.empty(labels.shape, dtype=torch.float32, device=labels.device)
    if out.numel() == 0:
        return out
    ticket, counts, table, stream = _workspace(labels, n * class_count)
    code = _build.lib().annonet_label_weights(
        labels.data_ptr(), out.data_ptr(), ticket, counts, table, n, h * w, class_count,
        -float(class_weight), float(image_weight),
        int(labels.data_ptr() % 16 == out.data_ptr() % 16), labels.device.index, stream)
    _build.check(code, "annonet_label_weights")
    batched_label_weights.calls += 1
    batched_label_weights.launches += 2
    return out


batched_label_weights.calls = 0
batched_label_weights.launches = 0
