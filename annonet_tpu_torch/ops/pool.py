"""The U-Net's 2x2 max pool, on channels_last activations.

``max_pool2x2(x)``: [N, C, H, W] (any memory layout; the training and
inference nets hand it NCHW views of channels_last tensors) -> [N, C, H/2,
W/2] in ``x``'s dtype and memory layout, each output the largest of its 2x2
window. It is ``F.max_pool2d``: PyTorch's NHWC pooling kernels on the card,
forward and backward, which read each input once and write each output once
(a bandwidth-bound pass that no hand-written kernel of the port replaces;
the JAX package has no pooling layer).

Counter: ``max_pool2x2.calls`` (forward calls on the card), kept like
``bn_relu.units``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """The 2x2 stride-2 max pool of [N, C, H, W] ``x``; H and W even."""
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"max_pool2x2: expected [N,C,H,W] with even H and W, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cuda":
        max_pool2x2.calls += 1
    return F.max_pool2d(x, 2)


max_pool2x2.calls = 0
