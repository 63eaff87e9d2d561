"""Weighted per-pixel multiclass log loss (the port of
``annonet_tpu/ops/loss.py``): per-pixel softmax cross-entropy, each pixel
scaled by its weight, ignored pixels counting 0, the sum divided by all
N*H*W pixels of the minibatch, ignored ones included (dlib's 1/(N*H*W)).
"""

from __future__ import annotations

import torch

from annonet_tpu_torch.classes import IGNORE_LABEL


def weighted_pixel_cross_entropy(
    logits: torch.Tensor,  # [N, H, W, K] float
    labels: torch.Tensor,  # [N, H, W] integer (IGNORE_LABEL allowed)
    weights: torch.Tensor,  # [N, H, W] float32
) -> torch.Tensor:
    """Scalar loss = mean over all pixels of weight * CE(softmax(logits), label)."""
    n, h, w, k = logits.shape
    # a label >= K (not a class of the net) selects no logit: CE 0, as the
    # JAX package's one-hot select gives
    valid = (labels != IGNORE_LABEL) & (labels < k)
    safe = torch.where(valid, labels, 0).to(torch.int64)
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ce = -torch.gather(log_probs, -1, safe[..., None])[..., 0]
    ce = torch.where(valid, ce, 0.0)
    return torch.sum(ce * weights) / (n * h * w)
