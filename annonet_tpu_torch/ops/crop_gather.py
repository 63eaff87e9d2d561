"""Crop extraction on the device from the device image pool (the port of
``annonet_tpu/ops/crop_gather.py``).

The host ships crop decisions — (slot, y0, x0, valid_h, valid_w) per crop
— and this op turns them into exactly the crops ``data/crop.py::
extract_crop`` cuts on the host (the reference's extract_image_chip +
outpaint + set_to_unknown_outside, annonet_train_main.cpp:149-179):

  * image pixels outside the valid [0, h) x [0, w) area replicate the
    nearest edge pixel;
  * label pixels outside it become IGNORE_LABEL.

One clamped-index gather: per crop the row indices clip(y0 + i, 0, h-1)
and column indices clip(x0 + j, 0, w-1), mirrored where the crop's flip
is set (flipping an extracted crop equals extracting with mirrored
indices, the replicate clamp and the ignore region included). The TPU's
permutation matmuls are a layout trick of that chip; plain indexing is
exact here.
"""

from __future__ import annotations

from typing import Optional

import torch

from annonet_tpu_torch.classes import IGNORE_LABEL


def gather_crops(
    pool_images: torch.Tensor,  # [S, Hp, Wp, C] uint8
    pool_labels: torch.Tensor,  # [S, Hp, Wp] int32 (IGNORE_LABEL = 65535)
    slot: torch.Tensor,  # [B] int — pool slot per crop
    y0: torch.Tensor,  # [B] int — crop top (may be negative / out of bounds)
    x0: torch.Tensor,  # [B] int — crop left
    valid_h: torch.Tensor,  # [B] int — the slot image's real height
    valid_w: torch.Tensor,  # [B] int — the slot image's real width
    dim: int,
    flip_lr: Optional[torch.Tensor] = None,  # [B] bool — mirror crop columns
    flip_ud: Optional[torch.Tensor] = None,  # [B] bool — mirror crop rows
):
    """B [dim, dim] crops: (images uint8 [B,dim,dim,C], labels int32
    [B,dim,dim] with IGNORE_LABEL outside the valid area)."""
    device = pool_images.device
    slot, y0, x0, valid_h, valid_w = (
        t.to(device=device, dtype=torch.int64) for t in (slot, y0, x0, valid_h, valid_w)
    )
    iota = torch.arange(dim, device=device)
    ridx = iota.expand(slot.shape[0], dim)
    cidx = ridx
    if flip_ud is not None:
        ridx = torch.where(flip_ud.to(device)[:, None], dim - 1 - iota, iota)
    if flip_lr is not None:
        cidx = torch.where(flip_lr.to(device)[:, None], dim - 1 - iota, iota)
    ys = y0[:, None] + ridx  # [B, dim] source rows before the clamp
    xs = x0[:, None] + cidx
    rows = torch.minimum(ys.clamp(min=0), valid_h[:, None] - 1)
    cols = torch.minimum(xs.clamp(min=0), valid_w[:, None] - 1)
    s = slot[:, None, None]
    images = pool_images[s, rows[:, :, None], cols[:, None, :]]
    labels = pool_labels[s, rows[:, :, None], cols[:, None, :]].to(torch.int32)
    inside = (
        ((ys >= 0) & (ys < valid_h[:, None]))[:, :, None]
        & ((xs >= 0) & (xs < valid_w[:, None]))[:, None, :]
    )
    return images, torch.where(inside, labels, IGNORE_LABEL)


def gather_crops_packed(
    pool_images, pool_labels, packed, dim: int, flip_lr=None, flip_ud=None,
):
    """gather_crops with the decisions as one [5, B] int32 array, rows
    (slot, y0, x0, valid_h, valid_w)."""
    return gather_crops(
        pool_images, pool_labels,
        packed[0], packed[1], packed[2], packed[3], packed[4], dim,
        flip_lr=flip_lr, flip_ud=flip_ud,
    )
